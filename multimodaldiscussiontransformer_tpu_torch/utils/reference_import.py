"""The upstream reference's (FairSeq mDT) state dicts <-> the port's, with the
surface of the JAX package's ``utils/reference_import.py``.

The reference ``GraphormerModel``
(mDT/src/models/multi_modal_discussion_transformer.py) holds
``encoder.graph_encoder.{text_model, vit_model, fusion_layers.i.
fusion_layers.j.{bert_encoder, vit_encoder}, layers.i.layers.j, ...}``. Both
sides are torch modules, so every tensor keeps its layout and the mapping is
a table of names (``reference_key_pairs``), read one way by the import and
the other by the export.

The import also applies the reference's state-dict upgrades:
- the legacy fused ``in_proj_weight`` / ``in_proj_bias`` split into q/k/v
  projections (multihead_attention.py:219-248);
- the vestigial parameters (embed_out and lm_output_learned_bias, stripped
  at multi_modal_discussion_transformer.py:282-287; masked_lm_pooler,
  lm_head_transform_weight, the fusion projections, the atom and edge
  encoders, the dead graph stack) have no destination and are dropped.

The import takes a raw FairSeq checkpoint dict (its ``"model"``) or a plain
state dict, of tensors or numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig
from multimodaldiscussiontransformer_tpu_torch.utils import hf_import as hfi
from multimodaldiscussiontransformer_tpu_torch.utils.scan_params import (
    _stack_sizes,
    scanned_state_dict,
    state_dict_layout,
    unrolled_state_dict,
)

GRAPH_LAYER = tuple((m, m) for m in (
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj",
    "self_attn_layer_norm", "fc1", "fc2", "final_layer_norm",
))


def upgrade_legacy_qkv(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Split each legacy fused ``in_proj_weight`` / ``in_proj_bias`` into
    q/k/v projections (multihead_attention.py:219-248); other entries pass
    through."""
    out = dict(sd)
    for key in list(out):
        if key.endswith("in_proj_weight"):
            prefix = key[: -len("in_proj_weight")]
            w = hfi.tensor(out.pop(key))
            dim = w.shape[0] // 3
            for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
                out[f"{prefix}{name}.weight"] = w[i * dim:(i + 1) * dim].clone()
            bkey = prefix + "in_proj_bias"
            if bkey in out:
                b = hfi.tensor(out.pop(bkey))
                for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
                    out[f"{prefix}{name}.bias"] = b[i * dim:(i + 1) * dim].clone()
    return out


def _pairs(ref: str, port: str, table) -> List[Tuple[str, str]]:
    """(reference, port) names of the weight and bias of each module pair
    (an empty ``port`` prefix: the port's top level)."""
    base = f"{port}." if port else ""
    return [(f"{ref}.{a}.{leaf}", f"{base}{b}.{leaf}") for a, b in table for leaf in ("weight", "bias")]


def reference_key_pairs(cfg: ModelConfig, port_keys, prefix: str = "encoder.") -> List[Tuple[str, str]]:
    """Every (reference key, port key) pair for a model of ``cfg`` whose
    (unrolled) state_dict has ``port_keys``. A pair whose port key the
    model lacks (a bias-free layer, the dead graph stack, an absent
    ``emb_layer_norm``) is left out."""
    ge, pe = f"{prefix}graph_encoder", "graph_encoder"
    pairs = _pairs(f"{ge}.text_model.embeddings", f"{pe}.text_model.embeddings", hfi.BERT_EMBEDDINGS)
    for i in range(cfg.num_bottom_text_layers):
        pairs += _pairs(f"{ge}.text_model.encoder.layer.{i}", f"{pe}.text_model.layer_{i}", hfi.BERT_LAYER)
    if cfg.use_image_tower:
        v = f"{ge}.vit_model.embeddings"
        pairs += _pairs(v, f"{pe}.vit_model.embeddings", (("patch_embeddings.projection", "patch_embeddings"),))
        pairs += [(f"{v}.{n}", f"{pe}.vit_model.embeddings.{n}") for n in ("cls_token", "position_embeddings")]
        for i in range(cfg.num_bottom_image_layers):
            pairs += _pairs(f"{ge}.vit_model.encoder.layer.{i}", f"{pe}.vit_model.layer_{i}", hfi.VIT_LAYER)
        pairs += _pairs(f"{ge}.vit_model", f"{pe}.vit_model", (("layernorm", "layernorm"),))
    for i, size in enumerate(_stack_sizes(cfg.num_fusion_layers + 1, cfg.num_fusion_stack)):
        for j in range(size):
            ref, port = f"{ge}.fusion_layers.{i}.fusion_layers.{j}", f"{pe}.fusion_stack_{i}.fusion_{j}"
            pairs += _pairs(f"{ref}.bert_encoder", f"{port}.bert_encoder", hfi.BERT_LAYER)
            if cfg.use_image_tower:
                pairs += _pairs(f"{ref}.vit_encoder", f"{port}.vit_encoder", hfi.VIT_LAYER)
    for i in range(cfg.num_graph_stacks):
        for j in range(cfg.num_graph_stack):
            pairs += _pairs(f"{ge}.layers.{i}.layers.{j}", f"{pe}.graph_stack_{i}.layer_{j}", GRAPH_LAYER)
    pairs += [(f"{ge}.{a}.weight", f"{pe}.{a}") for a in (
        "graph_node_feature.in_degree_encoder", "graph_node_feature.out_degree_encoder",
        "graph_node_feature.graph_token", "graph_attn_bias.spatial_pos_encoder",
        "graph_attn_bias.graph_token_virtual_distance", "bottle_neck",
    )]
    pairs += _pairs(ge, pe, (("emb_layer_norm", "emb_layer_norm"),))
    pairs += _pairs(ge, "", (("text_pooler.dense", "text_pooler.dense"), ("node_classifier", "node_classifier")))
    if cfg.use_image_tower:
        pairs += _pairs(ge, "", (("vit_pooler.dense", "vit_pooler.dense"),))
    port_keys = set(port_keys)
    return [(r, p) for r, p in pairs if p in port_keys]


def import_reference_checkpoint(
    state_dict: Mapping[str, torch.Tensor],
    cfg: ModelConfig,
    checkpoint: Mapping[str, Any],
    prefix: str = "encoder.",
) -> Dict[str, torch.Tensor]:
    """A copy of the port's ``state_dict`` with every tensor the reference
    checkpoint maps to taken from it (each in the target's dtype). Either
    param layout: a scan-layout state_dict is unrolled for the mapping and
    restacked. The towers' poolers (``vit_pooler``) and ``emb_layer_norm``
    are taken where the checkpoint has them; every other mapped tensor must
    be there."""
    sd = checkpoint.get("model", checkpoint) if isinstance(checkpoint, Mapping) else checkpoint
    sd = upgrade_legacy_qkv(sd)
    scanned = state_dict_layout(state_dict) == "scanned"
    out = unrolled_state_dict(state_dict, cfg)
    optional = (f"{prefix}graph_encoder.emb_layer_norm.", f"{prefix}graph_encoder.vit_pooler.")
    new = {}
    for ref, port in reference_key_pairs(cfg, out, prefix):
        if ref in sd:
            new[port] = hfi.tensor(sd[ref])
        elif not ref.startswith(optional):
            raise KeyError(f"the reference checkpoint lacks {ref}")
    hfi.put(out, new)
    return scanned_state_dict(out, cfg) if scanned else out


def export_reference_state_dict(
    state_dict: Mapping[str, torch.Tensor], cfg: ModelConfig, prefix: str = "encoder."
) -> Dict[str, np.ndarray]:
    """The inverse: the port's state_dict (either layout) -> a
    reference-named state dict of numpy arrays (bf16 params as float32,
    exactly), for round trips and for carrying trained weights back to the
    PyTorch reference."""
    sd = unrolled_state_dict(state_dict, cfg)

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {ref: host(sd[port]) for ref, port in reference_key_pairs(cfg, sd, prefix)}
