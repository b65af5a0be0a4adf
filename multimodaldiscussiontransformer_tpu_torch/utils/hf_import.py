"""HF tower weights into the port: HF BERT, ViT, RoBERTa and CLIP-ViT state
dicts -> the port's state_dict, with the surface of the JAX package's
``utils/hf_import.py``.

The reference builds its towers by loading
``AutoModelForSequenceClassification('bert-base-uncased')`` and
``AutoModel('google/vit-base-patch16-224')`` and splitting the top
``num_fusion_layers + 1`` encoder layers off into the fusion stacks
(mDT/src/modules/multigraphormer_graph_encoder.py:233-278). ``import_towers``
does the same on state dicts: the bottom layers feed ``text_model`` /
``vit_model``, the top layers feed the fusion stacks in order, and the
pooler and classifier feed the output head.

HF's modules and the port's are both torch modules, so a tensor keeps its
layout (``nn.Linear`` (out, in), ``nn.Conv2d`` OIHW): the mapping renames.
The one reshape is CLIP's, whose class embedding (D,) and position table
(P, D) become the port's (1, 1, D) ``cls_token`` and (1, P, D)
``position_embeddings``. The per-layer mappers return the port's names
relative to the layer (``attention.query.weight``, ...). The reference's
vestigial parameters (masked_lm_pooler, lm_head_transform_weight,
embed_out, lm_output_learned_bias, the fusion projections) have no
destination.

Inputs are plain dicts of numpy arrays or tensors; no ``transformers`` is
needed but by ``state_dicts_from_pretrained``, which downloads (or reads the
local HF cache).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig
from multimodaldiscussiontransformer_tpu_torch.utils.scan_params import (
    _stack_sizes,
    scanned_state_dict,
    state_dict_layout,
    unrolled_state_dict,
)

# (HF suffix, port suffix) of one layer's linear and layer-norm modules
BERT_LAYER = (
    ("attention.self.query", "attention.query"),
    ("attention.self.key", "attention.key"),
    ("attention.self.value", "attention.value"),
    ("attention.output.dense", "attention_output_dense"),
    ("attention.output.LayerNorm", "attention_output_layernorm"),
    ("intermediate.dense", "intermediate_dense"),
    ("output.dense", "output_dense"),
    ("output.LayerNorm", "output_layernorm"),
)
VIT_LAYER = (
    ("layernorm_before", "layernorm_before"),
    ("attention.attention.query", "attention.query"),
    ("attention.attention.key", "attention.key"),
    ("attention.attention.value", "attention.value"),
    ("attention.output.dense", "attention_output_dense"),
    ("layernorm_after", "layernorm_after"),
    ("intermediate.dense", "intermediate_dense"),
    ("output.dense", "output_dense"),
)
CLIP_LAYER = (
    ("layer_norm1", "layernorm_before"),
    ("self_attn.q_proj", "attention.query"),
    ("self_attn.k_proj", "attention.key"),
    ("self_attn.v_proj", "attention.value"),
    ("self_attn.out_proj", "attention_output_dense"),
    ("layer_norm2", "layernorm_after"),
    ("mlp.fc1", "intermediate_dense"),
    ("mlp.fc2", "output_dense"),
)
BERT_EMBEDDINGS = (
    ("word_embeddings", "word_embeddings"),
    ("position_embeddings", "position_embeddings"),
    ("token_type_embeddings", "token_type_embeddings"),
    ("LayerNorm", "layernorm"),
)


def tensor(x) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a CPU tensor of its own dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.array(x))


def _modules(sd: Mapping[str, Any], prefix: str, pairs: Sequence[Tuple[str, str]]) -> Dict[str, torch.Tensor]:
    """``{port}.weight`` / ``{port}.bias`` from ``{prefix}.{hf}.weight`` /
    ``.bias`` (``{hf}...`` for an empty prefix) for each (hf, port) pair; a
    missing bias is skipped."""
    base = f"{prefix}." if prefix else ""
    out = {}
    for src, dst in pairs:
        out[f"{dst}.weight"] = tensor(sd[f"{base}{src}.weight"])
        if f"{base}{src}.bias" in sd:
            out[f"{dst}.bias"] = tensor(sd[f"{base}{src}.bias"])
    return out


def _under(prefix: str, tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in tree.items()}


def bert_layer_params(sd: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """One HF ``BertLayer`` -> the port's ``models.bert.BertLayer``."""
    return _modules(sd, prefix, BERT_LAYER)


def vit_layer_params(sd: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """One HF ``ViTLayer`` -> the port's ``models.vit.ViTLayer``."""
    return _modules(sd, prefix, VIT_LAYER)


def bert_embeddings_params(sd: Mapping[str, Any], prefix: str = "bert.embeddings") -> Dict[str, torch.Tensor]:
    return _modules(sd, prefix, BERT_EMBEDDINGS)


def vit_embeddings_params(sd: Mapping[str, Any], prefix: str = "vit.embeddings") -> Dict[str, torch.Tensor]:
    return {
        **_modules(sd, prefix, (("patch_embeddings.projection", "patch_embeddings"),)),
        "cls_token": tensor(sd[f"{prefix}.cls_token"]),
        "position_embeddings": tensor(sd[f"{prefix}.position_embeddings"]),
    }


def roberta_embeddings_params(sd: Mapping[str, Any], prefix: str = "roberta.embeddings") -> Dict[str, torch.Tensor]:
    """RoBERTa's embeddings have BERT's structure (a one-row token-type
    table); the position-id offset is the tower config's
    (``core.config.roberta_tower_config``)."""
    return bert_embeddings_params(sd, prefix)


def clip_vit_embeddings_params(sd: Mapping[str, Any], prefix: str = "vision_model.embeddings") -> Dict[str, torch.Tensor]:
    """HF ``CLIPVisionEmbeddings`` -> the port's ``ViTEmbeddings`` (no patch
    bias)."""
    conv = tensor(sd[f"{prefix}.patch_embedding.weight"])
    d = conv.shape[0]
    return {
        "patch_embeddings.weight": conv,
        "cls_token": tensor(sd[f"{prefix}.class_embedding"]).reshape(1, 1, d),
        "position_embeddings": tensor(sd[f"{prefix}.position_embedding.weight"])[None],
    }


def clip_vit_layer_params(sd: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """HF ``CLIPEncoderLayer`` -> the port's ``ViTLayer``."""
    return _modules(sd, prefix, CLIP_LAYER)


def clip_vit_tower_params(sd: Mapping[str, Any], num_layers: int, prefix: str = "vision_model") -> Dict[str, torch.Tensor]:
    """The bottom CLIP vision tower with its ``pre_layrnorm``; CLIP's
    ``post_layernorm`` becomes the tower's final layer norm, as ViT's does."""
    out = _under("embeddings", clip_vit_embeddings_params(sd, f"{prefix}.embeddings"))
    out.update(_under("embeddings", _modules(sd, prefix, (("pre_layrnorm", "pre_layernorm"),))))
    for i in range(num_layers):
        out.update(_under(f"layer_{i}", clip_vit_layer_params(sd, f"{prefix}.encoder.layers.{i}")))
    out.update(_modules(sd, prefix, (("post_layernorm", "layernorm"),)))
    return out


def put(state_dict: Dict[str, torch.Tensor], updates: Mapping[str, torch.Tensor]) -> None:
    """Write ``updates`` into ``state_dict`` in place, each in its target's
    dtype; raise for a name the state_dict lacks or a shape it disagrees
    with."""
    unknown = sorted(set(updates) - set(state_dict))
    if unknown:
        raise KeyError(f"no such tensors in the model: {unknown[:5]}")
    for key, value in updates.items():
        target = state_dict[key]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)}, the model's is {tuple(target.shape)}")
        state_dict[key] = value.to(target.dtype)


def import_towers(
    state_dict: Mapping[str, torch.Tensor],
    cfg: ModelConfig,
    bert_sd: Mapping[str, Any],
    vit_sd: Optional[Mapping[str, Any]],
    bert_prefix: str = "bert",
    vit_prefix: str = "vit",
) -> Dict[str, torch.Tensor]:
    """A copy of the port's ``state_dict`` whose tower, fusion and head
    tensors come from the HF state dicts, with the reference's layer split
    (multigraphormer_graph_encoder.py:249-260). Either param layout: a
    scan-layout state_dict is unrolled for the mapping and restacked."""
    scanned = state_dict_layout(state_dict) == "scanned"
    out = unrolled_state_dict(state_dict, cfg)
    n_split = cfg.num_fusion_layers + 1
    n_text = cfg.text_tower.num_hidden_layers
    n_image = cfg.image_tower.num_hidden_layers
    with_vit = cfg.use_image_tower and vit_sd is not None

    new = _under("graph_encoder.text_model.embeddings", bert_embeddings_params(bert_sd, f"{bert_prefix}.embeddings"))
    for i in range(n_text - n_split):
        new.update(_under(f"graph_encoder.text_model.layer_{i}",
                          bert_layer_params(bert_sd, f"{bert_prefix}.encoder.layer.{i}")))
    if with_vit:
        new.update(_under("graph_encoder.vit_model.embeddings",
                          vit_embeddings_params(vit_sd, f"{vit_prefix}.embeddings")))
        for i in range(n_image - n_split):
            new.update(_under(f"graph_encoder.vit_model.layer_{i}",
                              vit_layer_params(vit_sd, f"{vit_prefix}.encoder.layer.{i}")))
        new.update(_under("graph_encoder.vit_model", _modules(vit_sd, vit_prefix, (("layernorm", "layernorm"),))))

    # the top layers -> the fusion stacks, in order (ref 145-168)
    k = 0
    for si, size in enumerate(_stack_sizes(n_split, cfg.num_fusion_stack)):
        for j in range(size):
            dst = f"graph_encoder.fusion_stack_{si}.fusion_{j}"
            new.update(_under(f"{dst}.bert_encoder",
                              bert_layer_params(bert_sd, f"{bert_prefix}.encoder.layer.{n_text - n_split + k}")))
            if with_vit:
                new.update(_under(f"{dst}.vit_encoder",
                                  vit_layer_params(vit_sd, f"{vit_prefix}.encoder.layer.{n_image - n_split + k}")))
            k += 1

    # the output head: BERT's pooler and sequence classifier
    # (multigraphormer_graph_encoder.py:241-246,264-265)
    new.update(_modules(bert_sd, bert_prefix, (("pooler.dense", "text_pooler.dense"),)))
    if "classifier.weight" in bert_sd:
        new.update(_modules(bert_sd, "", (("classifier", "node_classifier"),)))
    if with_vit and f"{vit_prefix}.pooler.dense.weight" in vit_sd and "vit_pooler.dense.weight" in out:
        new.update(_modules(vit_sd, vit_prefix, (("pooler.dense", "vit_pooler.dense"),)))
    put(out, new)
    return scanned_state_dict(out, cfg) if scanned else out


def state_dicts_from_pretrained(
    text_name: str = "bert-base-uncased",
    image_name: str = "google/vit-base-patch16-224",
    attention_dropout: float = 0.3,
    hidden_dropout: float = 0.3,
):
    """The HF models' state dicts as numpy (network or the local HF cache
    needed), with ``build_vit_bert_encoders``' dropout overrides
    (multigraphormer_graph_encoder.py:233-245); the ViT's keys get the
    ``vit.`` prefix ``import_towers`` expects."""
    from transformers import AutoModel, AutoModelForSequenceClassification

    bert = AutoModelForSequenceClassification.from_pretrained(
        text_name, hidden_dropout_prob=hidden_dropout, attention_probs_dropout_prob=attention_dropout
    )
    vit = AutoModel.from_pretrained(
        image_name, hidden_dropout_prob=hidden_dropout, attention_probs_dropout_prob=attention_dropout
    )
    with torch.no_grad():
        bert_sd = {k: v.numpy() for k, v in bert.state_dict().items()}
        vit_sd = {"vit." + k: v.numpy() for k, v in vit.state_dict().items()}
    return bert_sd, vit_sd
