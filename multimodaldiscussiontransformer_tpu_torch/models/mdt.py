"""The full Multi-Modal Discussion Transformer: encoder + output head.

- the text tower runs over a fixed-capacity flat node buffer (C, T, D);
- the bottleneck <-> graph-grid exchange is a pair of scatter/gather ops
  through ``node_graph * Nmax + node_pos`` flat indices. Padded node slots
  point past the grid; ``gather_fill``/``scatter_drop`` mask them, since
  plain indexing would raise on the CPU and assert on CUDA;
- the interleave follows the reference's ``zip(layers, fusion[1:])`` +
  ``layers[-1]`` control flow, including the second-to-last graph stack that
  the reference builds but never runs under canonical args
  (``reproduce_dead_graph_stack``); that stack is not built here, as in the
  JAX package;
- the head applies the shared [text_pooler -> node_classifier] stack to the
  text CLS path and to the bottleneck token-0 path and averages the logits.

This is the inference forward (the JAX model's ``deterministic=True``):
there is no dropout.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig
from multimodaldiscussiontransformer_tpu_torch.models.bert import (
    BertBottomTower,
    BertPooler,
    Dense,
    LayerNorm,
    attention_mask_bias,
)
from multimodaldiscussiontransformer_tpu_torch.models.fusion import (
    GraphFusionStack,
    gather_fill,
    scatter_drop,
)
from multimodaldiscussiontransformer_tpu_torch.models.graphormer import (
    GraphAttnBias,
    GraphEncoderStack,
    GraphNodeFeature,
)
from multimodaldiscussiontransformer_tpu_torch.models.vit import ViTBottomTower

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# init std of raw (non-Linear, non-LayerNorm) parameters; the rest get 0.02
_RAW_INIT_STD = {"bottle_neck": 1.0, "cls_token": 0.0}


class EncoderOutput(NamedTuple):
    text_states: torch.Tensor  # (C, T, D) final text-tower states
    bottleneck: torch.Tensor  # (C, nbn, D) final bottleneck tokens
    global_embedding: torch.Tensor  # (B, D) graph-token state


class MDTOutput(NamedTuple):
    logits: torch.Tensor  # (C, num_classes); padded slots hold garbage
    global_embedding: torch.Tensor  # (B, D)
    text_states: torch.Tensor  # (C, T, D)
    bottleneck: torch.Tensor  # (C, nbn, D)


def _stack_sizes(total: int, chunk: int) -> list:
    """``total`` layers chunked into groups of ``chunk`` (the last may be
    smaller)."""
    return [min(chunk, total - i) for i in range(0, total, chunk)]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for settings the port does not have."""
    unsupported = {
        "scan_layers": cfg.scan_layers,
        "sequence_parallel": cfg.sequence_parallel,
        "remat": cfg.remat,
        "text_tower.use_pallas_attention": cfg.text_tower.use_pallas_attention,
        "image_tower.use_pallas_attention": cfg.image_tower.use_pallas_attention,
    }
    on = [name for name, value in unsupported.items() if value]
    if on:
        raise NotImplementedError(f"the PyTorch port does not support {', '.join(on)}=True")
    if cfg.param_dtype != "float32":
        raise NotImplementedError(f"param_dtype {cfg.param_dtype!r}: the port keeps float32 params")
    if cfg.dtype not in _DTYPES:
        raise NotImplementedError(f"compute dtype {cfg.dtype!r} not in {sorted(_DTYPES)}")


class MultiGraphormerGraphEncoder(nn.Module):
    """The core interleaved text/image/graph encoder."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.text_model = BertBottomTower(c.text_tower, c.num_bottom_text_layers, dtype)
        if c.use_image_tower:
            self.vit_model = ViTBottomTower(c.image_tower, c.num_bottom_image_layers, dtype)
        sizes = _stack_sizes(c.num_fusion_layers + 1, c.num_fusion_stack)
        self.fusion_stacks = []
        for i, n in enumerate(sizes):
            stack = GraphFusionStack(c, n, dtype)
            self.add_module(f"fusion_stack_{i}", stack)
            self.fusion_stacks.append(stack)
        dead = len(sizes) - 1 if c.reproduce_dead_graph_stack else None
        self.graph_stacks = []
        for i in range(len(sizes) + 1):
            stack = None
            if i != dead:
                stack = GraphEncoderStack(c, c.num_graph_stack, dtype)
                self.add_module(f"graph_stack_{i}", stack)
            self.graph_stacks.append(stack)
        self.graph_node_feature = GraphNodeFeature(c, dtype)
        self.graph_attn_bias = GraphAttnBias(c, dtype)
        self.bottle_neck = nn.Parameter(torch.empty(c.num_bottleneck_tokens, c.encoder_embed_dim))
        if c.encoder_normalize_before:
            self.emb_layer_norm = LayerNorm(c.encoder_embed_dim, 1e-5, dtype)

    def forward(self, batch: Dict[str, torch.Tensor]) -> EncoderOutput:
        c = self.config
        d = c.encoder_embed_dim
        nbn = c.num_bottleneck_tokens
        attention_mask = batch["attention_mask"]
        cap = attention_mask.shape[0]
        bsz, nmax = batch["in_degree"].shape

        # bottom towers
        bert = self.text_model(batch["input_ids"], batch["token_type_ids"], attention_mask)
        vit, image_node = None, None
        if c.use_image_tower:
            vit = self.vit_model(batch["images"])
            image_node = batch["image_node"]

        # bottleneck init + the fusion mask (bottleneck columns visible)
        bn = self.bottle_neck.to(self.dtype)[None].expand(cap, nbn, d)
        fusion_mask = torch.cat([attention_mask.new_ones(cap, nbn), attention_mask], dim=1)
        mask_bias = attention_mask_bias(fusion_mask, self.dtype)
        bert, vit, bn = self.fusion_stacks[0](bert, vit, bn, mask_bias, image_node)

        # bottleneck token 0 -> the (B, Nmax) grid; padded slots are dropped
        flat_idx = batch["node_graph"] * nmax + batch["node_pos"]
        grid = scatter_drop(bert.new_zeros(bsz * nmax, d), flat_idx, bn[:, 0]).view(bsz, nmax, d)
        key_padding_mask = torch.cat(
            [batch["grid_mask"].new_zeros(bsz, 1), ~batch["grid_mask"]], dim=1
        )
        x = self.graph_node_feature(grid, batch["in_degree"], batch["out_degree"])
        if c.use_pallas_attention:
            attn_bias = self.graph_attn_bias.compact_inputs(batch["attn_bias"], batch["spatial_pos"])
        else:
            attn_bias = self.graph_attn_bias(batch["attn_bias"], batch["spatial_pos"])
        if c.encoder_normalize_before:
            x = self.emb_layer_norm(x)

        # interleave: zip(graph stacks, fusion stacks[1:])
        for i in range(len(self.fusion_stacks) - 1):
            x = self.graph_stacks[i](x, attn_bias, key_padding_mask)
            node_states = gather_fill(x[:, 1:].reshape(bsz * nmax, d), flat_idx)
            bn = torch.cat([node_states[:, None], bn[:, 1:]], dim=1)
            bert, vit, bn = self.fusion_stacks[i + 1](bert, vit, bn, mask_bias, image_node)
            tail = scatter_drop(x[:, 1:].reshape(bsz * nmax, d), flat_idx, bn[:, 0])
            x = torch.cat([x[:, :1], tail.view(bsz, nmax, d)], dim=1)

        if not c.reproduce_dead_graph_stack:
            x = self.graph_stacks[-2](x, attn_bias, key_padding_mask)
        x = self.graph_stacks[-1](x, attn_bias, key_padding_mask)
        return EncoderOutput(text_states=bert, bottleneck=bn, global_embedding=x[:, 0])


class MDTModel(nn.Module):
    """Encoder + output head. Parameters are float32 and drawn from
    ``generator`` (a seeded ``torch.Generator`` on the CPU); the model is
    built on the CPU and moved with ``.to(device)``; matmuls run in
    ``config.dtype``."""

    def __init__(self, config: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(config)
        c = config
        self.config = c
        dt = _DTYPES[c.dtype]
        self.dtype = dt
        self.graph_encoder = MultiGraphormerGraphEncoder(c, dt)
        self.text_pooler = BertPooler(c.text_tower.hidden_size, dt)
        self.node_classifier = Dense(c.text_tower.hidden_size, c.num_classes, dt)
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, batch: Dict[str, torch.Tensor]) -> MDTOutput:
        enc = self.graph_encoder(batch)
        text_logits = self.node_classifier(self.text_pooler(enc.text_states))
        graph_logits = self.node_classifier(self.text_pooler(enc.bottleneck))
        return MDTOutput(
            logits=(text_logits + graph_logits) / 2,
            global_embedding=enc.global_embedding,
            text_states=enc.text_states,
            bottleneck=enc.bottleneck,
        )


@torch.no_grad()
def init_weights(model: MDTModel, generator: torch.Generator) -> None:
    """Random init from ``generator``: Linear and Conv weights
    lecun-normal (normal(0, 0.02) for Linear under
    ``apply_graphormer_init``), biases 0, LayerNorm 1/0, embedding tables
    normal(0, 0.02), raw parameters by ``_RAW_INIT_STD`` (default 0.02)."""
    graphormer_init = model.config.apply_graphormer_init
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            std = 0.02 if graphormer_init and isinstance(mod, nn.Linear) else mod.weight[0].numel() ** -0.5
            mod.weight.normal_(0.0, std, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=generator)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf not in ("weight", "bias"):
            std = _RAW_INIT_STD.get(leaf, 0.02)
            if std:
                p.normal_(0.0, std, generator=generator)
            else:
                p.zero_()
