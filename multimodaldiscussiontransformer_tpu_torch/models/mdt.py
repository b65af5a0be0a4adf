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

``forward(batch, deterministic=True)`` is the inference forward; with
``deterministic=False`` (training) every dropout site of the JAX model is
live, the frozen towers' included, and the forward runs inside
``models/fast_dropout.py::dropout_rngs``. A training forward under
``config.remat`` runs each fusion and graph stack as one rematerialised
segment with ``config.remat_policy`` (``models/remat.py``), as the JAX
model wraps ``run_fusion`` and ``run_graph`` in ``jax.checkpoint``; the
bottom towers stay outside.

``config.scan_layers`` is a parameter layout (``utils/scan_params.py``):
the modules run unrolled either way.

Sequence parallelism (``sp`` set by ``parallel/mesh.py::
apply_sequence_parallel``; ``config.sequence_parallel`` without an sp group
is the one-device model, as in JAX without an sp axis): the rank's batch is
its share (``parallel/input.py::sp_share``): its block of the flat node
slots and a strip of c rows of the token-prefixed grid, S = Nmax + 1 padded
to S' = c n. The graph layers run on the strip (B, c, D), the attention as
a ring over the group. The transitions between the flat slots and the grid
cross ranks, since a rank's slots may belong to any strip:
- slots -> grid (``scatter_drop``): each rank scatters its slots into a
  zero (B, S', D) grid (and a 0/1 column marking the rows it writes); the
  sum over the group, of which each rank keeps its strip
  (``reduce_scatter_dim``), is the one-device grid (each row is written
  by one rank);
- grid -> slots (``gather_fill``): the strips gathered over the group
  (``all_gather_dim``), read at the rank's slots;
the gradients of both are summed back across the group. The graph token
(row 0) lives in strip 0; the global embedding is broadcast from there to
the group (``broadcast_from``), and its gradient returns there.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from multimodaldiscussiontransformer_tpu_torch.core.config import (
    ModelConfig,
    clip_vit_tower_config,
    roberta_tower_config,
)
from multimodaldiscussiontransformer_tpu_torch.core.registry import register_model_architecture
from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import FastDropout
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
    BiasedMultiheadAttention,
    GraphAttnBias,
    GraphEncoderStack,
    GraphNodeFeature,
)
from multimodaldiscussiontransformer_tpu_torch.models.remat import POLICIES, remat_segment
from multimodaldiscussiontransformer_tpu_torch.models.vit import ViTBottomTower
from multimodaldiscussiontransformer_tpu_torch.parallel.comm import all_gather_dim, broadcast_from, reduce_scatter_dim

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# init std of raw (non-Linear, non-LayerNorm) parameters; the rest get 0.02
_RAW_INIT_STD = {"bottle_neck": 1.0, "cls_token": 0.0}
# std of a unit normal truncated to (-2, 2), as Flax's variance scaling uses
_TRUNCATED_STD = 0.87962566103423978


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
    """Raise ``NotImplementedError`` for settings the port does not have,
    ``ValueError`` for an unknown remat policy."""
    if cfg.remat and cfg.remat_policy not in POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r} not in {POLICIES}")
    for what, name in (("compute dtype", cfg.dtype), ("param_dtype", cfg.param_dtype)):
        if name not in _DTYPES:
            raise NotImplementedError(f"{what} {name!r} not in {sorted(_DTYPES)}")


class MultiGraphormerGraphEncoder(nn.Module):
    """The core interleaved text/image/graph encoder; under sequence
    parallelism (``sp``) on the rank's share of the batch."""

    sp = None

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
        self.emb_dropout = FastDropout(c.dropout)

    def forward(self, batch: Dict[str, torch.Tensor], deterministic: bool = True) -> EncoderOutput:
        c = self.config
        d = c.encoder_embed_dim
        nbn = c.num_bottleneck_tokens
        attention_mask = batch["attention_mask"]
        cap = attention_mask.shape[0]
        sp = self.sp
        if sp is None:
            bsz, nmax = batch["in_degree"].shape
        else:  # a strip of the token-prefixed grid; nodes at rows 1 .. S' - 1
            bsz, nmax = batch["in_degree"].shape[0], batch["in_degree"].shape[1] * sp.size - 1

        det = deterministic
        if c.remat and not det:
            def run(stack, *args):
                return remat_segment(stack, *args, policy=c.remat_policy)
        else:
            def run(stack, *args):
                return stack(*args)

        # bottom towers
        bert = self.text_model(batch["input_ids"], batch["token_type_ids"], attention_mask, det)
        vit, image_node = None, None
        if c.use_image_tower:
            vit = self.vit_model(batch["images"], det)
            image_node = batch["image_node"]

        # bottleneck init + the fusion mask (bottleneck columns visible)
        bn = self.bottle_neck.to(self.dtype)[None].expand(cap, nbn, d)
        fusion_mask = torch.cat([attention_mask.new_ones(cap, nbn), attention_mask], dim=1)
        mask_bias = attention_mask_bias(fusion_mask, self.dtype)
        bert, vit, bn = run(self.fusion_stacks[0], bert, vit, bn, mask_bias, image_node, det)

        flat_idx = batch["node_graph"] * nmax + batch["node_pos"]
        if sp is None:
            # bottleneck token 0 -> the (B, Nmax) grid; padded slots are dropped
            grid = scatter_drop(bert.new_zeros(bsz * nmax, d), flat_idx, bn[:, 0]).view(bsz, nmax, d)
            key_padding_mask = torch.cat(
                [batch["grid_mask"].new_zeros(bsz, 1), ~batch["grid_mask"]], dim=1
            )
            x = self.graph_node_feature(grid, batch["in_degree"], batch["out_degree"])
            if c.use_pallas_attention:
                attn_bias = self.graph_attn_bias.compact_inputs(batch["attn_bias"], batch["spatial_pos"])
            else:
                attn_bias = self.graph_attn_bias(batch["attn_bias"], batch["spatial_pos"])
        else:
            has_token = sp.rank == 0
            x = self.graph_node_feature.strip(self._slots_to_strip(bn[:, 0], flat_idx, bsz, nmax)[..., :d],
                                              batch["in_degree"], batch["out_degree"], has_token)
            key_padding_mask = None  # the template strip encodes key padding
            attn_bias = self.graph_attn_bias.compact_strip(batch["attn_bias"], batch["spatial_pos"], has_token)
        if c.encoder_normalize_before:
            x = self.emb_layer_norm(x)
        x = self.emb_dropout(x, det)

        # interleave: zip(graph stacks, fusion stacks[1:])
        for i in range(len(self.fusion_stacks) - 1):
            x = run(self.graph_stacks[i], x, attn_bias, key_padding_mask, det)
            grid_x = x if sp is None else all_gather_dim(x, 1, sp.group)
            node_states = gather_fill(grid_x[:, 1:].reshape(bsz * nmax, d), flat_idx)
            bn = torch.cat([node_states[:, None], bn[:, 1:]], dim=1)
            bert, vit, bn = run(self.fusion_stacks[i + 1], bert, vit, bn, mask_bias, image_node, det)
            if sp is None:
                tail = scatter_drop(x[:, 1:].reshape(bsz * nmax, d), flat_idx, bn[:, 0])
                x = torch.cat([x[:, :1], tail.view(bsz, nmax, d)], dim=1)
            else:  # the rows some rank's slots write take the slots' states
                written = self._slots_to_strip(bn[:, 0], flat_idx, bsz, nmax)
                x = torch.where(written[..., d:] > 0, written[..., :d], x)

        if not c.reproduce_dead_graph_stack:
            x = run(self.graph_stacks[-2], x, attn_bias, key_padding_mask, det)
        x = run(self.graph_stacks[-1], x, attn_bias, key_padding_mask, det)
        glob = x[:, 0] if sp is None else broadcast_from(x[:, 0], 0, sp.group)
        return EncoderOutput(text_states=bert, bottleneck=bn, global_embedding=glob)

    def _slots_to_strip(self, values: torch.Tensor, flat_idx: torch.Tensor, bsz: int, nmax: int) -> torch.Tensor:
        """(B, c, D + 1): the rank's strip of the token-prefixed grid that
        every rank's slots write (``values`` (C/n, D) at ``flat_idx`` in
        the (B, Nmax') node grid), summed over the sp group, with a last
        column of 1 on the rows that some slot writes."""
        d = values.shape[-1]
        marked = torch.cat([values, values.new_ones(values.shape[0], 1)], dim=1)
        grid = scatter_drop(values.new_zeros(bsz * nmax, d + 1), flat_idx, marked).view(bsz, nmax, d + 1)
        grid = torch.cat([grid.new_zeros(bsz, 1, d + 1), grid], dim=1)
        return reduce_scatter_dim(grid, 1, self.sp.group)


class MDTModel(nn.Module):
    """Encoder + output head. Parameters are drawn in float32 from
    ``generator`` (a seeded ``torch.Generator`` on the CPU) and stored in
    ``config.param_dtype``; the model is built on the CPU and moved with
    ``.to(device)``; matmuls run in ``config.dtype``."""

    def __init__(self, config: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(config)
        c = config
        self.config = c
        dt = _DTYPES[c.dtype]
        self.dtype = dt
        self.graph_encoder = MultiGraphormerGraphEncoder(c, dt)
        self.text_pooler = BertPooler(c.text_tower.hidden_size, dt)
        self.text_dropout = FastDropout(c.text_tower.hidden_dropout_prob)
        self.node_classifier = Dense(c.text_tower.hidden_size, c.num_classes, dt)
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        if c.param_dtype != "float32":
            self.to(_DTYPES[c.param_dtype])

    def forward(self, batch: Dict[str, torch.Tensor], deterministic: bool = True) -> MDTOutput:
        enc = self.graph_encoder(batch, deterministic)

        def head(states):
            return self.node_classifier(self.text_dropout(self.text_pooler(states), deterministic))

        text_logits = head(enc.text_states)
        graph_logits = head(enc.bottleneck)
        return MDTOutput(
            logits=(text_logits + graph_logits) / 2,
            global_embedding=enc.global_embedding,
            text_states=enc.text_states,
            bottleneck=enc.bottleneck,
        )


def _lecun_normal(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default Dense/Conv kernel init: variance_scaling(1, fan_in,
    truncated_normal), i.e. a normal truncated to two of its std, scaled so
    that the std is 1/sqrt(fan_in)."""
    std = w[0].numel() ** -0.5 / _TRUNCATED_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _fan_avg_uniform(w: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    """variance_scaling(scale, fan_avg, uniform) of a (out, in) weight."""
    fan_out, fan_in = w.shape
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2))
    nn.init.uniform_(w, -limit, limit, generator=generator)


@torch.no_grad()
def init_weights(model: MDTModel, generator: torch.Generator) -> None:
    """Random init from ``generator``, with the JAX modules' initializers:
    - Linear and Conv weights lecun-normal (truncated), biases 0;
    - graph attention q/k/v_proj variance_scaling(0.5, fan_avg, uniform)
      and out_proj xavier_uniform (fairseq's scaled xavier init);
    - embedding tables normal(0, 1/sqrt(dim)) (Flax ``nn.Embed``);
    - LayerNorm 1/0; raw parameters by ``_RAW_INIT_STD`` (default 0.02);
    - with ``apply_graphormer_init``: every Linear weight and embedding table
      normal(0, 0.02) instead (Conv untouched), as the reference's
      ``init_graphormer_params``."""
    graphormer_init = model.config.apply_graphormer_init
    fan_avg_scale = {}
    for mod in model.modules():
        if isinstance(mod, BiasedMultiheadAttention):
            fan_avg_scale.update({id(mod.q_proj): 0.5, id(mod.k_proj): 0.5, id(mod.v_proj): 0.5, id(mod.out_proj): 1.0})
    for mod in model.modules():
        if isinstance(mod, nn.Linear) and graphormer_init:
            mod.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, nn.Linear) and id(mod) in fan_avg_scale:
            _fan_avg_uniform(mod.weight, fan_avg_scale[id(mod)], generator)
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            _lecun_normal(mod.weight, generator)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02 if graphormer_init else mod.weight.shape[1] ** -0.5, generator=generator)
        if isinstance(mod, (nn.Linear, nn.Conv2d)) and mod.bias is not None:
            mod.bias.zero_()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf not in ("weight", "bias"):
            std = _RAW_INIT_STD.get(leaf, 0.02)
            if std:
                p.normal_(0.0, std, generator=generator)
            else:
                p.zero_()


@register_model_architecture("multi_graphormer")
def multi_graphormer(cfg: Optional[ModelConfig] = None, **overrides) -> ModelConfig:
    """The reference's ``base_architecture`` defaults."""
    base = cfg if cfg is not None else ModelConfig(
        dropout=0.1, attention_dropout=0.1, act_dropout=0.0, encoder_ffn_embed_dim=4096,
        encoder_attention_heads=8, encoder_embed_dim=1024, num_bottleneck_tokens=4,
        num_fusion_layers=4, num_graph_stack=1, num_fusion_stack=1,
    )
    return base.replace(**overrides) if overrides else base


@register_model_architecture("multi_graphormer_base")
def multi_graphormer_base(cfg: Optional[ModelConfig] = None, **overrides) -> ModelConfig:
    """``graphormer_base_architecture`` with the canonical launch overrides
    (the ``ModelConfig()`` defaults)."""
    base = cfg if cfg is not None else ModelConfig()
    return base.replace(**overrides) if overrides else base


@register_model_architecture("multi_graphormer_graph_only")
def multi_graphormer_graph_only(**overrides) -> ModelConfig:
    """Graph-only ablation: no image tower."""
    base = ModelConfig(use_image_tower=False)
    return base.replace(**overrides) if overrides else base


@register_model_architecture("multi_graphormer_roberta_clip")
def multi_graphormer_roberta_clip(**overrides) -> ModelConfig:
    """Encoder-swap ablation: RoBERTa text tower + CLIP-ViT image tower."""
    base = ModelConfig(
        text_tower=roberta_tower_config(), image_tower=clip_vit_tower_config(),
        text_encoder_name="roberta-base", image_encoder_name="openai/clip-vit-base-patch32",
    )
    return base.replace(**overrides) if overrides else base
