"""Graphormer-style graph transformer blocks.

- ``padding_idx=0`` embeddings become masked lookups (``masked_embed``): id 0
  contributes an exact zero vector, which is how the +1-shifted collator
  encodes padding;
- softmax runs in float32 whatever the compute dtype;
- the graph attention takes one of three branches, where the JAX layer
  takes them:
  - a compact (template, ids, lut) bias (``MDTModel`` with
    ``use_pallas_attention``) runs the tree-attention kernel
    (``ops/tree_attention.py``), whose attention dropout is its own (rate
    ``attention_dropout``, one fresh seed per call from the host
    generator);
  - a dense (B, H|1, S, S) bias or none, with ``use_pallas_attention`` and
    either ``deterministic`` or ``attention_dropout == 0``, runs the fused
    dense-bias op (``ops/biased_attention.py``, a hand-written kernel on
    the card);
  - otherwise attention is plain PyTorch (matmul, f32 softmax, matmul)
    with ``FastDropout`` on the probabilities;
- ``dropout``/``act_dropout`` sit where the JAX layer has them.

Under sequence parallelism (``parallel/mesh.py::apply_sequence_parallel``)
the layers hold a strip of the graph grid's node axis and the compact-bias
attention runs as a ring over the sp group
(``ops/ring_attention.py::ring_tree_attention_local``), as the JAX layer
routes it through ``ring_tree_attention_dispatch``; the ring's seed is one
fresh draw per call, folded per tile with the data shard, the strip and the
block.

Under tensor parallelism (``parallel/mesh.py``) the attention runs the
rank's H/tp heads: ``GraphAttnBias`` takes the rank's columns of the
per-head parameters (the spatial table, the virtual distance) through
``copy_to_group``, so that those replicated parameters get every head's
gradient; the tree kernel's seed is folded with the tp rank; fc1/fc2 are a
column/row-parallel pair.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig
from multimodaldiscussiontransformer_tpu_torch.models.bert import (
    MASK_BIAS,
    Dense,
    LayerNorm,
    tp_input,
)
from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import FastDropout, draw_seed
from multimodaldiscussiontransformer_tpu_torch.models.remat import checkpoint_name
from multimodaldiscussiontransformer_tpu_torch.ops import tree_attention as ta
from multimodaldiscussiontransformer_tpu_torch.ops.biased_attention import biased_attention
from multimodaldiscussiontransformer_tpu_torch.ops.ring_attention import ring_tree_attention_local
from multimodaldiscussiontransformer_tpu_torch.parallel.comm import copy_to_group

CompactBias = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def graph_activation_fn(name: str):
    """The fairseq activations the reference exposes on ``--activation-fn``;
    ``gelu`` is the exact erf variant, ``gelu_fast``/``gelu_accurate`` the
    tanh approximation."""
    table = {
        "gelu": F.gelu,
        "gelu_fast": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_accurate": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu_squared": lambda x: torch.square(F.relu(x)),
        "tanh": torch.tanh,
        "linear": lambda x: x,
    }
    if name not in table:
        raise ValueError(f"unknown activation_fn {name!r}; supported: {sorted(table)}")
    return table[name]


def masked_embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup where id 0 gives an exact zero vector and ids
    saturate at the last row: a degree or bucket past the table reads the
    final embedding. The clamp comes before the lookup, so no id outside the
    table ever reaches the index (which would assert on CUDA)."""
    ids = ids.clamp(0, table.shape[0] - 1)
    out = table[ids]
    return torch.where((ids == 0)[..., None], 0.0, out)


def _normal_param(*shape: int) -> nn.Parameter:
    """A parameter to be filled by ``models/mdt.py::init_weights``."""
    return nn.Parameter(torch.empty(*shape))


class GraphNodeFeature(nn.Module):
    """Node features: node states + in/out-degree embeddings, with a learned
    graph token prepended."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        d = c.encoder_embed_dim
        self.dtype = dtype
        self.in_degree_encoder = _normal_param(c.num_in_degree, d)
        self.out_degree_encoder = _normal_param(c.num_out_degree, d)
        self.graph_token = _normal_param(1, d)

    def forward(self, x, in_degree, out_degree) -> torch.Tensor:
        dt = self.dtype
        feats = (
            x
            + masked_embed(self.in_degree_encoder.to(dt), in_degree)
            + masked_embed(self.out_degree_encoder.to(dt), out_degree)
        )
        tok = self.graph_token.to(dt)[None].expand(x.shape[0], 1, x.shape[-1])
        return torch.cat([tok, feats], dim=1)

    def strip(self, x, in_degree, out_degree, has_token: bool) -> torch.Tensor:
        """The features of a strip of the token-prefixed grid (sequence
        parallelism): ``x``, ``in_degree``, ``out_degree`` (B, c[, D]) with
        the token's row first in strip 0 (``has_token``), where the graph
        token replaces it. The other strips add 0 x the token, so that every
        rank of the group holds a gradient for it (zeros there): the
        gradient sum over the group and FSDP's reduce-scatter take the same
        tensors on every rank."""
        dt = self.dtype
        feats = (
            x
            + masked_embed(self.in_degree_encoder.to(dt), in_degree)
            + masked_embed(self.out_degree_encoder.to(dt), out_degree)
        )
        tok = self.graph_token.to(dt)[None].expand(x.shape[0], 1, x.shape[-1])
        first = tok if has_token else feats[:, :1] + 0.0 * tok
        return torch.cat([first, feats[:, 1:]], dim=1)


class GraphAttnBias(nn.Module):
    """Per-head attention bias: spatial-bucket embeddings over node pairs plus
    a learned virtual distance for the graph-token row and column. Keeps the
    reference's double addition of the base template when
    ``config.double_add_attn_bias``. Under tensor parallelism (``tp``) the
    bias holds the rank's heads only."""

    tp = None

    def __init__(self, config: ModelConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        h = c.encoder_attention_heads
        self.spatial_pos_encoder = _normal_param(c.num_spatial, h)
        self.graph_token_virtual_distance = _normal_param(1, h)

    def head_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(spatial table, virtual distance) of this rank's heads."""
        table, virtual = self.spatial_pos_encoder, self.graph_token_virtual_distance
        if self.tp is None:
            return table, virtual
        heads = self.tp.span(self.config.encoder_attention_heads)
        return copy_to_group(table, self.tp.group)[:, heads], copy_to_group(virtual, self.tp.group)[:, heads]

    def forward(self, attn_bias: torch.Tensor, spatial_pos: torch.Tensor) -> torch.Tensor:
        """Dense (B, H, N+1, N+1) bias from the (B, N+1, N+1) template and
        the (B, N, N) +1-shifted bucket ids."""
        dt = self.dtype
        table, virtual = self.head_params()
        h = table.shape[1]
        template = attn_bias.to(dt)[:, None]
        g = template.expand(-1, h, -1, -1).clone()
        sp = masked_embed(table.to(dt), spatial_pos).permute(0, 3, 1, 2)
        g[:, :, 1:, 1:] += sp
        t = virtual.to(dt).view(1, h, 1)
        g[:, :, 1:, 0] += t
        g[:, :, 0, :] += t
        if self.config.double_add_attn_bias:
            g = g + template
        return g

    def compact_inputs(self, attn_bias: torch.Tensor, spatial_pos: torch.Tensor) -> CompactBias:
        """(template, ids, lut) for the tree-attention kernel, which builds
        the bias on the fly instead of reading a (B, H, S, S) tensor."""
        table, virtual = self.head_params()
        return ta.build_compact_bias_inputs(attn_bias, spatial_pos, table.float(), virtual.float())

    def compact_strip(self, attn_bias: torch.Tensor, spatial_pos: torch.Tensor, has_token: bool) -> CompactBias:
        """(template, ids, lut) of a q-row strip (sequence parallelism):
        ``attn_bias`` the (B, c, S') template strip, ``spatial_pos`` the
        (B, c, S') strip of bucket ids on the token-prefixed axis
        (``parallel/input.py::sp_share``); the graph token's column, and in
        strip 0 (``has_token``) its row, take GRAPH_TOKEN_ID, as
        ``build_compact_bias_inputs`` gives the whole grid."""
        table, virtual = self.head_params()
        ids = spatial_pos.to(torch.int32)
        ids[:, :, 0] = ta.GRAPH_TOKEN_ID
        if has_token:
            ids[:, 0, :] = ta.GRAPH_TOKEN_ID
        return attn_bias.float().contiguous(), ids.contiguous(), ta.compact_lut(table.float(), virtual.float())


class BiasedMultiheadAttention(nn.Module):
    """Self-attention with an additive per-head bias and key-padding
    masking, batch-first; the rank's heads under tensor parallelism, the
    rank's strip of the node axis under sequence parallelism."""

    tp = None
    sp = None

    def __init__(self, config: ModelConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        d = c.encoder_embed_dim
        self.config = c
        self.q_proj = Dense(d, d, dtype)
        self.k_proj = Dense(d, d, dtype)
        self.v_proj = Dense(d, d, dtype)
        self.out_proj = Dense(d, d, dtype)
        self.dropout = FastDropout(c.attention_dropout)

    def forward(
        self,
        x: torch.Tensor,  # (B, S, D)
        attn_bias: Union[torch.Tensor, CompactBias, None],
        key_padding_mask: Optional[torch.Tensor],  # (B, S) bool, True = pad
        deterministic: bool = True,
    ) -> torch.Tensor:
        c = self.config
        b, s, d = x.shape
        tp = self.tp
        dh = d // c.encoder_attention_heads
        h = c.encoder_attention_heads if tp is None else c.encoder_attention_heads // tp.size
        scaling = dh ** -0.5
        x = tp_input(x, tp)

        def heads(y):  # (B, S, D) -> (B, H, S, dh)
            return y.view(b, s, h, dh).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        if isinstance(attn_bias, tuple):
            # the template already encodes key padding
            template, ids, lut = attn_bias
            rate = 0.0 if deterministic else c.attention_dropout
            seed = draw_seed(0 if tp is None else tp.rank) if rate > 0.0 else None
            if self.sp is not None:
                ctx = ring_tree_attention_local(
                    q.contiguous(), k.contiguous(), v.contiguous(), template, ids, lut, self.sp.group,
                    scale=scaling, double_add=c.double_add_attn_bias, rate=rate, seed=seed, shard=self.sp.shard,
                )
                return self.out_proj(ctx.transpose(1, 2).reshape(b, s, h * dh))
            ctx = ta.tree_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), template, ids, lut,
                scale=scaling, double_add=c.double_add_attn_bias, rate=rate, seed=seed,
            )
        elif c.use_pallas_attention and (deterministic or c.attention_dropout == 0.0):
            ctx = biased_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                bias=None if attn_bias is None else attn_bias.contiguous(),
                key_padding_mask=key_padding_mask, scale=scaling,
            )
        else:
            scores = torch.matmul(q * scaling, k.transpose(-1, -2))
            if attn_bias is not None:
                scores = scores + attn_bias
            if key_padding_mask is not None:
                scores = scores.masked_fill(key_padding_mask[:, None, None, :], MASK_BIAS)
            probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
            ctx = torch.matmul(self.dropout(probs, deterministic), v)
        return self.out_proj(ctx.transpose(1, 2).reshape(b, s, h * dh))


class GraphormerGraphEncoderLayer(nn.Module):
    """Post-LN (default) or pre-LN transformer block with biased attention;
    layer norms use eps 1e-5."""

    tp_ffn = None  # the FFN pair's tp group when it is sharded

    def __init__(self, config: ModelConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        self.pre = c.pre_layernorm
        self.act = graph_activation_fn(c.activation_fn)
        self.self_attn = BiasedMultiheadAttention(c, dtype)
        self.self_attn_layer_norm = LayerNorm(c.encoder_embed_dim, 1e-5, dtype)
        self.fc1 = Dense(c.encoder_embed_dim, c.encoder_ffn_embed_dim, dtype)
        self.fc2 = Dense(c.encoder_ffn_embed_dim, c.encoder_embed_dim, dtype)
        self.final_layer_norm = LayerNorm(c.encoder_embed_dim, 1e-5, dtype)
        self.dropout = FastDropout(c.dropout)
        self.activation_dropout = FastDropout(c.act_dropout)

    def forward(self, x, attn_bias, key_padding_mask, deterministic: bool = True) -> torch.Tensor:
        residual = x
        if self.pre:
            x = self.self_attn_layer_norm(x)
        x = checkpoint_name(self.self_attn(x, attn_bias, key_padding_mask, deterministic), "attn_proj")
        x = residual + self.dropout(x, deterministic)
        if not self.pre:
            x = self.self_attn_layer_norm(x)
        # the remat policies' saveables (models/remat.py): identities outside remat
        x = checkpoint_name(x, "attn_out")
        residual = x
        if self.pre:
            x = self.final_layer_norm(x)
        x = self.activation_dropout(checkpoint_name(self.act(self.fc1(tp_input(x, self.tp_ffn))), "ffn_mid"), deterministic)
        x = residual + self.dropout(self.fc2(x), deterministic)
        if not self.pre:
            x = self.final_layer_norm(x)
        return checkpoint_name(x, "ffn_out")


class GraphEncoderStack(nn.Module):
    """``num_layers`` chained graph encoder layers."""

    def __init__(self, config: ModelConfig, num_layers: int, dtype: torch.dtype):
        super().__init__()
        self.layers = []
        for i in range(num_layers):
            lyr = GraphormerGraphEncoderLayer(config, dtype)
            self.add_module(f"layer_{i}", lyr)
            self.layers.append(lyr)

    def forward(self, x, attn_bias, key_padding_mask, deterministic: bool = True) -> torch.Tensor:
        for lyr in self.layers:
            x = lyr(x, attn_bias, key_padding_mask, deterministic)
        return x
