"""BERT tower modules, and the dense and layer-norm layers every tower uses.

Module and parameter names mirror the JAX package's Flax modules
(``query``, ``attention_output_dense``, ``layer_0`` ...), so that
``utils/flax_import.py`` maps weights by path.

Precision follows Flax's ``dtype`` semantics: parameters are stored in
float32, every matmul runs in the compute dtype, layer-norm statistics and
every softmax run in float32.

Dropout sits where the JAX modules have it (attention probabilities, after
both dense outputs of a layer, after the embedding layer norm) and runs only
when ``deterministic=False`` (``models/fast_dropout.py``).

Under tensor parallelism (``parallel/mesh.py::apply_tensor_parallel``) a
``Dense`` holds its rank's block (``tp_mode`` "col" or "row"; a row-parallel
output is summed over the tp group before its bias), the attention runs the
rank's H/tp heads, and the input of each column-parallel projection passes
``copy_to_group`` (the backward sums its gradient over tp). Without it
(``tp`` None) every module is the one-device module.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodaldiscussiontransformer_tpu_torch.core.config import BertTowerConfig
from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import FastDropout, draw_seed
from multimodaldiscussiontransformer_tpu_torch.models.remat import checkpoint_name
from multimodaldiscussiontransformer_tpu_torch.ops.masked_attention import masked_attention
from multimodaldiscussiontransformer_tpu_torch.parallel.comm import copy_to_group, reduce_from_group

# Large negative bias for masked attention logits: finite, so that a fully
# masked row degrades to uniform attention instead of NaN.
MASK_BIAS = -1e9


def act_fn(name: str):
    """Activation by HF name: exact gelu, tanh-approximated gelu_new, or
    CLIP's QuickGELU."""
    if name == "gelu":
        return F.gelu
    if name == "gelu_new":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    raise ValueError(f"unknown activation {name!r}")


def attention_mask_bias(attention_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(..., S) {0,1} mask -> (..., 1, 1, S) additive bias."""
    m = attention_mask[..., None, None, :].float()
    return ((1.0 - m) * MASK_BIAS).to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` whose parameters (float32 unless the model casts them)
    compute in ``dtype`` (Flax ``nn.Dense(dtype=...)``). A row-parallel
    block (``tp_mode == "row"``) sums its partial product over the tp group
    in float32, then adds the bias."""

    tp = None  # parallel/mesh.py::TPInfo under tensor parallelism
    tp_mode = None  # "col" or "row"

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.tp_mode == "row":
            y = reduce_from_group(F.linear(x.to(dt), self.weight.to(dt)).float(), self.tp.group).to(dt)
            return y if bias is None else y + bias
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def tp_input(x: torch.Tensor, tp) -> torch.Tensor:
    """The input of column-parallel projections: its gradient is summed over
    the tp group (identity without tensor parallelism)."""
    return x if tp is None else copy_to_group(x, tp.group)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in float32, returned in ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class SelfAttention(nn.Module):
    """HF-style encoder self-attention shared by BERT and ViT: plain matmuls
    in the compute dtype and a float32 softmax.

    With ``use_pallas`` (tower config ``use_pallas_attention``) and a
    key-only bias ((B, 1, 1, S) or None, which is what the towers pass), the
    softmax, dropout and value contraction run through the fused tower op
    (``ops/masked_attention.py``): the CUDA kernels on the card, their plain
    version on the CPU. In training it takes a fresh seed per call from the
    host generator and drops at ``dropout_rate`` inside the op, so the
    (B, H, S, S) probabilities are never stored for the backward.

    Under tensor parallelism (``tp``) the rank runs heads ``tp.span(H)``;
    the fused op's dropout seed is folded with the tp rank (its Philox
    counter holds the local head index), and ``attn_dropout`` draws the
    whole (B, H, S, S) mask and keeps the rank's heads."""

    tp = None

    def __init__(
        self, hidden_size: int, num_heads: int, dtype: torch.dtype, dropout_rate: float = 0.0, use_pallas: bool = False
    ):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.use_pallas = use_pallas
        self.query = Dense(hidden_size, hidden_size, dtype)
        self.key = Dense(hidden_size, hidden_size, dtype)
        self.value = Dense(hidden_size, hidden_size, dtype)
        self.attn_dropout = FastDropout(dropout_rate)

    def forward(
        self, hidden: torch.Tensor, attn_bias: Optional[torch.Tensor] = None, deterministic: bool = True
    ) -> torch.Tensor:
        b, s, _ = hidden.shape
        tp = self.tp
        dh = self.hidden_size // self.num_heads
        h = self.num_heads if tp is None else self.num_heads // tp.size
        hidden = tp_input(hidden, tp)

        def heads(x):  # (B, S, D) -> (B, H, S, dh)
            return x.view(b, s, h, dh).transpose(1, 2)

        q, k, v = heads(self.query(hidden)), heads(self.key(hidden)), heads(self.value(hidden))
        key_only = attn_bias is None or (attn_bias.dim() == 4 and attn_bias.shape[1] == attn_bias.shape[2] == 1)
        if self.use_pallas and key_only and b > 0:
            rate = 0.0 if deterministic else self.dropout_rate
            ctx = masked_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                None if attn_bias is None else attn_bias[:, 0, 0, :].float().contiguous(),
                seed=draw_seed(0 if tp is None else tp.rank) if rate > 0.0 else None, rate=rate, scale=dh ** -0.5,
            )
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
            if attn_bias is not None:
                scores = scores + attn_bias
            probs = torch.softmax(scores.float(), dim=-1).to(hidden.dtype)
            ctx = torch.matmul(self.attn_dropout(probs, deterministic), v)
        return ctx.transpose(1, 2).reshape(b, s, h * dh)


class BertLayer(nn.Module):
    """One post-LN BERT encoder layer: self-attention -> dense + LN(residual)
    -> intermediate activation -> dense + LN(residual)."""

    tp_ffn = None  # the FFN pair's tp group when it is sharded

    def __init__(self, config: BertTowerConfig, dtype: torch.dtype):
        super().__init__()
        c, d = config, dtype
        self.act = act_fn(c.hidden_act)
        self.attention = SelfAttention(
            c.hidden_size, c.num_attention_heads, d, c.attention_probs_dropout_prob, c.use_pallas_attention
        )
        self.attention_output_dense = Dense(c.hidden_size, c.hidden_size, d)
        self.attention_output_layernorm = LayerNorm(c.hidden_size, c.layer_norm_eps, d)
        self.intermediate_dense = Dense(c.hidden_size, c.intermediate_size, d)
        self.output_dense = Dense(c.intermediate_size, c.hidden_size, d)
        self.output_layernorm = LayerNorm(c.hidden_size, c.layer_norm_eps, d)
        self.hidden_dropout = FastDropout(c.hidden_dropout_prob)

    def forward(
        self, hidden: torch.Tensor, attn_bias: Optional[torch.Tensor] = None, deterministic: bool = True
    ) -> torch.Tensor:
        attn = self.attention_output_dense(self.attention(hidden, attn_bias, deterministic))
        attn = self.hidden_dropout(checkpoint_name(attn, "attn_proj"), deterministic)
        # the remat policies' saveables (models/remat.py): identities outside remat
        hidden = checkpoint_name(self.attention_output_layernorm(attn + hidden), "attn_out")
        out = self.output_dense(checkpoint_name(self.act(self.intermediate_dense(tp_input(hidden, self.tp_ffn))), "ffn_mid"))
        out = self.hidden_dropout(out, deterministic)
        return checkpoint_name(self.output_layernorm(out + hidden), "ffn_out")


class BertEmbeddings(nn.Module):
    """Word + position + token-type embeddings, then layer norm."""

    def __init__(self, config: BertTowerConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.layernorm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.dropout = FastDropout(c.hidden_dropout_prob)

    def forward(
        self, input_ids: torch.Tensor, token_type_ids: torch.Tensor, deterministic: bool = True
    ) -> torch.Tensor:
        c = self.config
        s = input_ids.shape[-1]
        if c.position_offset:
            # RoBERTa position ids: running count of non-pad tokens, shifted
            # past padding_idx
            mask = (input_ids != c.pad_token_id).long()
            positions = torch.cumsum(mask, dim=-1) * mask + (c.position_offset - 1)
        else:
            positions = torch.arange(s, device=input_ids.device)[None, :]
        emb = self.word_embeddings(input_ids) + self.position_embeddings(positions)
        if c.use_token_type:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layernorm(emb.to(self.dtype)), deterministic)


class BertPooler(nn.Module):
    """Dense + tanh on token 0: the text pooler, and the graph-path pooler
    of the output head."""

    def __init__(self, hidden_size: int, dtype: torch.dtype):
        super().__init__()
        self.dense = Dense(hidden_size, hidden_size, dtype)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))


class BertBottomTower(nn.Module):
    """Embeddings + the bottom ``num_layers`` BERT layers (the top layers are
    split off into fusion stacks; BERT has no final layer norm)."""

    def __init__(self, config: BertTowerConfig, num_layers: int, dtype: torch.dtype):
        super().__init__()
        self.embeddings = BertEmbeddings(config, dtype)
        self.layers = []
        for i in range(num_layers):
            lyr = BertLayer(config, dtype)
            self.add_module(f"layer_{i}", lyr)
            self.layers.append(lyr)

    def forward(self, input_ids, token_type_ids, attention_mask, deterministic: bool = True) -> torch.Tensor:
        hidden = self.embeddings(input_ids, token_type_ids, deterministic)
        bias = attention_mask_bias(attention_mask, hidden.dtype)
        for lyr in self.layers:
            hidden = lyr(hidden, bias, deterministic)
        return hidden
