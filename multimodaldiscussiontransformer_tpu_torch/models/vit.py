"""ViT tower modules.

As in the JAX package, the bottom tower ends with the model's final layer
norm: HF ``ViTModel`` applies it to the encoder output, and the reference
truncates the encoder but keeps calling the whole model, so that layer norm
runs right after the bottom layers, before fusion.

ViT layers are pre-LN (LN -> attention -> +residual; LN -> MLP ->
+residual) with no attention mask. Dropout (``deterministic=False``) sits
where the JAX modules have it: attention probabilities, both residual
branches, and the embeddings. Images arrive channels-first,
(I, 3, H, W); I may be 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodaldiscussiontransformer_tpu_torch.core.config import ViTTowerConfig
from multimodaldiscussiontransformer_tpu_torch.models.bert import (
    Dense,
    LayerNorm,
    SelfAttention,
    act_fn,
    tp_input,
)
from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import FastDropout
from multimodaldiscussiontransformer_tpu_torch.models.remat import checkpoint_name


class ViTLayer(nn.Module):
    """One pre-LN ViT encoder layer."""

    tp_ffn = None  # the FFN pair's tp group when it is sharded

    def __init__(self, config: ViTTowerConfig, dtype: torch.dtype):
        super().__init__()
        c, d = config, dtype
        self.act = act_fn(c.hidden_act)
        self.layernorm_before = LayerNorm(c.hidden_size, c.layer_norm_eps, d)
        self.attention = SelfAttention(
            c.hidden_size, c.num_attention_heads, d, c.attention_probs_dropout_prob, c.use_pallas_attention
        )
        self.attention_output_dense = Dense(c.hidden_size, c.hidden_size, d)
        self.layernorm_after = LayerNorm(c.hidden_size, c.layer_norm_eps, d)
        self.intermediate_dense = Dense(c.hidden_size, c.intermediate_size, d)
        self.output_dense = Dense(c.intermediate_size, c.hidden_size, d)
        self.hidden_dropout = FastDropout(c.hidden_dropout_prob)

    def forward(self, hidden: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        attn = self.attention_output_dense(self.attention(self.layernorm_before(hidden), None, deterministic))
        # the remat policies' saveables (models/remat.py): identities outside remat
        hidden = checkpoint_name(hidden + self.hidden_dropout(checkpoint_name(attn, "attn_proj"), deterministic), "attn_out")
        mlp = checkpoint_name(self.act(self.intermediate_dense(tp_input(self.layernorm_after(hidden), self.tp_ffn))), "ffn_mid")
        return checkpoint_name(hidden + self.hidden_dropout(self.output_dense(mlp), deterministic), "ffn_out")


class ViTEmbeddings(nn.Module):
    """Patch projection (a stride-``patch_size`` convolution), CLS token and
    learned position embeddings."""

    def __init__(self, config: ViTTowerConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.patch_embeddings = nn.Conv2d(
            c.num_channels, c.hidden_size, kernel_size=c.patch_size,
            stride=c.patch_size, bias=c.patch_bias,
        )
        if c.embeddings_layernorm:  # CLIP pre_layrnorm
            self.pre_layernorm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, c.hidden_size))
        self.position_embeddings = nn.Parameter(torch.empty(1, c.seq_len, c.hidden_size))
        self.dropout = FastDropout(c.hidden_dropout_prob)

    def forward(self, pixel_values: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        dt = self.dtype
        conv = self.patch_embeddings
        bias = None if conv.bias is None else conv.bias.to(dt)
        x = F.conv2d(pixel_values.to(dt), conv.weight.to(dt), bias, stride=conv.stride)
        x = x.flatten(2).transpose(1, 2)  # (I, patches, D), row-major patches
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embeddings.to(dt)
        if self.config.embeddings_layernorm:
            x = self.pre_layernorm(x)
        return self.dropout(x, deterministic)


class ViTPooler(nn.Module):
    """Dense + tanh on the CLS token. The reference forward never calls it,
    so ``MDTModel`` does not build one (the JAX model has no params for it
    either)."""

    def __init__(self, hidden_size: int, dtype: torch.dtype):
        super().__init__()
        self.dense = Dense(hidden_size, hidden_size, dtype)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))


class ViTBottomTower(nn.Module):
    """Embeddings + the bottom ``num_layers`` ViT layers + the final layer
    norm (see the module docstring)."""

    def __init__(self, config: ViTTowerConfig, num_layers: int, dtype: torch.dtype):
        super().__init__()
        self.embeddings = ViTEmbeddings(config, dtype)
        self.layers = []
        for i in range(num_layers):
            lyr = ViTLayer(config, dtype)
            self.add_module(f"layer_{i}", lyr)
            self.layers.append(lyr)
        self.layernorm = LayerNorm(config.hidden_size, config.layer_norm_eps, dtype)

    def forward(self, pixel_values: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        hidden = self.embeddings(pixel_values, deterministic)
        for lyr in self.layers:
            hidden = lyr(hidden, deterministic)
        return self.layernorm(hidden)
