"""Bottleneck-token fusion layers, and the fill/drop indexing they share with
the model.

Text states live in a fixed-capacity buffer (C, T, D) of flattened real
nodes, image states in (I, P+1, D). Each image slot names its node through
``image_node``; padded slots hold C, one past the end. ``gather_fill`` reads
zeros and ``scatter_drop`` writes nowhere for such an index, as JAX's
``.at[].get(mode="fill")`` and ``.at[].set(mode="drop")`` do. Plain torch
indexing would raise on them on the CPU and trip a device assert on CUDA.

Per layer:
1. text: BertLayer([bn, text]) with the extended mask (bn columns visible);
2. image nodes only: ViTLayer([bn gathered at the image nodes, patches]);
3. bottleneck update: the BERT half everywhere; at image nodes the average
   of the ViT and BERT halves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig
from multimodaldiscussiontransformer_tpu_torch.models.bert import BertLayer
from multimodaldiscussiontransformer_tpu_torch.models.vit import ViTLayer


def gather_fill(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along dim 0, zeros where idx is outside [0, len(table))."""
    n = table.shape[0]
    valid = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, max(n - 1, 0))]
    return torch.where(valid.view((-1,) + (1,) * (table.dim() - 1)), rows, 0.0)


def scatter_drop(table: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """A copy of ``table`` with rows ``idx`` set to ``values``; entries whose
    idx is outside [0, len(table)) are dropped (written to a trash row)."""
    n = table.shape[0]
    valid = (idx >= 0) & (idx < n)
    ext = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    ext.index_copy_(0, torch.where(valid, idx, n), values.to(table.dtype))
    return ext[:n]


class GraphFusionLayer(nn.Module):
    """One fusion step: a (BertLayer, ViTLayer) pair exchanging bottleneck
    tokens across the text and image modalities."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.config = config
        self.bert_encoder = BertLayer(config.text_tower, dtype)
        if config.use_image_tower:
            self.vit_encoder = ViTLayer(config.image_tower, dtype)

    def forward(
        self,
        bert_hidden: torch.Tensor,  # (C, T, D)
        vit_hidden: Optional[torch.Tensor],  # (I, P+1, D) or None
        bottle_neck: torch.Tensor,  # (C, nbn, D)
        bert_mask_bias: torch.Tensor,  # (C, 1, 1, nbn+T) additive
        image_node: Optional[torch.Tensor],  # (I,) -> [0, C); pad -> C
        deterministic: bool = True,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        nbn = self.config.num_bottleneck_tokens
        bert_out = self.bert_encoder(torch.cat([bottle_neck, bert_hidden], dim=1), bert_mask_bias, deterministic)
        bert_hidden_out, bn_out = bert_out[:, nbn:], bert_out[:, :nbn]

        if vit_hidden is None or not self.config.use_image_tower:
            return bert_hidden_out, vit_hidden, bn_out
        bn_img = gather_fill(bottle_neck, image_node)
        vit_out = self.vit_encoder(torch.cat([bn_img, vit_hidden], dim=1), deterministic)
        vit_hidden_out, vit_bn = vit_out[:, nbn:], vit_out[:, :nbn]
        # modality average at image nodes; a node has at most one image, so
        # the scatter writes each row once
        bert_bn_at_img = gather_fill(bn_out, image_node)
        bn_out = scatter_drop(bn_out, image_node, (vit_bn + bert_bn_at_img) / 2)
        return bert_hidden_out, vit_hidden_out, bn_out


class GraphFusionStack(nn.Module):
    """``num_layers`` chained fusion layers."""

    def __init__(self, config: ModelConfig, num_layers: int, dtype: torch.dtype):
        super().__init__()
        self.fusion_layers = []
        for i in range(num_layers):
            f = GraphFusionLayer(config, dtype)
            self.add_module(f"fusion_{i}", f)
            self.fusion_layers.append(f)

    def forward(self, bert_hidden, vit_hidden, bottle_neck, bert_mask_bias, image_node, deterministic: bool = True):
        for f in self.fusion_layers:
            bert_hidden, vit_hidden, bottle_neck = f(
                bert_hidden, vit_hidden, bottle_neck, bert_mask_bias, image_node, deterministic
            )
        return bert_hidden, vit_hidden, bottle_neck
