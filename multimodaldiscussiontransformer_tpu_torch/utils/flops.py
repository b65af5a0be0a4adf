"""Analytic FLOPs of the canonical mDT training and inference step: the
port's copy of the JAX package's ``utils/flops.py``, with the H100's peak.

1 multiply-add = 2 FLOPs; only matmul and conv terms are counted. Every slot
of the static capacity buffers (``node_capacity`` text slots,
``image_capacity`` image slots) runs through its tower whatever its padding.
Backward = 2x forward over the trainable region only: with
``freeze_initial_encoders`` autograd does not run through the bottom towers.
"""

from __future__ import annotations

from typing import Dict

from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig

# NVIDIA H100 SXM, dense bf16 tensor-core peak at 700 W (data sheet)
H100_BF16_PEAK_FLOPS = 989e12


def transformer_layer_flops(seq: int, d: int, ffn: int) -> float:
    """Forward matmul FLOPs of one transformer encoder layer: QKV and output
    projections, QK^T and AV, and the two-matmul FFN."""
    return 8.0 * seq * d * d + 4.0 * seq * seq * d + 4.0 * seq * d * ffn


def train_step_flops(
    cfg: ModelConfig, *, batch: int, node_capacity: int, image_capacity: int, seq_len: int, max_nodes: int
) -> Dict[str, float]:
    """FLOPs of one microbatch at static capacities: fwd, bwd, remat,
    train_total, infer_total."""
    t = cfg.text_tower
    v = cfg.image_tower
    nb = cfg.num_bottleneck_tokens
    n_fusion = cfg.num_fusion_layers + 1
    text_bottom = node_capacity * cfg.num_bottom_text_layers * transformer_layer_flops(seq_len, t.hidden_size, t.intermediate_size)
    text_fusion = node_capacity * n_fusion * transformer_layer_flops(seq_len + nb, t.hidden_size, t.intermediate_size)
    if cfg.use_image_tower:
        patch_embed = 2.0 * image_capacity * v.num_patches * v.hidden_size * (v.num_channels * v.patch_size * v.patch_size)
        vit_bottom = image_capacity * cfg.num_bottom_image_layers * transformer_layer_flops(v.seq_len, v.hidden_size, v.intermediate_size)
        vit_fusion = image_capacity * n_fusion * transformer_layer_flops(v.seq_len + nb, v.hidden_size, v.intermediate_size)
    else:
        patch_embed = vit_bottom = vit_fusion = 0.0
    # one constructed graph stack never runs under the reference's quirk
    live_stacks = cfg.num_graph_stacks - (1 if cfg.reproduce_dead_graph_stack else 0)
    graph = batch * live_stacks * cfg.num_graph_stack * transformer_layer_flops(
        max_nodes + 1, cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim
    )
    head = 2.0 * node_capacity * t.hidden_size * t.hidden_size + 2.0 * node_capacity * t.hidden_size * cfg.num_classes
    fwd = text_bottom + text_fusion + patch_embed + vit_bottom + vit_fusion + graph + head
    trainable_fwd = text_fusion + vit_fusion + graph + head if cfg.freeze_initial_encoders else fwd
    bwd = 2.0 * trainable_fwd
    remat = (text_fusion + vit_fusion + graph) if cfg.remat else 0.0
    return {"fwd": fwd, "bwd": bwd, "remat": remat, "train_total": fwd + bwd + remat, "infer_total": fwd}
