"""Kernels and their plain PyTorch versions."""

from multimodaldiscussiontransformer_tpu_torch.ops.biased_attention import (  # noqa: F401
    biased_attention,
    biased_attention_reference,
)
