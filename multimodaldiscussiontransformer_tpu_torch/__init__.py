"""PyTorch/CUDA port of the Multi-Modal Discussion Transformer.

A package of its own beside the JAX package ``multimodaldiscussiontransformer_tpu``,
with the same layout and names. It imports neither JAX nor the JAX package.
Its graph attention runs hand-written Hopper kernels (``csrc/tree_attention_*.cu``)
on CUDA tensors and a plain PyTorch version on CPU tensors.
"""
