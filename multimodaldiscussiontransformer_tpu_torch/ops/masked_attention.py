"""Tower attention with a per-key bias, forward and backward, with in-kernel
dropout: the port's counterpart of the JAX package's
``ops/masked_attention.py``.

The BERT and ViT tower layers compute ``softmax(q k^T * scale + key_bias)
@ v``, where the (B, S) key bias is 0 for real tokens and -1e9 for padding
(ViT has none). Training drops out the normalized probabilities with the
Philox keep mask of ``ops/tree_attention.py`` (counter (key // 4, row,
head, batch row), so ``tree_attention.dropout_keep_mask`` is the plain
mask of both); the denominator sums the undropped terms and kept terms are
divided by 1 - rate. The backward regenerates the mask; it is never stored.

``masked_attention`` is the one entry point. On CPU tensors it runs the
plain PyTorch version ``masked_attention_dropout_reference`` (differentiable
by autograd). On CUDA tensors it runs ``MaskedAttention``, an autograd
Function whose forward saves the output and the per-row softmax statistics
(the row max and the log of the row sum) only when an input wants a
gradient, so the frozen bottom towers save nothing. One predicate,
``kernel_route``, picks the kernels of both directions by dtype and shape,
so that the forward that writes the statistics and the backward that reads
them cannot drift apart:
- "tensor_core": bf16 at DH = 64 and S <= 256, every tower shape of the
  model. The forward is ``csrc/masked_attention_fwd_mma.cu`` and the
  backward ``csrc/masked_attention_bwd_mma.cu`` (dq, dk and dv in one
  pass), both on mma.sync with bf16 operands;
- "tf32": float32 at every DH and S (the card-vs-CPU steps, the tiny
  configs). The forward is ``csrc/masked_attention_fwd_tf32.cu`` and the
  backward the two kernels of ``csrc/masked_attention_bwd_tf32.cu`` (dq,
  then dk and dv), every product on mma.sync in 3xTF32 (each operand split
  into two TF32 parts, the three larger cross products summed in f32), which
  holds the float32 tolerances that bf16 rounding of p and ds would break;
- "tensor_core_tiled": bf16 at other DH and longer S (a text tower at 512
  positions, DH 16, 32, 128). The forward is
  ``csrc/masked_attention_fwd_tiled.cu`` and the backward the two kernels of
  ``csrc/masked_attention_bwd_tiled.cu`` (dq, then dk and dv), on mma.sync
  with bf16 operands, K and V (or Q and G) streamed in tiles, so shared
  memory does not grow with S.
The kernels are built and bound by ``ops/cuda_lib.py``; on a CUDA tensor
the wrapper launches them or raises.

A row whose every key is masked (a capacity-padding text row in the bottom
tower) gets equal weights over its S keys, on both paths.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib
from multimodaldiscussiontransformer_tpu_torch.ops.tree_attention import (
    DTYPE_CODES,
    MASK_BIAS,
    aligned16,
    check_kernel_inputs,
    check_rate,
    count_launch,
    dropout_args,
    dropped_softmax_attention,
)


def _key_bias_4d(key_mask_bias: Optional[torch.Tensor]):
    """(B, S) additive key bias -> (B, 1, 1, S) f32 clamped at MASK_BIAS, or
    0 without one."""
    if key_mask_bias is None:
        return 0.0
    return key_mask_bias.float().clamp_min(MASK_BIAS)[:, None, None, :]


def masked_attention_dropout_reference(
    q, k, v, key_mask_bias: Optional[torch.Tensor] = None, seed: int = 0, rate: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernels' function, in f32, differentiable
    by autograd: q is scaled in f32, the key bias clamped at MASK_BIAS, the
    row max clamped at MASK_BIAS, the (undropped) denominator at 1e-30;
    kept terms are divided by 1 - rate; the result is cast to q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return dropped_softmax_attention(q, k, v, _key_bias_4d(key_mask_bias), seed, rate, scale)


def masked_attention_reference(
    q, k, v, key_mask_bias: Optional[torch.Tensor] = None, scale: Optional[float] = None
) -> torch.Tensor:
    """The plain version at rate 0."""
    return masked_attention_dropout_reference(q, k, v, key_mask_bias, 0, 0.0, scale)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _check_cuda_inputs(q, k, v, key_bias, **extra) -> None:
    """What the kernels take: f32 or bf16 q/k/v (and g/out) of one (B, H, S,
    DH) shape with DH in (16, 32, 64, 128), an f32 (B, S) key bias or None,
    f32 (2, B, H, S) stats and (B, H, S) delta; all contiguous and on one
    device."""
    if key_bias is not None and q.dim() == 4:
        b, _, s, _ = q.shape
        if key_bias.shape != (b, s) or key_bias.dtype != torch.float32:
            raise ValueError(f"key bias must be float32 {(b, s)}, got {key_bias.dtype} {tuple(key_bias.shape)}")
    rows = q.shape[:3]
    shapes = {"stats": (2, *rows), "delta": rows}
    check_kernel_inputs(
        "masked_attention", q,
        {"k": k, "v": v, **{n: t for n, t in extra.items() if n in ("g", "out")}},
        {n: (t, shapes[n]) for n, t in extra.items() if n in shapes},
        {} if key_bias is None else {"key_bias": key_bias},
    )


# the tensor-core kernels (forward and one-pass backward) take these; see
# ``kernel_route``
TENSOR_CORE_DTYPE = torch.bfloat16
TENSOR_CORE_HEAD_DIM = 64
TENSOR_CORE_MAX_S = 256
# the 3xTF32 forward and backward pair take this, at every DH and S
TF32_DTYPE = torch.float32
# the tiled tensor-core forward and backward pair take this, at every DH and S
TILED_DTYPE = torch.bfloat16


def kernel_route(dtype: torch.dtype, head_dim: int, s: int) -> str:
    """Which kernels the CUDA path launches, in both directions, for q of
    this dtype, head dim and length:
    - "tensor_core" for bf16 at DH = 64 and S <= 256
      (``masked_attention_fwd_fused``, then ``masked_attention_bwd_fused``);
    - "tf32" for float32 (``masked_attention_fwd_tf32``, then
      ``masked_attention_bwd_dq_tf32`` and ``masked_attention_bwd_dkv_tf32``,
      3xTF32 on tensor cores, any DH and S);
    - "tensor_core_tiled" for bf16 at other DH or longer S
      (``masked_attention_fwd_tiled``, then ``masked_attention_bwd_dq_tiled``
      and ``masked_attention_bwd_dkv_tiled``, bf16 on tensor cores with K
      and V streamed in tiles).
    A choice between kernels, not a fallback: each raises if it fails."""
    if dtype == TF32_DTYPE:
        return "tf32"
    tensor_core = dtype == TENSOR_CORE_DTYPE and head_dim == TENSOR_CORE_HEAD_DIM and 1 <= s <= TENSOR_CORE_MAX_S
    return "tensor_core" if tensor_core else "tensor_core_tiled"


def _check_tensor_core_inputs(kernel: str, q, *tensors, route: str = "tensor_core") -> None:
    """What the tensor-core kernels take besides ``_check_cuda_inputs``: the
    dtype of their ``route`` (for "tensor_core" also its head dim and
    length; the tiled kernels take bf16 at every DH and S), CUDA tensors,
    and q, k, v (and g, out) 16-byte aligned for their 16-byte copies."""
    _, _, s, dh = q.shape
    if route == "tensor_core_tiled":
        ok, takes = q.dtype == TILED_DTYPE, f"{TILED_DTYPE}"
    else:
        ok = kernel_route(q.dtype, dh, s) == route
        takes = (f"{TF32_DTYPE}" if route == "tf32"
                 else f"{TENSOR_CORE_DTYPE} at DH={TENSOR_CORE_HEAD_DIM} and S <= {TENSOR_CORE_MAX_S}")
    if not ok:
        raise ValueError(f"the {kernel} takes {takes}, got {q.dtype} DH={dh} S={s}")
    if any(t.data_ptr() % 16 for t in (q, *tensors)):
        raise ValueError(f"the {kernel} takes 16-byte aligned q, k, v, g and out")
    if q.device.type != "cuda":
        raise ValueError(f"the {kernel} runs on cuda, not {q.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(wrapper, entry: Tuple[str, str], q, k, v, key_bias, scale, rate, seed, with_stats):
    """Allocate out (and the statistics when asked), launch the forward
    ``entry`` (library, C function; every forward takes one signature) and
    count the launch on ``wrapper``."""
    b, h, s, dh = q.shape
    out = torch.empty_like(q)
    stats = torch.empty(2, b, h, s, dtype=torch.float32, device=q.device) if with_stats else None
    if out.numel() == 0:
        return out, stats
    cuda_lib.launch(
        *entry, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_bias), out.data_ptr(), _ptr(stats),
        b, h, s, dh, float(scale), *dropout_args(seed, rate), DTYPE_CODES[q.dtype],
    )
    count_launch(wrapper)
    return out, stats


def masked_attention_fwd_fused(
    q, k, v, key_bias, scale: float, rate: float = 0.0, seed: int = 0, with_stats: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the tensor-core forward kernel: (out, stats or None), stats f32
    (2, B, H, S) holding each row's max and the log of its (undropped) sum,
    for the backward. Takes CUDA tensors that ``kernel_route`` sends to
    "tensor_core" only. ``launches`` counts launches, here and on every
    wrapper of ``KERNELS``."""
    _check_cuda_inputs(q, k, v, key_bias)
    _check_tensor_core_inputs("tensor-core forward", q, k, v)
    return _launch_fwd(masked_attention_fwd_fused, ("masked_fwd_mma", "masked_attention_fwd_mma"), q, k, v,
                       key_bias, scale, rate, seed, with_stats)


def masked_attention_fwd_tf32(
    q, k, v, key_bias, scale: float, rate: float = 0.0, seed: int = 0, with_stats: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the 3xTF32 forward kernel: (out, stats or None), as
    ``masked_attention_fwd_fused`` returns them. Takes float32 CUDA tensors
    (the "tf32" route, any DH and S), with q, k and v 16-byte aligned."""
    _check_cuda_inputs(q, k, v, key_bias)
    _check_tensor_core_inputs("3xTF32 forward", q, k, v, route="tf32")
    return _launch_fwd(masked_attention_fwd_tf32, ("masked_fwd_tf32", "masked_attention_fwd_tf32"), q, k, v,
                       key_bias, scale, rate, seed, with_stats)


def masked_attention_fwd_tiled(
    q, k, v, key_bias, scale: float, rate: float = 0.0, seed: int = 0, with_stats: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the tiled tensor-core forward kernel: (out, stats or None), as
    ``masked_attention_fwd_fused`` returns them. Takes bf16 CUDA tensors at
    any DH and S (the route sends it bf16 outside the one-pass kernel's
    range), with q, k and v 16-byte aligned."""
    _check_cuda_inputs(q, k, v, key_bias)
    _check_tensor_core_inputs("tiled tensor-core forward", q, k, v, route="tensor_core_tiled")
    return _launch_fwd(masked_attention_fwd_tiled, ("masked_fwd_tiled", "masked_attention_fwd_tiled"), q, k, v,
                       key_bias, scale, rate, seed, with_stats)


def _launch_dq(wrapper, entry: Tuple[str, str], q, k, v, out, g, key_bias, stats, scale, rate, seed):
    """Allocate dq and delta, launch the q-major ``entry`` (library, C
    function; both pairs take one signature) and count the launch on
    ``wrapper``."""
    b, h, s, dh = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, delta
    cuda_lib.launch(
        *entry, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(), _ptr(key_bias),
        stats.data_ptr(), dq.data_ptr(), delta.data_ptr(),
        b, h, s, dh, float(scale), *dropout_args(seed, rate), DTYPE_CODES[q.dtype],
    )
    count_launch(wrapper)
    return dq, delta


def _launch_dkv(wrapper, entry: Tuple[str, str], q, k, v, g, key_bias, stats, delta, scale, rate, seed):
    """Allocate dk and dv, launch the k-major ``entry`` and count the launch
    on ``wrapper``."""
    b, h, s, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    cuda_lib.launch(
        *entry, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), _ptr(key_bias), stats.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, s, dh, float(scale), *dropout_args(seed, rate), DTYPE_CODES[q.dtype],
    )
    count_launch(wrapper)
    return dk, dv


def masked_attention_bwd_dq_tf32(
    q, k, v, out, g, key_bias, stats, scale: float, rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the 3xTF32 q-major backward kernel: (dq, delta f32 (B, H, S),
    the per-row g . out that ``masked_attention_bwd_dkv_tf32`` takes). Takes
    float32 CUDA tensors (the "tf32" route, any DH and S), with q, k, v, out
    and g 16-byte aligned."""
    _check_cuda_inputs(q, k, v, key_bias, out=out, g=g, stats=stats)
    _check_tensor_core_inputs("3xTF32 backward", q, k, v, out, g, route="tf32")
    return _launch_dq(masked_attention_bwd_dq_tf32, ("masked_bwd_tf32", "masked_attention_bwd_dq_tf32"), q, k, v,
                      out, g, key_bias, stats, scale, rate, seed)


def masked_attention_bwd_dkv_tf32(
    q, k, v, g, key_bias, stats, delta, scale: float, rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the 3xTF32 k-major backward kernel: (dk, dv), from the delta
    of ``masked_attention_bwd_dq_tf32``. Takes float32 CUDA tensors, with q,
    k, v and g 16-byte aligned."""
    _check_cuda_inputs(q, k, v, key_bias, g=g, stats=stats, delta=delta)
    _check_tensor_core_inputs("3xTF32 backward", q, k, v, g, route="tf32")
    return _launch_dkv(masked_attention_bwd_dkv_tf32, ("masked_bwd_tf32", "masked_attention_bwd_dkv_tf32"), q, k,
                       v, g, key_bias, stats, delta, scale, rate, seed)


def masked_attention_bwd_dq_tiled(
    q, k, v, out, g, key_bias, stats, scale: float, rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the tiled tensor-core q-major backward kernel: (dq, delta f32
    (B, H, S), the per-row g . out that ``masked_attention_bwd_dkv_tiled``
    takes). Takes bf16 CUDA tensors at any DH and S, with q, k, v, out and g
    16-byte aligned, and the statistics of ``masked_attention_fwd_tiled``."""
    _check_cuda_inputs(q, k, v, key_bias, out=out, g=g, stats=stats)
    _check_tensor_core_inputs("tiled tensor-core backward", q, k, v, out, g, route="tensor_core_tiled")
    return _launch_dq(masked_attention_bwd_dq_tiled, ("masked_bwd_tiled", "masked_attention_bwd_dq_tiled"), q, k,
                      v, out, g, key_bias, stats, scale, rate, seed)


def masked_attention_bwd_dkv_tiled(
    q, k, v, g, key_bias, stats, delta, scale: float, rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the tiled tensor-core k-major backward kernel: (dk, dv), from
    the delta of ``masked_attention_bwd_dq_tiled``. Takes bf16 CUDA tensors,
    with q, k, v and g 16-byte aligned."""
    _check_cuda_inputs(q, k, v, key_bias, g=g, stats=stats, delta=delta)
    _check_tensor_core_inputs("tiled tensor-core backward", q, k, v, g, route="tensor_core_tiled")
    return _launch_dkv(masked_attention_bwd_dkv_tiled, ("masked_bwd_tiled", "masked_attention_bwd_dkv_tiled"), q,
                       k, v, g, key_bias, stats, delta, scale, rate, seed)


def masked_attention_bwd_fused(
    q, k, v, out, g, key_bias, stats, scale: float, rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the one-pass tensor-core backward kernel: (dq, dk, dv). Takes
    CUDA tensors that ``kernel_route`` sends to "tensor_core" only."""
    _check_cuda_inputs(q, k, v, key_bias, out=out, g=g, stats=stats)
    _check_tensor_core_inputs("tensor-core backward", q, k, v, out, g)
    b, h, s, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk, dv
    cuda_lib.launch(
        "masked_bwd_mma", "masked_attention_bwd_mma", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(), _ptr(key_bias),
        stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, s, dh, float(scale), *dropout_args(seed, rate), DTYPE_CODES[q.dtype],
    )
    count_launch(masked_attention_bwd_fused)
    return dq, dk, dv


KERNELS = (
    masked_attention_bwd_fused, masked_attention_fwd_fused, masked_attention_fwd_tf32, masked_attention_bwd_dq_tf32,
    masked_attention_bwd_dkv_tf32, masked_attention_fwd_tiled, masked_attention_bwd_dq_tiled,
    masked_attention_bwd_dkv_tiled,
)
for _fn in KERNELS:
    _fn.launches = 0


class MaskedAttention(torch.autograd.Function):
    """The kernels as one differentiable op. Both directions take the
    kernels ``kernel_route`` names. The forward asks for the per-row softmax
    statistics, and saves its inputs, the output and the statistics, only
    when q, k or v wants a gradient; the backward regenerates the dropout
    mask from the seed. The key bias gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, seed: int, rate: float, scale: float):
        need = any(ctx.needs_input_grad[:3])
        route = kernel_route(q.dtype, q.shape[-1], q.shape[2])
        if route != "tensor_core":
            # the 3xTF32 and tiled forwards copy in 16-byte pieces: a view
            # off a 16-byte boundary goes as an aligned copy (and is saved as one)
            q, k, v = (aligned16(x) for x in (q, k, v))
        fwd = {"tensor_core": masked_attention_fwd_fused, "tf32": masked_attention_fwd_tf32,
               "tensor_core_tiled": masked_attention_fwd_tiled}[route]
        out, stats = fwd(q, k, v, key_bias, scale, rate, seed, with_stats=need)
        if need:
            ctx.save_for_backward(q, k, v, key_bias, out, stats)
            ctx.args = (scale, rate, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias, out, stats = ctx.saved_tensors
        scale, rate, seed = ctx.args
        g = g.contiguous()
        route = kernel_route(q.dtype, q.shape[-1], q.shape[2])
        if route == "tensor_core":
            dq, dk, dv = masked_attention_bwd_fused(q, k, v, out, g, key_bias, stats, scale, rate, seed)
            return dq, dk, dv, None, None, None, None
        # the 3xTF32 and tiled pairs copy in 16-byte pieces: a cotangent (or
        # an output) off a 16-byte boundary goes as an aligned copy
        g, out = aligned16(g), aligned16(out)
        bwd_dq, bwd_dkv = {"tf32": (masked_attention_bwd_dq_tf32, masked_attention_bwd_dkv_tf32),
                           "tensor_core_tiled": (masked_attention_bwd_dq_tiled, masked_attention_bwd_dkv_tiled)}[route]
        dq, delta = bwd_dq(q, k, v, out, g, key_bias, stats, scale, rate, seed)
        dk, dv = bwd_dkv(q, k, v, g, key_bias, stats, delta, scale, rate, seed)
        return dq, dk, dv, None, None, None, None


def masked_attention(
    q: torch.Tensor,  # (B, H, S, DH)
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask_bias: Optional[torch.Tensor] = None,  # (B, S) additive f32
    seed: Optional[int] = None,
    rate: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Tower attention with attention dropout at ``rate`` (the mask keyed by
    ``seed``, an integer in [0, 2^64)): the CUDA kernels on CUDA tensors,
    the plain version on CPU tensors; other devices raise."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked_attention runs on cpu or cuda, not {q.device}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    check_rate(rate, seed)
    seed = 0 if seed is None else int(seed)
    if q.device.type == "cpu":
        return masked_attention_dropout_reference(q, k, v, key_mask_bias, seed, rate, scale)
    return MaskedAttention.apply(q, k, v, key_mask_bias, seed, float(rate), float(scale))
