"""Attention with a dense additive bias, the port's counterpart of the JAX
package's ``ops/biased_attention.py``.

The graph layer's dense-bias branch computes, per (batch row, head),

    combined = max(f32(bias) + (-1e9 where the key is padded), -1e9)
    s        = (f32(q) * scale) @ f32(k)^T + combined
    m        = max(rowmax(s), -1e9),   p = exp(s - m)
    out      = (p @ f32(v)) / max(sum(p), 1e-30), cast to q's dtype

where ``bias`` is a dense (B, H, S, S) or head-shared (B, 1, S, S) tensor
in float32 or bfloat16 that may hold -inf (the collator's template), or
None, and the key-padding mask is (B, S) bool with True = pad. That is the
Pallas kernel's function (``_fused_kernel`` with ``_combine_bias``).

``biased_attention`` is the one entry point. It runs ``BiasedAttention``,
an autograd Function whose forward runs the plain version
``biased_attention_reference`` on CPU tensors and launches one of three
kernels on CUDA tensors, chosen by ``kernel_route``:
- "tensor_core": bf16 at DH = 64, any S (every graph layer of the model),
  ``csrc/biased_attention_fwd_mma.cu`` on mma.sync with bf16 operands
  (``biased_attention_fwd_fused``), which rounds P to bf16 before P V;
- "tf32": float32 at every DH, any S (the card-vs-CPU steps),
  ``csrc/biased_attention_fwd_tf32.cu`` on mma.sync in 3xTF32
  (``biased_attention_fwd_tf32``: each operand split into two TF32 parts,
  the three larger cross products summed in f32, P kept in f32);
- "cuda_core": bf16 at DH 16, 32 and 128, ``csrc/biased_attention_fwd.cu``
  in f32 arithmetic (``biased_attention_fwd``).
A choice between kernels, not a fallback: each raises if it fails. All
three read the bias in its own dtype (float32 or bf16 with any q; head
stride 0 when shared) and the pad mask, and fold them in registers: the
combined bias is never materialized.
The Function's backward is the port of JAX's XLA backward
(``_bwd``): the probabilities are recomputed from the clamped combined bias
in float32 with torch ops, giving dq, dk, dv and a dbias of the bias's
shape and dtype (summed over heads for a shared bias); the pad mask gets no
gradient. CPU and card share that backward. On a CUDA tensor the wrapper
launches the kernel or raises.

A row whose every key is masked gets equal weights over its S keys, on both
paths. The kernel takes every S (JAX routes S > 2048 to its XLA reference).
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib
from multimodaldiscussiontransformer_tpu_torch.ops.tree_attention import (
    DTYPE_CODES,
    MASK_BIAS,
    aligned16,
    check_kernel_inputs,
    count_launch,
    dropped_softmax_attention,
)


def combined_bias(q: torch.Tensor, bias: Optional[torch.Tensor], key_padding_mask: Optional[torch.Tensor]):
    """The clamped f32 bias the kernel forms in registers: f32(bias) plus
    -1e9 on padded keys, clamped at MASK_BIAS; broadcastable to (B, H, S,
    S)."""
    comb = q.new_zeros((), dtype=torch.float32) if bias is None else bias.float()
    if key_padding_mask is not None:
        comb = comb + torch.where(key_padding_mask[:, None, None, :], MASK_BIAS, 0.0)
    return comb.clamp_min(MASK_BIAS)


def biased_attention_reference(
    q, k, v, bias: Optional[torch.Tensor] = None, key_padding_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function, step by step in f32,
    differentiable by autograd (into q, k, v and bias); the result is cast
    to q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return dropped_softmax_attention(q, k, v, combined_bias(q, bias, key_padding_mask), 0, 0.0, scale)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _check_cuda_inputs(q, k, v, bias, key_padding_mask) -> None:
    """What the kernel takes: f32 or bf16 q/k/v of one (B, H, S, DH) shape
    with DH in (16, 32, 64, 128); a bias of (B, H, S, S) or (B, 1, S, S) in
    f32 or bf16, or None; a (B, S) bool pad mask or None; all contiguous and
    on one device."""
    others = {}
    if q.dim() == 4:
        b, h, s, _ = q.shape
        if bias is not None:
            if bias.shape not in ((b, h, s, s), (b, 1, s, s)):
                raise ValueError(f"bias must be {(b, h, s, s)} or {(b, 1, s, s)}, got {tuple(bias.shape)}")
            if bias.dtype not in DTYPE_CODES:
                raise TypeError(f"bias must be float32 or bfloat16, got {bias.dtype}")
            others["bias"] = bias
        if key_padding_mask is not None:
            if key_padding_mask.shape != (b, s) or key_padding_mask.dtype != torch.bool:
                raise ValueError(f"key_padding_mask must be bool {(b, s)}, got {key_padding_mask.dtype} "
                                 f"{tuple(key_padding_mask.shape)}")
            others["key_padding_mask"] = key_padding_mask
    check_kernel_inputs("biased_attention", q, {"k": k, "v": v}, {}, others)


def _launch(wrapper, library: str, function: str, q, k, v, bias, key_padding_mask, scale: float) -> torch.Tensor:
    """Allocate out, launch ``function`` of ``library`` (both forwards take
    one signature) and count the launch on ``wrapper``."""
    b, h, s, dh = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    cuda_lib.launch(
        library, function, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if key_padding_mask is None else key_padding_mask.data_ptr(),
        out.data_ptr(), b, h, s, dh, 0 if bias is None else bias.shape[1], float(scale),
        DTYPE_CODES[q.dtype], DTYPE_CODES[torch.float32 if bias is None else bias.dtype],
    )
    count_launch(wrapper)
    return out


def biased_attention_fwd(q, k, v, bias, key_padding_mask, scale: float) -> torch.Tensor:
    """Launch the CUDA-core forward kernel, the "cuda_core" route's (it
    takes float32 and every DH of _HEAD_DIMS too). ``launches`` counts
    launches."""
    _check_cuda_inputs(q, k, v, bias, key_padding_mask)
    return _launch(biased_attention_fwd, "biased_fwd", "biased_attention_fwd", q, k, v, bias, key_padding_mask,
                   scale)


# the tensor-core kernel takes these, the 3xTF32 one float32 at every DH;
# see ``kernel_route``
TENSOR_CORE_DTYPE = torch.bfloat16
TENSOR_CORE_HEAD_DIM = 64
TF32_DTYPE = torch.float32


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which forward kernel the CUDA path launches for q of this dtype and
    head dim: "tensor_core" for bf16 at DH = 64 (``biased_attention_fwd_fused``,
    any S, either bias dtype), "tf32" for float32
    (``biased_attention_fwd_tf32``, 3xTF32 on tensor cores, any DH and S,
    either bias dtype), else "cuda_core" (``biased_attention_fwd``, f32
    arithmetic on CUDA cores). A choice between kernels, not a fallback:
    each raises if it fails."""
    if dtype == TF32_DTYPE:
        return "tf32"
    tensor_core = dtype == TENSOR_CORE_DTYPE and head_dim == TENSOR_CORE_HEAD_DIM
    return "tensor_core" if tensor_core else "cuda_core"


def _check_tensor_core_inputs(q, k, v, bias, key_padding_mask, route: str = "tensor_core") -> None:
    """What the tensor-core kernels take besides ``_check_cuda_inputs``: the
    dtype (and, for "tensor_core", the head dim) of their ``route``, CUDA
    tensors, and the tensors they copy in 16-byte pieces 16-byte aligned:
    q, k and v, and for "tensor_core" the bias and the pad mask too."""
    dh = q.shape[-1]
    kernel = "3xTF32 dense-bias forward" if route == "tf32" else "tensor-core dense-bias forward"
    if kernel_route(q.dtype, dh) != route:
        takes = f"{TF32_DTYPE}" if route == "tf32" else f"{TENSOR_CORE_DTYPE} at DH={TENSOR_CORE_HEAD_DIM}"
        raise ValueError(f"the {kernel} takes {takes}, got {q.dtype} DH={dh}")
    copied = (q, k, v) if route == "tf32" else (q, k, v, bias, key_padding_mask)
    if any(t is not None and t.data_ptr() % 16 for t in copied):
        names = "q, k and v" if route == "tf32" else "q, k, v, bias and key_padding_mask"
        raise ValueError(f"the {kernel} takes 16-byte aligned {names}")
    if q.device.type != "cuda":
        raise ValueError(f"the {kernel} runs on cuda, not {q.device}")


def biased_attention_fwd_fused(q, k, v, bias, key_padding_mask, scale: float) -> torch.Tensor:
    """Launch the tensor-core forward kernel: out, as ``biased_attention_fwd``
    returns it. Takes CUDA tensors that ``kernel_route`` sends to
    "tensor_core" only, all five 16-byte aligned."""
    _check_cuda_inputs(q, k, v, bias, key_padding_mask)
    _check_tensor_core_inputs(q, k, v, bias, key_padding_mask)
    return _launch(biased_attention_fwd_fused, "biased_fwd_mma", "biased_attention_fwd_mma", q, k, v, bias,
                   key_padding_mask, scale)


def biased_attention_fwd_tf32(q, k, v, bias, key_padding_mask, scale: float) -> torch.Tensor:
    """Launch the 3xTF32 forward kernel: out, as ``biased_attention_fwd``
    returns it. Takes float32 CUDA tensors (the "tf32" route, any DH and S)
    with q, k and v 16-byte aligned, and a float32 or bf16 bias."""
    _check_cuda_inputs(q, k, v, bias, key_padding_mask)
    _check_tensor_core_inputs(q, k, v, bias, key_padding_mask, route="tf32")
    return _launch(biased_attention_fwd_tf32, "biased_fwd_tf32", "biased_attention_fwd_tf32", q, k, v, bias,
                   key_padding_mask, scale)


KERNELS = (biased_attention_fwd, biased_attention_fwd_fused, biased_attention_fwd_tf32)
for _fn in KERNELS:
    _fn.launches = 0
FORWARDS = {"tensor_core": biased_attention_fwd_fused, "tf32": biased_attention_fwd_tf32,
            "cuda_core": biased_attention_fwd}


def routed_forward(q, k, v, bias, key_padding_mask, scale: float) -> torch.Tensor:
    """Launch the forward kernel ``kernel_route`` names for q. The 3xTF32
    forward copies q, k and v in 16-byte pieces: a view off a 16-byte
    boundary goes to it as an aligned copy."""
    route = kernel_route(q.dtype, q.shape[-1])
    if route == "tf32":
        q, k, v = (aligned16(x) for x in (q, k, v))
    return FORWARDS[route](q, k, v, bias, key_padding_mask, scale)


class BiasedAttention(torch.autograd.Function):
    """The routed forward kernel (the plain version on CPU tensors) with
    JAX's rematerialized backward: probabilities recomputed in f32 from the
    clamped combined bias."""

    @staticmethod
    def forward(ctx, q, k, v, bias, key_padding_mask, scale: float):
        if q.device.type == "cuda":
            out = routed_forward(q, k, v, bias, key_padding_mask, scale)
        else:
            out = biased_attention_reference(q, k, v, bias, key_padding_mask, scale)
        if any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(q, k, v, bias, key_padding_mask)
            ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, key_padding_mask = ctx.saved_tensors
        scale = ctx.scale
        qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
        scores = torch.matmul(qf * scale, kf.transpose(-1, -2)) + combined_bias(q, bias, key_padding_mask)
        p = torch.softmax(scores, dim=-1)
        dv = torch.matmul(p.transpose(-1, -2), gf)
        dp = torch.matmul(gf, vf.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq = torch.matmul(ds, kf) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
        dbias = None
        if bias is not None and ctx.needs_input_grad[3]:
            dbias = (ds.sum(dim=1, keepdim=True) if bias.shape[1] == 1 else ds).to(bias.dtype)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias, None, None


def biased_attention(
    q: torch.Tensor,  # (B, H, S, DH)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # (B, H|1, S, S) additive, may hold -inf
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, S) bool, True = pad
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Biased attention: the routed CUDA kernel on CUDA tensors, the plain
    version on CPU tensors, one backward for both; other devices raise."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"biased_attention runs on cpu or cuda, not {q.device}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return BiasedAttention.apply(q, k, v, bias, key_padding_mask, float(scale))
