"""Compact-bias tree attention, forward and backward, with in-kernel dropout.

The mDT graph attention bias decomposes as

    bias[b,h,i,j] = c * template[b,i,j] + LUT[ids[b,i,j], h]

where ``template`` is the collator's (B,S,S) 0/-inf mask (``c`` = 2 when the
reference's double-added bias is kept, else 1) and ``LUT`` merges the
spatial-bucket embedding column of head h with the graph-token virtual
distance: the +1-shifted Cantor bucket space is tiny (21 live ids), so the
graph-token row/column is one more id and the per-head bias is a 32-entry
lookup. The (B,H,S,S) bias never has to exist.

Training drops out the normalized probabilities with a keep mask that is a
pure function of (seed, graph, head, row, key): Philox4x32-10 keyed by the
64-bit seed with the counter (key // 4, row, head, graph), word key % 4,
kept where the bits are >= ``keep_threshold(rate)``. The denominator sums
the undropped terms. The backward regenerates the mask; it is never stored.

``tree_attention`` is the one entry point. On CPU tensors it runs the plain
PyTorch version ``tree_attention_dropout_reference`` (differentiable by
autograd). On CUDA tensors it runs ``TreeAttention``, an autograd Function
whose forward launches a hand-written forward kernel (saving the per-row
log-sum-exp) and whose backward launches a pair of hand-written backward
kernels: dq with the LUT gradient (and the per-row g . out), then dk and
dv. It does so for rate 0 too, so evaluation and training share one path.
One predicate, ``kernel_route``, picks the kernels of both directions by
dtype, at every head dim of ``_HEAD_DIMS`` (16, 32, 64, 128):
- "tensor_core": bf16, every graph layer of the model (DH 64 at
  ``ModelConfig()``, DH 128 and 32 with 6 and 24 heads), at any S. The
  forward is ``csrc/tree_attention_fwd_mma.cu`` and the backward pair
  ``csrc/tree_attention_bwd_mma.cu``, all on mma.sync with bf16 operands,
  streaming over S in tiles;
- "tf32": float32 (the card-vs-CPU steps, the tiny configs). The forward is
  ``csrc/tree_attention_fwd_tf32.cu`` and the backward pair
  ``csrc/tree_attention_bwd_tf32.cu``, every product on mma.sync in 3xTF32
  (each operand split into two TF32 parts, the three larger cross products
  summed in f32), which holds the float32 tolerances that one TF32 or bf16
  product would break.
Every forward computes one function, draws one dropout mask and writes one
LSE, and every backward pair reads it, so any forward feeds any pair.
The kernels are built and bound by ``ops/cuda_lib.py`` at their first use;
on a CUDA tensor the wrapper launches them or raises.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from multimodaldiscussiontransformer_tpu_torch.ops import cuda_lib

MASK_BIAS = -1e9
LUT_SIZE = 32  # >= 1 (pad) + 21 cantor buckets + 1 graph-token id
GRAPH_TOKEN_ID = LUT_SIZE - 1  # id of the virtual-distance entry

_HEAD_DIMS = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Philox4x32-10 constants (Random123)
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def build_compact_bias_inputs(
    attn_bias_template: torch.Tensor,  # (B, S, S) collator template, S = N+1
    spatial_pos: torch.Tensor,  # (B, N, N) +1-shifted bucket ids
    spatial_table: torch.Tensor,  # (num_spatial, H) learned embedding
    virtual_t: torch.Tensor,  # (1, H) graph-token virtual distance
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(template f32 (B,S,S), ids int32 (B,S,S), lut f32 (LUT_SIZE, H)).

    ids[:, 1:, 1:] = spatial_pos; the graph-token row and column hold
    GRAPH_TOKEN_ID; lut[0] = 0 (padding), lut[k] = spatial row k,
    lut[GRAPH_TOKEN_ID] = the virtual distance."""
    b, n, _ = spatial_pos.shape
    s = n + 1
    dev = spatial_pos.device
    ids = torch.full((b, s, s), GRAPH_TOKEN_ID, dtype=torch.int32, device=dev)
    ids[:, 1:, 1:] = spatial_pos.to(torch.int32)
    return attn_bias_template.float().contiguous(), ids, compact_lut(spatial_table, virtual_t)


def compact_lut(spatial_table: torch.Tensor, virtual_t: torch.Tensor) -> torch.Tensor:
    """The f32 (LUT_SIZE, H) LUT: row 0 zero (padding), rows 1 .. 30 the
    spatial table's, row GRAPH_TOKEN_ID the virtual distance."""
    lut = torch.zeros(LUT_SIZE, spatial_table.shape[1], dtype=torch.float32, device=spatial_table.device)
    lut[1 : LUT_SIZE - 1] = spatial_table[1 : LUT_SIZE - 1].float()
    lut[GRAPH_TOKEN_ID] = virtual_t[0].float()
    return lut


def assemble_bias(template, ids, lut, double_add: bool) -> torch.Tensor:
    """The dense (B, H, S, S) f32 bias the kernel builds on the fly: ids 0
    and ids outside [0, LUT_SIZE) add nothing, the template is clamped at
    MASK_BIAS."""
    t = template.float().clamp_min(MASK_BIAS)
    valid = (ids > 0) & (ids < LUT_SIZE)
    gathered = lut.float()[ids.long().clamp(0, LUT_SIZE - 1)]  # (B, S, S, H)
    gathered = torch.where(valid[..., None], gathered, 0.0)
    return gathered.permute(0, 3, 1, 2) + (2.0 if double_add else 1.0) * t[:, None]


# ---------------------------------------------------------------------------
# dropout bits: the plain version of csrc/tree_attention_common.cuh
# ---------------------------------------------------------------------------


def keep_threshold(rate: float) -> int:
    """Bits >= this are kept: min(floor(rate * 2^32), 2^32 - 1)."""
    return min(int(rate * 2**32), 2**32 - 1)


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of a * b for a 32-bit constant ``a`` and
    int64 ``b`` in [0, 2^32). The full product overflows int64, so ``b`` is
    split into 16-bit halves: every partial product stays below 2^49."""
    lo_part = a * (b & 0xFFFF)
    hi_part = a * (b >> 16)
    hi = (hi_part + (lo_part >> 16)) >> 16
    lo = (((hi_part & 0xFFFF) << 16) + lo_part) & _MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, key: int):
    """Philox4x32-10 on int64 tensors holding 32-bit counter words (they
    broadcast against each other), keyed by the 64-bit ``key``. Returns the
    four 32-bit output words as int64 tensors."""
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_keep_mask(seed: int, b: int, h: int, s: int, rate: float, device="cpu") -> torch.Tensor:
    """The (b, h, s, s) bool keep mask the kernels use for ``seed``."""
    groups = -(-s // 4)

    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)

    c0, c1, c2, c3 = (axis(groups, 3), axis(s, 2), axis(h, 1), axis(b, 0))
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    words = torch.stack(philox4x32(c0, c1, c2, c3, int(seed)), dim=-1)  # (b, h, s, groups, 4)
    bits = words.reshape(b, h, s, 4 * groups)[..., :s]
    return bits >= keep_threshold(rate)


def tree_attention_dropout_reference(
    q, k, v, template, ids, lut, seed: int = 0, rate: float = 0.0,
    scale: Optional[float] = None, double_add: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of the kernels' function, in f32, differentiable
    by autograd: the row max starts at MASK_BIAS and the denominator (the
    undropped sum) is clamped at 1e-30, so a row whose every key is masked
    gives zeros, as the kernels do."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    bias = assemble_bias(template, ids, lut, double_add)
    return dropped_softmax_attention(q, k, v, bias, seed, rate, scale)


def dropped_softmax_attention(q, k, v, bias, seed: int, rate: float, scale: float) -> torch.Tensor:
    """``softmax(scale q k^T + bias)`` with the Philox keep mask of ``seed``
    on the probabilities (kept terms over 1 - rate), times v: the arithmetic
    every attention kernel of the port shares, in f32, returned in q's
    dtype. ``bias`` broadcasts to (B, H, S, S)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float()) + bias
    # the max cancels in the quotient; detaching it keeps ties out of autograd
    m = scores.detach().amax(dim=-1, keepdim=True).clamp_min(MASK_BIAS)
    e = torch.exp(scores - m)
    denom = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if rate > 0.0:
        b, h, s, _ = q.shape
        e = torch.where(dropout_keep_mask(seed, b, h, s, rate, q.device), e, 0.0)
        denom = denom * (1.0 - rate)
    out = torch.einsum("bhqk,bhkd->bhqd", e, v.float()) / denom
    return out.to(q.dtype)


def tree_attention_reference(
    q, k, v, template, ids, lut, scale: Optional[float] = None, double_add: bool = True
) -> torch.Tensor:
    """The plain version at rate 0."""
    return tree_attention_dropout_reference(q, k, v, template, ids, lut, 0, 0.0, scale, double_add)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_count_lock = threading.Lock()


def check_kernel_inputs(kernel: str, q, like_q: dict, per_row: dict, others: dict) -> None:
    """What every attention kernel of the port takes: f32 or bf16 q and
    ``like_q`` (k, v, g, out) of one (B, H, S, DH) shape with DH in
    _HEAD_DIMS; f32 per-row tensors ``per_row`` {name: (tensor, shape)}; all
    of them and ``others`` contiguous and on q's device; B and H within the
    grid's limits."""
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{kernel} kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, DH), got {tuple(q.shape)}")
    b, h, s, dh = q.shape
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {_HEAD_DIMS}")
    for name, t in like_q.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} must share q's shape {tuple(q.shape)}, got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must share q's dtype {q.dtype}, got {t.dtype}")
    for name, (t, shape) in per_row.items():
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}")
    tensors = {"q": q, **like_q, **{n: t for n, (t, _) in per_row.items()}, **others}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b > 65535 or h > 65535:
        raise ValueError(f"grid too large: B={b}, H={h}")


def _check_cuda_inputs(q, k, v, template, ids, lut, **extra) -> None:
    """What the kernels take: f32 or bf16 q/k/v (and g/out) of one (B, H, S,
    DH) shape with DH in (16, 32, 64, 128), f32 template and int32 ids of
    (B, S, S), an f32 (32, H) LUT, f32 (B, H, S) lse/delta; all contiguous
    and on one device."""
    if q.dim() == 4:
        b, h, s, _ = q.shape
        if template.shape != (b, s, s) or template.dtype != torch.float32:
            raise ValueError(f"template must be float32 {(b, s, s)}, got {template.dtype} {tuple(template.shape)}")
        if ids.shape != (b, s, s) or ids.dtype != torch.int32:
            raise ValueError(f"ids must be int32 {(b, s, s)}, got {ids.dtype} {tuple(ids.shape)}")
        if lut.shape != (LUT_SIZE, h) or lut.dtype != torch.float32:
            raise ValueError(f"lut must be float32 {(LUT_SIZE, h)}, got {lut.dtype} {tuple(lut.shape)}")
    check_kernel_inputs(
        "tree_attention", q,
        {"k": k, "v": v, **{n: t for n, t in extra.items() if n in ("g", "out")}},
        {n: (t, q.shape[:3]) for n, t in extra.items() if n in ("lse", "delta")},
        {"template": template, "ids": ids, "lut": lut},
    )


def check_rate(rate: float, seed) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("attention dropout needs a seed")
    if seed is not None and not 0 <= int(seed) < 2**64:
        raise ValueError(f"seed must be in [0, 2^64), got {seed}")


def dropout_args(seed: int, rate: float):
    seed = int(seed)
    return seed & _MASK32, (seed >> 32) & _MASK32, keep_threshold(rate), 1.0 / (1.0 - rate)


def count_launch(fn) -> None:
    """Add one to ``fn.launches`` (wrappers call it right after a launch)."""
    with _count_lock:
        fn.launches += 1


def _launch_forward(wrapper, entry: Tuple[str, str], q, k, v, template, ids, lut, scale, double_add, rate, seed,
                    with_lse):
    """Allocate out (and the LSE), launch the forward ``entry`` (library, C
    function; both forwards take one signature) and count the launch on
    ``wrapper``."""
    b, h, s, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return out, lse
    cuda_lib.launch(
        *entry, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), template.data_ptr(), ids.data_ptr(),
        lut.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, h, s, dh, float(scale), 2.0 if double_add else 1.0, *dropout_args(seed, rate), DTYPE_CODES[q.dtype],
    )
    count_launch(wrapper)
    return out, lse


# the tensor-core kernels take this, the 3xTF32 forward and backward pair
# that, each at every DH of _HEAD_DIMS; see ``kernel_route``
TENSOR_CORE_DTYPE = torch.bfloat16
TF32_DTYPE = torch.float32


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernels the CUDA path launches, in both directions, for q of
    this dtype and head dim (any S):
    - "tensor_core" for bf16: ``tree_attention_fwd_fused``, then
      ``tree_attention_bwd_dq_fused`` and ``tree_attention_bwd_dkv_fused``;
    - "tf32" for float32: ``tree_attention_fwd_tf32``, then
      ``tree_attention_bwd_dq_tf32`` and ``tree_attention_bwd_dkv_tf32``
      (3xTF32 on tensor cores).
    Both take every DH of _HEAD_DIMS; another dtype or head dim raises. A
    choice between kernels, not a fallback: each raises if it fails."""
    if dtype not in (TENSOR_CORE_DTYPE, TF32_DTYPE):
        raise TypeError(f"the tree attention kernels take float32 or bfloat16, got {dtype}")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not in {_HEAD_DIMS}")
    return "tf32" if dtype == TF32_DTYPE else "tensor_core"


def _check_tensor_core_inputs(kernel: str, q, *tensors, route: str = "tensor_core") -> None:
    """What the tensor-core kernels take besides ``_check_cuda_inputs``: the
    dtype of their ``route``, q and ``tensors`` (k, v and g, out) 16-byte
    aligned for their 16-byte copies, and CUDA tensors."""
    dh = q.shape[-1]
    name, takes = ("3xTF32", TF32_DTYPE) if route == "tf32" else ("tensor-core", TENSOR_CORE_DTYPE)
    if kernel_route(q.dtype, dh) != route:
        raise ValueError(f"the {name} tree {kernel} takes {takes}, got {q.dtype} DH={dh}")
    if any(t.data_ptr() % 16 for t in (q, *tensors)):
        raise ValueError(f"the {name} tree {kernel} takes 16-byte aligned q, k, v (and g, out)")
    if q.device.type != "cuda":
        raise ValueError(f"the {name} tree {kernel} runs on cuda, not {q.device}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the tensor-core kernels'
    16-byte copies): itself, or a copy of the same values."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def tree_attention_fwd_fused(
    q, k, v, template, ids, lut, scale: float, double_add: bool = True,
    rate: float = 0.0, seed: int = 0, with_lse: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the tensor-core forward kernel: (out, lse or None; the LSE
    f32 (B, H, S) when ``with_lse``). Takes bf16 CUDA tensors at any DH of
    _HEAD_DIMS (the "tensor_core" route), with q, k and v 16-byte aligned
    for the kernel's 16-byte copies. ``launches`` counts launches."""
    _check_cuda_inputs(q, k, v, template, ids, lut)
    _check_tensor_core_inputs("forward", q, k, v)
    return _launch_forward(tree_attention_fwd_fused, ("tree_fwd_mma", "tree_attention_fwd_mma"), q, k, v, template, ids,
                           lut, scale, double_add, rate, seed, with_lse)


def tree_attention_fwd_tf32(
    q, k, v, template, ids, lut, scale: float, double_add: bool = True,
    rate: float = 0.0, seed: int = 0, with_lse: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the 3xTF32 forward kernel: (out, lse or None), as
    ``tree_attention_fwd_fused`` returns them. Takes float32 CUDA tensors (the
    "tf32" route, any DH of _HEAD_DIMS), with q, k and v 16-byte aligned."""
    _check_cuda_inputs(q, k, v, template, ids, lut)
    _check_tensor_core_inputs("forward", q, k, v, route="tf32")
    return _launch_forward(tree_attention_fwd_tf32, ("tree_fwd_tf32", "tree_attention_fwd_tf32"), q, k, v, template,
                           ids, lut, scale, double_add, rate, seed, with_lse)


def _launch_dq(wrapper, entry: Tuple[str, str], q, k, v, out, g, template, ids, lut, lse, scale, double_add, rate,
               seed):
    """Allocate dq, dlut and delta, launch the dq kernel ``entry`` (library,
    C function; both pairs take one signature) and count the launch on
    ``wrapper``."""
    b, h, s, dh = q.shape
    dq = torch.empty_like(q)
    dlut = torch.zeros(LUT_SIZE, h, dtype=torch.float32, device=q.device)
    delta = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, dlut, delta
    cuda_lib.launch(
        *entry, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
        template.data_ptr(), ids.data_ptr(), lut.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dlut.data_ptr(), delta.data_ptr(),
        b, h, s, dh, float(scale), 2.0 if double_add else 1.0, *dropout_args(seed, rate), DTYPE_CODES[q.dtype],
    )
    count_launch(wrapper)
    return dq, dlut, delta


def _launch_dkv(wrapper, entry: Tuple[str, str], q, k, v, g, template, ids, lut, lse, delta, scale, double_add, rate,
                seed):
    """Allocate dk and dv, launch the dk/dv kernel ``entry`` and count the
    launch on ``wrapper``."""
    b, h, s, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    cuda_lib.launch(
        *entry, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), template.data_ptr(),
        ids.data_ptr(), lut.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        b, h, s, dh, float(scale), 2.0 if double_add else 1.0, *dropout_args(seed, rate), DTYPE_CODES[q.dtype],
    )
    count_launch(wrapper)
    return dk, dv


def tree_attention_bwd_dq_fused(
    q, k, v, out, g, template, ids, lut, lse, scale: float, double_add: bool = True,
    rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the tensor-core q-major backward kernel: (dq, dlut f32 (32,
    H), delta f32 (B, H, S), the per-row g . out that
    ``tree_attention_bwd_dkv_fused`` takes), from the LSE of either forward.
    Takes bf16 CUDA tensors at any DH of _HEAD_DIMS (the "tensor_core"
    route), with q, k, v, g and out 16-byte aligned."""
    _check_cuda_inputs(q, k, v, template, ids, lut, out=out, g=g, lse=lse)
    _check_tensor_core_inputs("backward", q, k, v, g, out)
    return _launch_dq(tree_attention_bwd_dq_fused, ("tree_bwd_mma", "tree_attention_bwd_dq_mma"), q, k, v, out, g,
                      template, ids, lut, lse, scale, double_add, rate, seed)


def tree_attention_bwd_dkv_fused(
    q, k, v, g, template, ids, lut, lse, delta, scale: float, double_add: bool = True,
    rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the tensor-core k-major backward kernel: (dk, dv), from the
    ``delta`` of either dq kernel. The input rules of
    ``tree_attention_bwd_dq_fused`` (q, k, v and g 16-byte aligned)."""
    _check_cuda_inputs(q, k, v, template, ids, lut, g=g, lse=lse, delta=delta)
    _check_tensor_core_inputs("backward", q, k, v, g)
    return _launch_dkv(tree_attention_bwd_dkv_fused, ("tree_bwd_mma", "tree_attention_bwd_dkv_mma"), q, k, v, g,
                       template, ids, lut, lse, delta, scale, double_add, rate, seed)


def tree_attention_bwd_dq_tf32(
    q, k, v, out, g, template, ids, lut, lse, scale: float, double_add: bool = True,
    rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the 3xTF32 q-major backward kernel: (dq, dlut, delta), as
    ``tree_attention_bwd_dq_fused`` returns them, from the LSE of either forward.
    Takes float32 CUDA tensors (the "tf32" route, any DH of _HEAD_DIMS),
    with q, k, v, g and out 16-byte aligned."""
    _check_cuda_inputs(q, k, v, template, ids, lut, out=out, g=g, lse=lse)
    _check_tensor_core_inputs("backward", q, k, v, g, out, route="tf32")
    return _launch_dq(tree_attention_bwd_dq_tf32, ("tree_bwd_tf32", "tree_attention_bwd_dq_tf32"), q, k, v, out, g,
                      template, ids, lut, lse, scale, double_add, rate, seed)


def tree_attention_bwd_dkv_tf32(
    q, k, v, g, template, ids, lut, lse, delta, scale: float, double_add: bool = True,
    rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the 3xTF32 k-major backward kernel: (dk, dv), from the
    ``delta`` of any dq kernel. The input rules of
    ``tree_attention_bwd_dq_tf32`` (q, k, v and g 16-byte aligned)."""
    _check_cuda_inputs(q, k, v, template, ids, lut, g=g, lse=lse, delta=delta)
    _check_tensor_core_inputs("backward", q, k, v, g, route="tf32")
    return _launch_dkv(tree_attention_bwd_dkv_tf32, ("tree_bwd_tf32", "tree_attention_bwd_dkv_tf32"), q, k, v, g,
                       template, ids, lut, lse, delta, scale, double_add, rate, seed)


KERNELS = (tree_attention_fwd_fused, tree_attention_bwd_dq_fused, tree_attention_bwd_dkv_fused,
           tree_attention_bwd_dq_tf32, tree_attention_bwd_dkv_tf32, tree_attention_fwd_tf32)
for _fn in KERNELS:
    _fn.launches = 0


class TreeAttention(torch.autograd.Function):
    """The kernels as one differentiable op. Both directions take the
    kernels ``kernel_route`` names. The forward saves the output and the
    per-row log-sum-exp when a gradient is wanted; the backward regenerates
    the dropout mask from the seed."""

    @staticmethod
    def forward(ctx, q, k, v, template, ids, lut, seed: int, rate: float, scale: float, double_add: bool):
        need = any(ctx.needs_input_grad[i] for i in (0, 1, 2, 5))
        # both forwards copy in 16-byte pieces: a view off a 16-byte
        # boundary goes as an aligned copy (and is saved as one)
        q, k, v = (aligned16(x) for x in (q, k, v))
        fwd = tree_attention_fwd_tf32 if kernel_route(q.dtype, q.shape[-1]) == "tf32" else tree_attention_fwd_fused
        out, lse = fwd(q, k, v, template, ids, lut, scale, double_add, rate, seed, with_lse=need)
        if need:
            ctx.save_for_backward(q, k, v, template, ids, lut, out, lse)
            ctx.args = (scale, double_add, rate, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, template, ids, lut, out, lse = ctx.saved_tensors
        scale, double_add, rate, seed = ctx.args
        # so do both pairs: g goes as an aligned copy too
        g = aligned16(g)
        if kernel_route(q.dtype, q.shape[-1]) == "tf32":
            bwd_dq, bwd_dkv = tree_attention_bwd_dq_tf32, tree_attention_bwd_dkv_tf32
        else:
            bwd_dq, bwd_dkv = tree_attention_bwd_dq_fused, tree_attention_bwd_dkv_fused
        dq, dlut, delta = bwd_dq(q, k, v, out, g, template, ids, lut, lse, scale, double_add, rate, seed)
        dk, dv = bwd_dkv(q, k, v, g, template, ids, lut, lse, delta, scale, double_add, rate, seed)
        return dq, dk, dv, None, None, dlut if ctx.needs_input_grad[5] else None, None, None, None, None


def tree_attention(
    q: torch.Tensor,  # (B, H, S, DH)
    k: torch.Tensor,
    v: torch.Tensor,
    template: torch.Tensor,  # (B, S, S) f32
    ids: torch.Tensor,  # (B, S, S) int32
    lut: torch.Tensor,  # (LUT_SIZE, H) f32
    scale: Optional[float] = None,
    double_add: bool = True,
    rate: float = 0.0,
    seed: Optional[int] = None,
) -> torch.Tensor:
    """Compact-bias tree attention with attention dropout at ``rate`` (the
    mask keyed by ``seed``, an integer in [0, 2^64)): the CUDA kernels on
    CUDA tensors, the plain version on CPU tensors; other devices raise."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tree_attention runs on cpu or cuda, not {q.device}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    check_rate(rate, seed)
    seed = 0 if seed is None else int(seed)
    if q.device.type == "cpu":
        return tree_attention_dropout_reference(q, k, v, template, ids, lut, seed, rate, scale, double_add)
    return TreeAttention.apply(q, k, v, template, ids, lut, seed, float(rate), float(scale), double_add)
