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
whose forward launches the hand-written kernel ``csrc/tree_attention_fwd.cu``
(saving the per-row log-sum-exp) and whose backward launches the two kernels
of ``csrc/tree_attention_bwd.cu``: dq with the LUT gradient, then dk and dv.
It does so for rate 0 too, so evaluation and training share one path. The
kernels are built with ``nvcc`` at their first use, into ``_build/`` next to
the package, and bound with ``ctypes``; on a CUDA tensor the wrapper
launches them or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

MASK_BIAS = -1e9
LUT_SIZE = 32  # >= 1 (pad) + 21 cantor buckets + 1 graph-token id
GRAPH_TOKEN_ID = LUT_SIZE - 1  # id of the virtual-distance entry

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
# one shared library per source, built in parallel
SOURCES = {"fwd": CSRC / "tree_attention_fwd.cu", "bwd": CSRC / "tree_attention_bwd.cu"}
HEADERS = (CSRC / "tree_attention_common.cuh",)
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

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
    lut = torch.zeros(LUT_SIZE, spatial_table.shape[1], dtype=torch.float32, device=dev)
    lut[1 : LUT_SIZE - 1] = spatial_table[1 : LUT_SIZE - 1].float()
    lut[GRAPH_TOKEN_ID] = virtual_t[0].float()
    return attn_bias_template.float().contiguous(), ids, lut


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

_libs: Optional[Dict[str, ctypes.CDLL]] = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def library_paths() -> Dict[str, Path]:
    """Where each kernel library lives: named by a hash of its source, the
    shared header and the flags (a changed source rebuilds)."""
    shared = b"".join(p.read_bytes() for p in HEADERS) + " ".join(NVCC_FLAGS).encode()
    return {
        name: BUILD_DIR / f"tree_attention_{name}-{hashlib.sha256(src.read_bytes() + shared).hexdigest()[:16]}.so"
        for name, src in SOURCES.items()
    }


def build() -> Dict[str, Path]:
    """Compile the kernel libraries under BUILD_DIR, one ``nvcc`` per source,
    all started together. The compiler is ``$NVCC``, else ``nvcc`` on PATH,
    else /usr/local/cuda/bin/nvcc. ptxas' resource report is kept beside
    each library as ``.log``."""
    paths = library_paths()
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = os.environ.get("NVCC") or shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    try:
        for name, path in todo.items():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs[name] = (proc, tmp, cmd)
        for name, (proc, tmp, cmd) in procs.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with code {proc.returncode}: {' '.join(cmd)}\n{stderr}")
            todo[name].with_suffix(".log").write_text(stdout + stderr)
            os.replace(tmp, todo[name])
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return paths


def load_library() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and bind the kernel libraries, once per process."""
    global _libs
    with _lib_lock:
        if _libs is None:
            paths = build()
            fwd, bwd = ctypes.CDLL(str(paths["fwd"])), ctypes.CDLL(str(paths["bwd"]))
            tail = [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_uint] * 3 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ]
            for fn, n_ptrs in ((fwd.tree_attention_fwd, 8), (bwd.tree_attention_bwd_dq, 12),
                               (bwd.tree_attention_bwd_dkv, 11)):
                fn.argtypes = [ctypes.c_void_p] * n_ptrs + tail
                fn.restype = ctypes.c_int
            for fn in (fwd.tree_attention_error_string, bwd.tree_attention_bwd_error_string):
                fn.argtypes = [ctypes.c_int]
                fn.restype = ctypes.c_char_p
            _libs = {"fwd": fwd, "bwd": bwd}
        return _libs


def _check_cuda_inputs(q, k, v, template, ids, lut, **extra) -> None:
    """What the kernels take: f32 or bf16 q/k/v (and g/out) of one (B, H, S,
    DH) shape with DH in (16, 32, 64, 128), f32 template and int32 ids of
    (B, S, S), an f32 (32, H) LUT, f32 (B, H, S) lse/delta; all contiguous
    and on one device."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"tree_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, DH), got {tuple(q.shape)}")
    b, h, s, dh = q.shape
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {_HEAD_DIMS}")
    if template.shape != (b, s, s) or template.dtype != torch.float32:
        raise ValueError(f"template must be float32 {(b, s, s)}, got {template.dtype} {tuple(template.shape)}")
    if ids.shape != (b, s, s) or ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32 {(b, s, s)}, got {ids.dtype} {tuple(ids.shape)}")
    if lut.shape != (LUT_SIZE, h) or lut.dtype != torch.float32:
        raise ValueError(f"lut must be float32 {(LUT_SIZE, h)}, got {lut.dtype} {tuple(lut.shape)}")
    like_q = {"k": k, "v": v, **{n: t for n, t in extra.items() if n in ("g", "out")}}
    for name, t in like_q.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} must share q's shape {tuple(q.shape)}, got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must share q's dtype {q.dtype}, got {t.dtype}")
    for name in ("lse", "delta"):
        if name in extra and (extra[name].shape != (b, h, s) or extra[name].dtype != torch.float32):
            raise ValueError(f"{name} must be float32 {(b, h, s)}")
    tensors = {"q": q, "template": template, "ids": ids, "lut": lut, **like_q, **extra}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b > 65535 or h > 65535:
        raise ValueError(f"grid too large: B={b}, H={h}")


def _check_rate(rate: float, seed) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("attention dropout needs a seed")
    if seed is not None and not 0 <= int(seed) < 2**64:
        raise ValueError(f"seed must be in [0, 2^64), got {seed}")


def _dropout_args(seed: int, rate: float):
    seed = int(seed)
    return seed & _MASK32, (seed >> 32) & _MASK32, keep_threshold(rate), 1.0 / (1.0 - rate)


def _raise_on(err: int, error_string, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {error_string(err).decode()} ({err})")


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def tree_attention_fwd(
    q, k, v, template, ids, lut, scale: float, double_add: bool = True,
    rate: float = 0.0, seed: int = 0, with_lse: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel: (out, lse or None). ``launches`` counts
    launches."""
    _check_cuda_inputs(q, k, v, template, ids, lut)
    b, h, s, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return out, lse
    lib = load_library()["fwd"]
    with torch.cuda.device(q.device):
        err = lib.tree_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), template.data_ptr(), ids.data_ptr(),
            lut.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, h, s, dh, float(scale), 2.0 if double_add else 1.0, *_dropout_args(seed, rate),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, lib.tree_attention_error_string, "tree_attention_fwd")
    _count(tree_attention_fwd)
    return out, lse


def tree_attention_bwd_dq(
    q, k, v, out, g, template, ids, lut, lse, scale: float, double_add: bool = True,
    rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the q-major backward kernel: (dq, dlut f32 (32, H), delta f32
    (B, H, S), the per-row g . out that ``tree_attention_bwd_dkv`` takes)."""
    _check_cuda_inputs(q, k, v, template, ids, lut, out=out, g=g, lse=lse)
    b, h, s, dh = q.shape
    dq = torch.empty_like(q)
    dlut = torch.zeros(LUT_SIZE, h, dtype=torch.float32, device=q.device)
    delta = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, dlut, delta
    lib = load_library()["bwd"]
    with torch.cuda.device(q.device):
        err = lib.tree_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            template.data_ptr(), ids.data_ptr(), lut.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dlut.data_ptr(), delta.data_ptr(),
            b, h, s, dh, float(scale), 2.0 if double_add else 1.0, *_dropout_args(seed, rate),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, lib.tree_attention_bwd_error_string, "tree_attention_bwd_dq")
    _count(tree_attention_bwd_dq)
    return dq, dlut, delta


def tree_attention_bwd_dkv(
    q, k, v, g, template, ids, lut, lse, delta, scale: float, double_add: bool = True,
    rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the k-major backward kernel: (dk, dv)."""
    _check_cuda_inputs(q, k, v, template, ids, lut, g=g, lse=lse, delta=delta)
    b, h, s, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    lib = load_library()["bwd"]
    with torch.cuda.device(q.device):
        err = lib.tree_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), template.data_ptr(),
            ids.data_ptr(), lut.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            b, h, s, dh, float(scale), 2.0 if double_add else 1.0, *_dropout_args(seed, rate),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, lib.tree_attention_bwd_error_string, "tree_attention_bwd_dkv")
    _count(tree_attention_bwd_dkv)
    return dk, dv


for _fn in (tree_attention_fwd, tree_attention_bwd_dq, tree_attention_bwd_dkv):
    _fn.launches = 0
KERNELS = (tree_attention_fwd, tree_attention_bwd_dq, tree_attention_bwd_dkv)


class TreeAttention(torch.autograd.Function):
    """The kernels as one differentiable op. The forward saves the output
    and the per-row log-sum-exp when a gradient is wanted; the backward
    regenerates the dropout mask from the seed."""

    @staticmethod
    def forward(ctx, q, k, v, template, ids, lut, seed: int, rate: float, scale: float, double_add: bool):
        need = any(ctx.needs_input_grad[i] for i in (0, 1, 2, 5))
        out, lse = tree_attention_fwd(q, k, v, template, ids, lut, scale, double_add, rate, seed, with_lse=need)
        if need:
            ctx.save_for_backward(q, k, v, template, ids, lut, out, lse)
            ctx.args = (scale, double_add, rate, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, template, ids, lut, out, lse = ctx.saved_tensors
        scale, double_add, rate, seed = ctx.args
        g = g.contiguous()
        dq, dlut, delta = tree_attention_bwd_dq(q, k, v, out, g, template, ids, lut, lse, scale, double_add, rate, seed)
        dk, dv = tree_attention_bwd_dkv(q, k, v, g, template, ids, lut, lse, delta, scale, double_add, rate, seed)
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
    _check_rate(rate, seed)
    seed = 0 if seed is None else int(seed)
    if q.device.type == "cpu":
        return tree_attention_dropout_reference(q, k, v, template, ids, lut, seed, rate, scale, double_add)
    return TreeAttention.apply(q, k, v, template, ids, lut, seed, float(rate), float(scale), double_add)
