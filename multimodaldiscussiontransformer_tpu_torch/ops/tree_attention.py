"""Compact-bias tree attention.

The mDT graph attention bias decomposes as

    bias[b,h,i,j] = c * template[b,i,j] + LUT[ids[b,i,j], h]

where ``template`` is the collator's (B,S,S) 0/-inf mask (``c`` = 2 when the
reference's double-added bias is kept, else 1) and ``LUT`` merges the
spatial-bucket embedding column of head h with the graph-token virtual
distance: the +1-shifted Cantor bucket space is tiny (21 live ids), so the
graph-token row/column is one more id and the per-head bias is a 32-entry
lookup. The (B,H,S,S) bias never has to exist.

``tree_attention`` runs the hand-written CUDA kernel
(``csrc/tree_attention_fwd.cu``) on a CUDA tensor and the plain PyTorch
version ``tree_attention_reference`` on a CPU tensor. The kernel is built
with ``nvcc`` at its first use, into ``_build/`` next to the package, and
bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

MASK_BIAS = -1e9
LUT_SIZE = 32  # >= 1 (pad) + 21 cantor buckets + 1 graph-token id
GRAPH_TOKEN_ID = LUT_SIZE - 1  # id of the virtual-distance entry

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCE = _PACKAGE / "csrc" / "tree_attention_fwd.cu"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def tree_attention_reference(
    q, k, v, template, ids, lut, scale: Optional[float] = None, double_add: bool = True
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function, in f32: the row max
    starts at MASK_BIAS and the denominator is clamped at 1e-30, so a row
    whose every key is masked gives zeros, as the kernel does."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    bias = assemble_bias(template, ids, lut, double_add)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float()) + bias
    m = scores.amax(dim=-1, keepdim=True).clamp_min(MASK_BIAS)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / denom
    return out.to(q.dtype)


_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def build() -> Path:
    """Compile the kernel into a shared library under BUILD_DIR, named by a
    hash of the source and flags (a changed source rebuilds). The compiler
    is ``$NVCC``, else ``nvcc`` on PATH, else /usr/local/cuda/bin/nvcc.
    ptxas' resource report is kept beside the library as ``.log``."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"tree_attention_fwd-{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = os.environ.get("NVCC") or shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}: {' '.join(cmd)}\n{proc.stderr}"
        )
    lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build (if needed) and bind the kernel library, once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tree_attention_fwd.argtypes = (
                [ctypes.c_void_p] * 7
                + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            )
            lib.tree_attention_fwd.restype = ctypes.c_int
            lib.tree_attention_error_string.argtypes = [ctypes.c_int]
            lib.tree_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_cuda_inputs(q, k, v, template, ids, lut) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"tree_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share a (B, H, S, DH) shape: {q.shape}, {k.shape}, {v.shape}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    b, h, s, dh = q.shape
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {_HEAD_DIMS}")
    if template.shape != (b, s, s) or template.dtype != torch.float32:
        raise ValueError(f"template must be float32 {(b, s, s)}, got {template.dtype} {tuple(template.shape)}")
    if ids.shape != (b, s, s) or ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32 {(b, s, s)}, got {ids.dtype} {tuple(ids.shape)}")
    if lut.shape != (LUT_SIZE, h) or lut.dtype != torch.float32:
        raise ValueError(f"lut must be float32 {(LUT_SIZE, h)}, got {lut.dtype} {tuple(lut.shape)}")
    for name, t in zip(("q", "k", "v", "template", "ids", "lut"), (q, k, v, template, ids, lut)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, lut)):
        raise NotImplementedError("tree_attention has no backward kernel yet; call it under torch.no_grad()")
    if b > 65535 or h > 65535:
        raise ValueError(f"grid too large: B={b}, H={h}")


def tree_attention(
    q: torch.Tensor,  # (B, H, S, DH)
    k: torch.Tensor,
    v: torch.Tensor,
    template: torch.Tensor,  # (B, S, S) f32
    ids: torch.Tensor,  # (B, S, S) int32
    lut: torch.Tensor,  # (LUT_SIZE, H) f32
    scale: Optional[float] = None,
    double_add: bool = True,
) -> torch.Tensor:
    """Compact-bias tree attention: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. ``tree_attention.launches`` counts kernel
    launches."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return tree_attention_reference(q, k, v, template, ids, lut, scale, double_add)
    if q.device.type != "cuda":
        raise ValueError(f"tree_attention runs on cpu or cuda, not {q.device}")
    _check_cuda_inputs(q, k, v, template, ids, lut)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = load_library()
    b, h, s, dh = q.shape
    with torch.cuda.device(q.device):
        err = lib.tree_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), template.data_ptr(),
            ids.data_ptr(), lut.data_ptr(), out.data_ptr(),
            b, h, s, dh, float(scale), 2.0 if double_add else 1.0,
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = lib.tree_attention_error_string(err).decode()
        raise RuntimeError(f"tree_attention_fwd launch failed: {msg} ({err})")
    with _count_lock:
        tree_attention.launches += 1
    return out


tree_attention.launches = 0
