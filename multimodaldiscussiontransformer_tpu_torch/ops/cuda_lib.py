"""Build and bind the port's CUDA kernel libraries.

Each source under ``csrc/`` is compiled by ``nvcc`` for sm_90a into its own
shared library with a plain C interface, at first use, into ``_build/`` next
to the package (ignored by git); all missing libraries are compiled at once,
one ``nvcc`` per source. A library's name carries a hash of its source, the
shared headers and the flags, so a changed source rebuilds. The libraries are
loaded with ``ctypes``; ``ENTRY_POINTS`` gives each C function's argument
types. Nothing here runs on the CPU path: the ops modules call
``load_library`` only to launch a kernel on a CUDA tensor, and a failed
build or launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
# one shared library per source, built in parallel
SOURCES = {
    "tree_fwd_mma": CSRC / "tree_attention_fwd_mma.cu",
    "tree_fwd_tf32": CSRC / "tree_attention_fwd_tf32.cu",
    "tree_bwd_mma": CSRC / "tree_attention_bwd_mma.cu",
    "tree_bwd_tf32": CSRC / "tree_attention_bwd_tf32.cu",
    "masked_fwd_mma": CSRC / "masked_attention_fwd_mma.cu",
    "masked_fwd_tf32": CSRC / "masked_attention_fwd_tf32.cu",
    "masked_fwd_tiled": CSRC / "masked_attention_fwd_tiled.cu",
    "masked_bwd_mma": CSRC / "masked_attention_bwd_mma.cu",
    "masked_bwd_tf32": CSRC / "masked_attention_bwd_tf32.cu",
    "masked_bwd_tiled": CSRC / "masked_attention_bwd_tiled.cu",
    "biased_fwd": CSRC / "biased_attention_fwd.cu",
    "biased_fwd_mma": CSRC / "biased_attention_fwd_mma.cu",
    "biased_fwd_tf32": CSRC / "biased_attention_fwd_tf32.cu",
}
HEADERS = (CSRC / "tree_attention_common.cuh", CSRC / "mma_common.cuh", CSRC / "tf32_common.cuh")
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# (B, H, S, DH, scale, [tpl_coef,] seed_lo, seed_hi, thr, keep_scale, dtype, stream)
_TREE_TAIL = [_I] * 4 + [_F] * 2 + [_U] * 3 + [_F, _I, _P]
_MASKED_TAIL = [_I] * 4 + [_F] + [_U] * 3 + [_F, _I, _P]
_BIASED_ARGS = [_P] * 6 + [_I] * 5 + [_F, _I, _I, _P]
# library -> {C function: argument types}; every function returns a
# cudaError_t as int, and each library has one "<...>_error_string"
ENTRY_POINTS = {
    "tree_fwd_mma": {"tree_attention_fwd_mma": [_P] * 8 + _TREE_TAIL},
    "tree_fwd_tf32": {"tree_attention_fwd_tf32": [_P] * 8 + _TREE_TAIL},
    "tree_bwd_mma": {"tree_attention_bwd_dq_mma": [_P] * 12 + _TREE_TAIL,
                     "tree_attention_bwd_dkv_mma": [_P] * 11 + _TREE_TAIL},
    "tree_bwd_tf32": {"tree_attention_bwd_dq_tf32": [_P] * 12 + _TREE_TAIL,
                      "tree_attention_bwd_dkv_tf32": [_P] * 11 + _TREE_TAIL},
    "masked_fwd_mma": {"masked_attention_fwd_mma": [_P] * 6 + _MASKED_TAIL},
    "masked_fwd_tf32": {"masked_attention_fwd_tf32": [_P] * 6 + _MASKED_TAIL},
    "masked_fwd_tiled": {"masked_attention_fwd_tiled": [_P] * 6 + _MASKED_TAIL},
    "masked_bwd_mma": {"masked_attention_bwd_mma": [_P] * 10 + _MASKED_TAIL},
    "masked_bwd_tf32": {"masked_attention_bwd_dq_tf32": [_P] * 9 + _MASKED_TAIL,
                        "masked_attention_bwd_dkv_tf32": [_P] * 9 + _MASKED_TAIL},
    "masked_bwd_tiled": {"masked_attention_bwd_dq_tiled": [_P] * 9 + _MASKED_TAIL,
                         "masked_attention_bwd_dkv_tiled": [_P] * 9 + _MASKED_TAIL},
    # (q, k, v, bias, pad, out, B, H, S, DH, bias_heads, scale, dtype, bias_dtype, stream)
    "biased_fwd": {"biased_attention_fwd": _BIASED_ARGS},
    "biased_fwd_mma": {"biased_attention_fwd_mma": _BIASED_ARGS},
    "biased_fwd_tf32": {"biased_attention_fwd_tf32": _BIASED_ARGS},
}
ERROR_STRINGS = {
    "tree_fwd_mma": "tree_attention_fwd_mma_error_string",
    "tree_fwd_tf32": "tree_attention_fwd_tf32_error_string",
    "tree_bwd_mma": "tree_attention_bwd_mma_error_string",
    "tree_bwd_tf32": "tree_attention_bwd_tf32_error_string",
    "masked_fwd_mma": "masked_attention_fwd_mma_error_string",
    "masked_fwd_tf32": "masked_attention_fwd_tf32_error_string",
    "masked_fwd_tiled": "masked_attention_fwd_tiled_error_string",
    "masked_bwd_mma": "masked_attention_bwd_mma_error_string",
    "masked_bwd_tf32": "masked_attention_bwd_tf32_error_string",
    "masked_bwd_tiled": "masked_attention_bwd_tiled_error_string",
    "biased_fwd": "biased_attention_fwd_error_string",
    "biased_fwd_mma": "biased_attention_fwd_mma_error_string",
    "biased_fwd_tf32": "biased_attention_fwd_tf32_error_string",
}

_libs: Optional[Dict[str, ctypes.CDLL]] = None
_lib_lock = threading.Lock()


def library_paths() -> Dict[str, Path]:
    """Where each kernel library lives: named by its source and a hash of
    the source, the shared headers and the flags."""
    shared = b"".join(p.read_bytes() for p in HEADERS) + " ".join(NVCC_FLAGS).encode()
    return {
        name: BUILD_DIR / f"{src.stem}-{hashlib.sha256(src.read_bytes() + shared).hexdigest()[:16]}.so"
        for name, src in SOURCES.items()
    }


def build() -> Dict[str, Path]:
    """Compile the missing kernel libraries under BUILD_DIR, one ``nvcc`` per
    source, all started together. The compiler is ``$NVCC``, else ``nvcc``
    on PATH, else /usr/local/cuda/bin/nvcc. ptxas' resource report is kept
    beside each library as ``.log``."""
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


def bind(paths: Dict[str, Path]) -> Dict[str, ctypes.CDLL]:
    """Load the libraries ``{library: path}`` with their entry points'
    argument types."""
    libs = {name: ctypes.CDLL(str(path)) for name, path in paths.items()}
    for name, lib in libs.items():
        for fn_name, argtypes in ENTRY_POINTS[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err_fn = getattr(lib, ERROR_STRINGS[name])
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
    return libs


def load_library() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and bind every kernel library, once per process."""
    global _libs
    with _lib_lock:
        if _libs is None:
            _libs = bind(build())
        return _libs


def launch(library: str, function: str, device, *args) -> None:
    """Call ``function`` of ``library`` with ``args`` and the current stream
    of ``device``; raise if it returns a CUDA error."""
    lib = load_library()[library]
    with torch.cuda.device(device):
        err = getattr(lib, function)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{function} launch failed: {getattr(lib, ERROR_STRINGS[library])(err).decode()} ({err})")
