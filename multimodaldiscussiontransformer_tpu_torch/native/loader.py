"""Build and bind the port's C++ host helper (``mdt_native.cc``).

The helper has a plain C interface, loaded with ``ctypes``. At first use
``g++ -O3 -shared -fPIC -std=c++17`` compiles it into ``_build/`` next to
the package (ignored by git; the CUDA libraries of ``ops/cuda_lib.py`` live
there too), never into the source tree. The library's name carries a hash
of the source and the flags, so a changed source rebuilds. This is host
code on the data path: where the build or the load fails (no compiler),
``try_load`` returns None and the callers take their numpy versions, as the
JAX package's loader does. ``MDT_TPU_NO_NATIVE=1`` forces the numpy
versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "mdt_native.cc"
BUILD_DIR = _PACKAGE / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
DISABLE_ENV = "MDT_TPU_NO_NATIVE"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False
# calls into the helper per function, for checks that the native path ran
CALLS = {"tree_distance_pairs": 0, "floyd_warshall": 0, "spatial_buckets": 0}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"mdt_native-{digest}.so"


def build() -> Path:
    """Compile the helper into ``_build/`` unless it is there; raise with
    the compiler's output on failure."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX") or "g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed with code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.mdt_tree_distance_pairs.argtypes = [i64p, i64, i64p]
    lib.mdt_tree_distance_pairs.restype = ctypes.c_int
    lib.mdt_floyd_warshall.argtypes = [i64p, i64, i64, i64p]
    lib.mdt_floyd_warshall.restype = None
    lib.mdt_spatial_buckets.argtypes = [i64p, i64, i64p, i64, i64p]
    lib.mdt_spatial_buckets.restype = None
    return lib


def try_load() -> Optional[ctypes.CDLL]:
    """The helper (built if needed, once per process), or None when
    ``MDT_TPU_NO_NATIVE`` is set or it cannot be built or loaded."""
    global _lib, _failed
    if os.environ.get(DISABLE_ENV):
        return None
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is None and not _failed:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError, subprocess.SubprocessError):
                _failed = True
    return _lib


def tree_distance_pairs(lib: ctypes.CDLL, parents: np.ndarray) -> np.ndarray:
    parents = np.ascontiguousarray(parents, dtype=np.int64)
    n = len(parents)
    out = np.empty((n, n, 2), dtype=np.int64)
    rc = lib.mdt_tree_distance_pairs(parents, n, out)
    CALLS["tree_distance_pairs"] += 1
    if rc != 0:
        raise ValueError(f"malformed tree (native rc={rc})")
    return out


def floyd_warshall(lib: ctypes.CDLL, adjacency: np.ndarray, unreachable: int) -> np.ndarray:
    adj = np.ascontiguousarray(adjacency, dtype=np.int64)
    n = adj.shape[0]
    out = np.empty((n, n), dtype=np.int64)
    lib.mdt_floyd_warshall(adj, n, unreachable, out)
    CALLS["floyd_warshall"] += 1
    return out


def spatial_buckets(lib: ctypes.CDLL, pairs: np.ndarray, table: np.ndarray, clip: int) -> np.ndarray:
    pairs = np.ascontiguousarray(pairs, dtype=np.int64)
    table = np.ascontiguousarray(table, dtype=np.int64)
    n = pairs.shape[0]
    out = np.empty((n, n), dtype=np.int64)
    lib.mdt_spatial_buckets(pairs, n, table, clip, out)
    CALLS["spatial_buckets"] += 1
    return out
