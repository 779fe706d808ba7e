"""ctypes bridge to the C++ binned-SAH BVH builder (bvh/cpp/bvh_builder.cpp).

The reference's equivalent is the compiled Rust `bvh` crate with its SIMD
feature (Cargo.toml:14,23-24).  ``g++`` compiles the port's own copy of the
JAX package's builder at first use into ``build/rt_tpu_torch/`` at the
repository root, beside the CUDA library, with the JAX package's flags
(rt_tpu/bvh/cpp/build.sh), so that both packages build the same trees on
one machine.  The library's name carries a digest of the source and flags.
As in the JAX package, the NumPy builder runs where the library cannot be
built or loaded (``available()`` is then False); the two builders give
different trees, so callers that need the JAX package's tables check
``available()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from rt_tpu_torch._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "cpp" / "bvh_builder.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lib = None
_load_failed = False


def _try_load() -> None:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"libbvh_{digest}.so"
    try:
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f"libbvh_{digest}.{os.getpid()}.tmp.so"
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError):
        _load_failed = True
        return
    lib.bvh_build.restype = ctypes.c_int
    lib.bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # mins [P*3]
        ctypes.POINTER(ctypes.c_float),  # maxs [P*3]
        ctypes.c_int,  # P
        ctypes.c_int,  # leaf_size
        ctypes.POINTER(ctypes.c_float),  # out node_min [2P*3]
        ctypes.POINTER(ctypes.c_float),  # out node_max
        ctypes.POINTER(ctypes.c_int),  # out hit_next
        ctypes.POINTER(ctypes.c_int),  # out miss_next
        ctypes.POINTER(ctypes.c_int),  # out leaf_start
        ctypes.POINTER(ctypes.c_int),  # out leaf_count
        ctypes.POINTER(ctypes.c_int),  # out prim_order [P]
    ]
    _lib = lib


def available() -> bool:
    """True when the native builder is built and loaded (it then runs)."""
    _try_load()
    return _lib is not None


def build(mins: np.ndarray, maxs: np.ndarray, leaf_size: int):
    """Build via the C++ library; same array contract as the NumPy builder."""
    if not available():
        raise RuntimeError("the native BVH builder is not available")
    p = mins.shape[0]
    cap = max(2 * p, 1)
    mins = np.ascontiguousarray(mins, np.float32)
    maxs = np.ascontiguousarray(maxs, np.float32)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    hit_next = np.empty((cap,), np.int32)
    miss_next = np.empty((cap,), np.int32)
    leaf_start = np.empty((cap,), np.int32)
    leaf_count = np.empty((cap,), np.int32)
    prim_order = np.empty((max(p, 1),), np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n_nodes = _lib.bvh_build(
        mins.ctypes.data_as(fp), maxs.ctypes.data_as(fp), p, leaf_size,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        hit_next.ctypes.data_as(ip), miss_next.ctypes.data_as(ip),
        leaf_start.ctypes.data_as(ip), leaf_count.ctypes.data_as(ip),
        prim_order.ctypes.data_as(ip),
    )
    if n_nodes <= 0:
        raise RuntimeError("bvh_build failed")
    return (
        node_min[:n_nodes], node_max[:n_nodes], hit_next[:n_nodes], miss_next[:n_nodes],
        leaf_start[:n_nodes], leaf_count[:n_nodes], prim_order,
    )
