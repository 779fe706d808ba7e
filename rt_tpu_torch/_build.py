"""Build and load the port's CUDA kernels, and check what is handed to them.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, at first use, under ``build/rt_tpu_torch/`` at the repository
root: one ``nvcc -c`` per source, all started together, then one link;
``ctypes`` loads the library.  The library's file name carries a digest of the
sources and flags, so an edited source is rebuilt and never mistaken for a
stale build.  A failed build raises: there is no fallback.

Flags: ``-fmad=false`` and no ``--use_fast_math``, so every a*b+c stays two
IEEE-rounded operations and divisions and square roots stay exact, as in
the plain PyTorch versions the kernels are held against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from rt_tpu_torch import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "rt_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None
build_info: dict = {}  # path, seconds (0.0 when reused) and nvcc's output of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def build() -> Path:
    """Compile csrc/*.cu into build/rt_tpu_torch/ unless an up-to-date
    library is there; return its path."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        digest.update(path.name.encode() + path.read_bytes())
    lib_path = BUILD_DIR / f"librt_tpu_torch_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, log="")
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    start = time.perf_counter()
    compiles = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objs))
    ]
    log = [proc.communicate()[0] for _, proc in compiles]  # wait for every compile
    for (cmd, proc), out in zip(compiles, log):
        if proc.returncode != 0:
            for obj in objs:
                obj.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - start
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    build_info.update(path=str(lib_path), seconds=seconds, log="".join(log) + res.stdout + res.stderr)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with its C entry
    points' argument types declared."""
    global _lib
    if _lib is None:
        with profiling.span("kernels.build"):
            lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        i64, f32 = ctypes.c_longlong, ctypes.c_float
        fn = lib.rt_megakernel_flat
        fn.argtypes = ([ptr] + [i32] * 4 + [ctypes.c_uint] + [i32] * 8 + [ptr] * 4
                       + [i32] + [ptr] * 4)
        fn.restype = i32
        fn = lib.rt_sphere_nearest
        fn.argtypes = [ptr, i64, i64, ptr, i64, i64, i32, ptr, i32, f32, f32, ptr, ptr, ptr]
        fn.restype = i32
        fn = lib.rt_prim_nearest
        fn.argtypes = [ptr, i32, ptr, i32, ptr, i32, i32, f32, f32, i32, ptr, i32, i32,
                       ptr, ptr, ptr, ptr]
        fn.restype = i32
        fn = lib.rt_cluster_nearest
        fn.argtypes = ([ptr, i32] + [ptr, i32, ptr, i32, ptr, ptr, ptr, f32, f32, i32] * 2
                       + [f32, f32, i32, ptr, ptr, ptr])
        fn.restype = i32
        fn = lib.rt_megakernel_clustered
        fn.argtypes = ([ptr] + [i32] * 4 + [ctypes.c_uint] + [i32] * 6
                       + [ptr, i32, ptr, i32, ptr, ptr, ptr, f32, f32] * 2
                       + [i32, ptr, ptr, ptr, ptr, ptr])
        fn.restype = i32
        fn = lib.rt_micro_reduce
        fn.argtypes = [ptr, ptr] + [i32] * 3 + [ptr] * 6
        fn.restype = i32
        fn = lib.rt_micro_gather
        fn.argtypes = [ptr, ptr, i32, ptr, ptr] + [i32] * 3 + [ptr] * 3
        fn.restype = i32
        fn = lib.rt_micro_scatter
        fn.argtypes = [ptr, ptr] + [i32] * 5 + [ptr] * 3
        fn.restype = i32
        fn = lib.rt_bvh_walk
        fn.argtypes = ([ptr, ptr, i32] + [ptr] * 7 + [i32, i32, ptr, ptr, i32] + [ptr] * 3
                       + [i32, f32, f32, f32, i32, ptr, ptr, ptr])
        fn.restype = i32
        fn = lib.rt_sweep_accumulate
        fn.argtypes = [ptr, ptr, i64, i32, ptr]
        fn.restype = i32
        _lib = lib
    return _lib


def require(t: torch.Tensor, name: str, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """Check a tensor handed to a kernel: on ``device``, of ``dtype``,
    contiguous, and 16-byte aligned (float4 loads).  Raises otherwise."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need contiguous {dtype} on {device}, got {t.dtype} on {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
    return t
