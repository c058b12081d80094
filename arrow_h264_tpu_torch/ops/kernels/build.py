"""Build and load the CUDA kernels (nvcc -> shared library -> ctypes).

All of `arrow_h264_tpu_torch/csrc/*.cu` is compiled in one nvcc call for
sm_90a into `arrow_h264_tpu_torch/_build/`, which git ignores.  The
library's file name carries a hash of the sources and flags, so an edit
triggers a rebuild and a stale library never loads.  The build runs on
first use (`function`), never at import: importing the wrappers needs
neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None     # wall time of the last nvcc run


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libarrow_h264_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under $CUDA_HOME/bin)")


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_seconds
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                        *map(str, sources())], capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def function(name: str, n_ptrs: int, n_ints: int):
    """The C entry `name`(n_ptrs pointers, n_ints ints, stream) -> int,
    with its ctypes signature set."""
    fn = getattr(load(), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
