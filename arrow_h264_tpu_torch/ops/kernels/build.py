"""Build and load the CUDA kernels (nvcc -> shared library -> ctypes).

Each `arrow_h264_tpu_torch/csrc/*.cu` is compiled for sm_90a by its own
nvcc process, all started together, and the objects are linked into one
library in `arrow_h264_tpu_torch/_build/`, which git ignores.  The
library's file name carries a hash of the flags and of every `.cu` and
`.cuh` source, so an edit of a kernel or of a header it includes triggers
a rebuild and a stale library never loads.  The build runs on
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

from ...spans import now, recorder

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None     # wall time of the last nvcc run


def sources() -> list[Path]:
    """The kernels' translation units."""
    return sorted(CSRC.glob("*.cu"))


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libarrow_h264_kernels_{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    """Path of the CUDA compiler."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under $CUDA_HOME/bin)")


def compile_library(srcs: list[Path], out: Path) -> None:
    """Compile `srcs` with NVCC_FLAGS, one nvcc per source, all started
    together, and link the objects into the shared library `out`."""
    out.parent.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{tag}.{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen([cc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(srcs, objs)]
    tmp = out.parent / f"{tag}.tmp"
    try:
        logs = [p.communicate()[1] for p in procs]
        errs = [(p.args[-1], log) for p, log in zip(procs, logs)
                if p.returncode != 0]
        if errs:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{src}:\n{err}" for src, err in errs))
        r = subprocess.run([cc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                            *map(str, objs)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(tmp, out)
    finally:
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_seconds
    out = lib_path()
    if out.exists():
        return out
    t0 = time.perf_counter()
    compile_library(sources(), out)
    build_seconds = time.perf_counter() - t0
    return out


def load(path: Path | None = None) -> ctypes.CDLL:
    """The library the wrappers call: the one built from the sources
    (`build`), or from now on the library at `path`, which must export
    the same C entries (a variant of the kernels, as in
    tools/wavefront_probe.py)."""
    global _lib
    if path is not None:
        _lib = ctypes.CDLL(str(path))
    elif _lib is None:
        t0 = now() if recorder.enabled else 0
        _lib = ctypes.CDLL(str(build()))
        if t0:
            recorder.add("setup.kernels", t0, now())
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
