"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper launches its kernel for CUDA tensors and calls the plain
PyTorch version (ops/intra.py, ops/deblock.py, ops/inter.py) for CPU
tensors.  `LAUNCHES` counts the wrapper calls that launched a kernel, so a
run can show that its main path went through the kernels.
"""

LAUNCHES = {"intra_phase": 0, "deblock_phase": 0, "mc_luma": 0,
            "mc_chroma": 0, "intra_raster": 0, "deblock_raster": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def require(t, name: str, dtype, shape, device) -> None:
    """Raise unless tensor t is what a kernel takes: contiguous, on
    `device`, of `dtype` and `shape`."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def cuda_device(t):
    """t's device if it is a CUDA device; None for CPU; raise otherwise."""
    if t.device.type == "cuda":
        return t.device
    if t.device.type == "cpu":
        return None
    raise ValueError(f"no kernel or plain version for device {t.device}")
