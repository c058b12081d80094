"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper launches its kernel for CUDA tensors and calls the plain
PyTorch version (ops/intra.py, ops/deblock.py, ops/inter.py, ops/wire.py,
ops/transforms.py) for CPU tensors.  `LAUNCHES` counts the wrapper calls
that launched a kernel, so a run can show that its main path went through
the kernels.  K1-K6 replace the reference's Pallas kernels; K7
(deblock_tables), K8 (unpack_bm8), K9 (residual), K10 (inter_combine),
K11 (store_refs) and K12 (unpack_wire: the wire's sections but the bm8
classes) replace stages that the reference computes in XLA.
"""

LAUNCHES = {"intra_phase": 0, "deblock_phase": 0, "mc_luma": 0,
            "mc_chroma": 0, "intra_raster": 0, "deblock_raster": 0,
            "deblock_tables": 0, "unpack_bm8": 0, "residual": 0,
            "inter_combine": 0, "store_refs": 0, "unpack_wire": 0}


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


def lane_stride(t, name: str, dtype, shape, device) -> int:
    """t's stride between lanes, in elements, after checking that t is a
    [B, ...] tensor of `dtype` and `shape` on `device` whose lanes are
    each contiguous and whose address is a multiple of its element size
    (lanes may lie apart, as the slots of a [B, S, H, W] picture stack or
    the sections of a wire buffer do)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t[:1].numel() and not t[0].is_contiguous():
        raise ValueError(f"{name}: a lane's elements are not contiguous")
    if not 0 <= t.stride(0) < 2**31 or t.data_ptr() % t.element_size():
        raise ValueError(f"{name}: lane stride {t.stride(0)} or address "
                         "not usable")
    return t.stride(0)


def cuda_device(t):
    """t's device if it is a CUDA device; None for CPU; raise otherwise."""
    if t.device.type == "cuda":
        return t.device
    if t.device.type == "cpu":
        return None
    raise ValueError(f"no kernel or plain version for device {t.device}")
