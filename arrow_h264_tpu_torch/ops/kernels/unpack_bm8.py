"""Wrapper of the wire's bm8 expansion kernel K8 (csrc/unpack_bm8.cu).

Replaces no pallas_call: the reference expands the wire's bm8
coefficient sections in XLA (arrow_h264_tpu/ops/wire.py::_scatter_bm8),
inside its jitted unpack.  The plain version is ops/wire.py::
_scatter_bm8, about 15 eager torch launches a class with an int64 cumsum
over every significance bit; ops/wire.py::unpack_wire calls this wrapper
once for each class the round ships as bm8.  The kernel is a chunked
scan in three launches (DEVICE_LAUNCHES) of one call: chunk totals,
row offsets, then the dense rows, each output word written once.  It
reads the sections where they lie in the wire buffer (a lane's row
stride apart), so the wrapper copies nothing.
"""

from __future__ import annotations

import torch

from ..wire import _scatter_bm8
from . import LAUNCHES, build, cuda_device, lane_stride

DEVICE_LAUNCHES = 3        # kernels one wrapper call puts on the card


def unpack_bm8(idx, bm, vals, grid: int, w: int):
    """ops/wire.py::_scatter_bm8 of [B] lanes: idx [B, br] int32, bm [B,
    br, (w + 15) // 16] int16 (bitmaps, masked to 16 bits), vals [B, bv]
    int8 -> dense [B, grid, w] int32.  On a CUDA device the kernel, on
    the CPU the plain version."""
    dev = cuda_device(bm)
    if dev is None:
        return _scatter_bm8(idx, bm, vals, grid, w)
    B, br, bmw = bm.shape
    bv = vals.shape[1]
    if w % 4 or not 0 < w <= 64 or bmw != (w + 15) // 16 or bv < 1 \
            or grid < 0:
        raise ValueError(f"unpack_bm8: w {w}, {bmw} bitmap words, {bv} "
                         f"values, grid {grid}")
    strides = (lane_stride(idx, "idx", torch.int32, (B, br), dev),
               lane_stride(bm, "bm", torch.int16, (B, br, bmw), dev),
               lane_stride(vals, "vals", torch.int8, (B, bv), dev))
    out = torch.empty((B, grid, w), dtype=torch.int32, device=dev)
    # the row map [B, grid], each row's first value [B, br] and the chunk
    # totals (at most one a row)
    scratch = torch.empty(B * (grid + 2 * br), dtype=torch.int32,
                          device=dev)
    fn = build.function("unpack_bm8_launch", 5, 9)
    with torch.cuda.device(dev):
        err = fn(idx.data_ptr(), bm.data_ptr(), vals.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), *strides, B, br, bmw,
                 bv, grid, w, torch.cuda.current_stream().cuda_stream)
    build.check("unpack_bm8_launch", err)
    LAUNCHES["unpack_bm8"] += 1
    return out
