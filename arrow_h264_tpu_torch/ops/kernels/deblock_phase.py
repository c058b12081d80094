"""Wrapper of the deblock kernel (csrc/deblock_phase.cu).

Replaces arrow_h264_tpu/ops/pallas/deblock_phase.py::deblock_phase_batch.
The plain version is ops/deblock.py::deblock_filter_planes.  `run_deblock`
is the launch path that this kernel and the raster-order one
(deblock_raster.py) share: they take the same arguments.
"""

from __future__ import annotations

import torch

from ..deblock import TABLE_KEYS, deblock_filter_planes
from . import LAUNCHES, build, cuda_device, require
from .wavefront import wavefront_args

_TABLE_SHAPES = {"bs_v": (4, 4), "tc_v": (4, 4), "a_v": (4,), "b_v": (4,),
                 "bs_h": (4, 4), "tc_h": (4, 4), "a_h": (4,), "b_h": (4,),
                 "bs_c": (2, 2, 4), "tc_c": (2, 2, 4, 2), "a_c": (2, 2, 2),
                 "b_c": (2, 2, 2)}


def deblock_phase(y, cb, cr, tables, mb_w: int, mb_h: int):
    """Deblock [B] frames along the knight-move wavefront: one persistent
    launch with per-MB ready flags (csrc/deblock_phase.cu).  Arguments
    and result as for run_deblock."""
    extra = wavefront_args(y.shape[0], mb_w, mb_h, y.device) \
        if cuda_device(y) else ()
    return run_deblock("deblock_phase", y, cb, cr, tables, mb_w, mb_h, extra)


def run_deblock(name: str, y, cb, cr, tables, mb_w: int, mb_h: int,
                extra: tuple = ()):
    """Deblock [B] frames' uint8 planes y [B, H, W], cb/cr [B, H/2, W/2]
    with the ops.deblock.deblock_tables of the frames, with the kernel
    whose C entry is `name`_launch, counted under LAUNCHES[name]; `extra`
    are tensors that kernel takes after the tables.

    CUDA tensors are filtered in place and returned; CPU tensors go
    through the plain version, which returns new uint8 planes."""
    dev = cuda_device(y)
    if dev is None:
        planes = deblock_filter_planes(y, cb, cr, tables, mb_w, mb_h)
        return tuple(p.to(torch.uint8) for p in planes)
    B = y.shape[0]
    H, W = mb_h * 16, mb_w * 16
    n = mb_w * mb_h
    require(y, "y", torch.uint8, (B, H, W), dev)
    for arg, c in (("cb", cb), ("cr", cr)):
        require(c, arg, torch.uint8, (B, H // 2, W // 2), dev)
    for k in TABLE_KEYS:
        require(tables[k], k, torch.int32, (B, n) + _TABLE_SHAPES[k], dev)
    ptrs = [p.data_ptr() for p in (y, cb, cr)] + \
        [tables[k].data_ptr() for k in TABLE_KEYS] + \
        [t.data_ptr() for t in extra]
    fn = build.function(f"{name}_launch", len(ptrs), 3)
    with torch.cuda.device(dev):
        err = fn(*ptrs, B, mb_w, mb_h, torch.cuda.current_stream().cuda_stream)
    build.check(f"{name}_launch", err)
    LAUNCHES[name] += 1
    return y, cb, cr
