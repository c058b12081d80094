"""Wrapper of the reference store kernel K11 (csrc/store_ref.cu).

Replaces no pallas_call: the reference computes a stored picture's
half-pel planes and padded chroma in XLA (arrow_h264_tpu/models/
pipeline.py::store_ref_fn with ops/inter.py::halfpel_planes and
pad_chroma).  The plain version is ops/inter.py::store_refs_plain, ~60
eager torch launches, a stack and an index assignment a call; the kernel
is one launch a round (one more for each 64 storing lanes past the
first) that writes the G, b, h, j planes and the padded chroma of each
storing lane straight into its DPB slot, 16 bytes a store.  The lanes and slots travel as
kernel arguments, so the call copies nothing to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..inter import PAD, PADC, store_refs_plain
from . import LAUNCHES, build, cuda_device, lane_stride, require


def store_refs(dpb_y_b, dpb_c_b, lanes, slots, y_b, cb_b, cr_b) -> None:
    """ops/inter.py::store_refs_plain: lane lanes[k]'s picture (y_b [B,
    H, W], cb_b, cr_b [B, H/2, W/2] uint8) into slot slots[k] of its DPB
    row (dpb_y_b [B, S, 4, H + 2*PAD, W + 2*PAD], dpb_c_b [B, S, 2,
    H/2 + 2*PADC, W/2 + 2*PADC] uint8), in place.  On a CUDA device
    K11, on the CPU the plain version; no lanes, nothing."""
    if len(lanes) == 0:
        return
    dev = cuda_device(dpb_y_b)
    if dev is None:
        store_refs_plain(dpb_y_b, dpb_c_b, lanes, slots, y_b, cb_b, cr_b)
        return
    B, S = dpb_y_b.shape[:2]
    H, W = y_b.shape[1:]
    if H % 16 or W % 16 or len(lanes) != len(slots):
        raise ValueError(f"store_refs: picture {W}x{H}, {len(lanes)} lanes "
                         f"and {len(slots)} slots")
    require(dpb_y_b, "dpb_y", torch.uint8,
            (B, S, 4, H + 2 * PAD, W + 2 * PAD), dev)
    require(dpb_c_b, "dpb_c", torch.uint8,
            (B, S, 2, H // 2 + 2 * PADC, W // 2 + 2 * PADC), dev)
    # the kernel writes 16-byte groups (8-byte ones in the chroma rows of
    # an odd mb_w): every slot and plane of a DPB starts a multiple of 64
    # bytes after its first byte, so the base must be 16-byte aligned, as
    # models/pipeline.py::dpb_alloc's fresh allocations are
    if dpb_y_b.data_ptr() % 16 or dpb_c_b.data_ptr() % 16:
        raise ValueError("dpb_y, dpb_c: data_ptr() is not 16-byte aligned")
    strides = [lane_stride(t, k, torch.uint8, s, dev) for t, k, s in (
        (y_b, "y", (y_b.shape[0], H, W)),
        (cb_b, "cb", (y_b.shape[0], H // 2, W // 2)),
        (cr_b, "cr", (y_b.shape[0], H // 2, W // 2)))]
    li, si = (np.ascontiguousarray(v, np.int32) for v in (lanes, slots))
    if li.min() < 0 or li.max() >= min(B, y_b.shape[0]) or si.min() < 0 \
            or si.max() >= S:
        raise ValueError(f"store_refs: lanes {lanes} or slots {slots} out "
                         f"of range ({B} lanes, {S} slots)")
    fn = build.function("store_refs_launch", 7, 7)
    with torch.cuda.device(dev):
        err = fn(y_b.data_ptr(), cb_b.data_ptr(), cr_b.data_ptr(),
                 dpb_y_b.data_ptr(), dpb_c_b.data_ptr(), li.ctypes.data,
                 si.ctypes.data, li.size, *strides, S, H, W,
                 torch.cuda.current_stream().cuda_stream)
    build.check("store_refs_launch", err)
    LAUNCHES["store_refs"] += 1
