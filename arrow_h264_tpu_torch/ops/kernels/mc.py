"""Wrappers of the MC kernels (csrc/mc.cu): luma and chroma prediction of
both reference lists from the dense uint8 DPB.

Replace arrow_h264_tpu/ops/pallas/mc_kernel.py::mc_luma_pallas_batch and
::mc_chroma_pallas_batch.  The plain versions are ops/inter.py::
mc_luma_plain and ::mc_chroma_plain; the weighted combine after them
(ops/inter.py::mc_combine) is plain PyTorch on every device.
"""

from __future__ import annotations

import torch

from ..inter import PAD, PADC, mc_chroma_plain, mc_luma_plain
from . import LAUNCHES, build, cuda_device, require


def _check_motion(mv, refslot, B: int, n: int, dev) -> None:
    require(mv, "mv", torch.int32, (B, n, 4, 4, 2, 2), dev)
    require(refslot, "refslot", torch.int32, (B, n, 4, 4, 2), dev)


def mc_luma(dpb_y, mv, refslot, mb_w: int, mb_h: int):
    """dpb_y [B, S, 4, H + 2*PAD, W + 2*PAD] uint8 -> [B, 2, H, W] int32
    quarter-pel prediction of lists 0 and 1 (0 where a list is unused)."""
    dev = cuda_device(dpb_y)
    if dev is None:
        return mc_luma_plain(dpb_y, mv, refslot, mb_w, mb_h)
    B, S = dpb_y.shape[:2]
    H, W = mb_h * 16, mb_w * 16
    require(dpb_y, "dpb_y", torch.uint8, (B, S, 4, H + 2 * PAD, W + 2 * PAD),
            dev)
    _check_motion(mv, refslot, B, mb_w * mb_h, dev)
    out = torch.empty((B, 2, H, W), dtype=torch.int32, device=dev)
    fn = build.function("mc_luma_launch", 4, 4)
    with torch.cuda.device(dev):
        err = fn(dpb_y.data_ptr(), mv.data_ptr(), refslot.data_ptr(),
                 out.data_ptr(), B, S, mb_w, mb_h,
                 torch.cuda.current_stream().cuda_stream)
    build.check("mc_luma_launch", err)
    LAUNCHES["mc_luma"] += 1
    return out


def mc_chroma(dpb_c, mv, refslot, mb_w: int, mb_h: int):
    """dpb_c [B, S, 2, H/2 + 2*PADC, W/2 + 2*PADC] uint8 -> [B, 2 (list),
    2 (plane), H/2, W/2] int32 1/8-pel prediction (0 for unused lists)."""
    dev = cuda_device(dpb_c)
    if dev is None:
        return mc_chroma_plain(dpb_c, mv, refslot, mb_w, mb_h)
    B, S = dpb_c.shape[:2]
    Hc, Wc = mb_h * 8, mb_w * 8
    require(dpb_c, "dpb_c", torch.uint8,
            (B, S, 2, Hc + 2 * PADC, Wc + 2 * PADC), dev)
    _check_motion(mv, refslot, B, mb_w * mb_h, dev)
    out = torch.empty((B, 2, 2, Hc, Wc), dtype=torch.int32, device=dev)
    fn = build.function("mc_chroma_launch", 4, 4)
    with torch.cuda.device(dev):
        err = fn(dpb_c.data_ptr(), mv.data_ptr(), refslot.data_ptr(),
                 out.data_ptr(), B, S, mb_w, mb_h,
                 torch.cuda.current_stream().cuda_stream)
    build.check("mc_chroma_launch", err)
    LAUNCHES["mc_chroma"] += 1
    return out
