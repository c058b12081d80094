"""Wrappers of the MC kernels (csrc/mc.cu): luma and chroma prediction of
both reference lists from the dense uint8 DPB, as uint8.

Replace arrow_h264_tpu/ops/pallas/mc_kernel.py::mc_luma_pallas_batch and
::mc_chroma_pallas_batch.  The plain versions are ops/inter.py::
mc_luma_plain and ::mc_chroma_plain; the weighted combine after them
(ops/inter.py::mc_combine) is plain PyTorch on every device.

The kernels are bound by device-memory bytes.  Luma runs one thread per
4-sample row of a 4x4 cell: the cell's slot and MV are read once, the
reference as aligned 32-bit words joined by a shift, and the four uint8
samples are stored as one word.  Chroma runs one thread per 2x2 chroma
cell for both planes, its vertical MV moved by the slot's `cvoff` (the
cross-parity offset of field pictures; zeros for frames).  The word reads
need a 4-byte aligned DPB and the one 8-byte MV load an 8-byte aligned
`mv`: the wrappers check both and raise, and never fall back to the plain
version on a CUDA tensor.
"""

from __future__ import annotations

import torch

from ..inter import PAD, PADC, mc_chroma_plain, mc_luma_plain
from . import LAUNCHES, build, cuda_device, require


def _check_motion(mv, refslot, B: int, n: int, dev) -> None:
    require(mv, "mv", torch.int32, (B, n, 4, 4, 2, 2), dev)
    require(refslot, "refslot", torch.int32, (B, n, 4, 4, 2), dev)
    if mv.data_ptr() % 8:
        raise ValueError("mv: data_ptr() is not 8-byte aligned")


def _check_dpb(dpb, name: str, shape, dev) -> None:
    require(dpb, name, torch.uint8, shape, dev)
    if dpb.data_ptr() % 4:
        raise ValueError(f"{name}: data_ptr() is not 4-byte aligned")


def _launch(name: str, ptrs, out, B: int, S: int, mb_w: int, mb_h: int):
    """Launch `name`_launch on the inputs `ptrs` (tensors, in the C
    entry's order) and `out`."""
    fn = build.function(f"{name}_launch", len(ptrs) + 1, 4)
    with torch.cuda.device(out.device):
        err = fn(*(t.data_ptr() for t in ptrs), out.data_ptr(), B, S, mb_w,
                 mb_h, torch.cuda.current_stream().cuda_stream)
    build.check(f"{name}_launch", err)
    LAUNCHES[name] += 1
    return out


def mc_luma(dpb_y, mv, refslot, mb_w: int, mb_h: int):
    """dpb_y [B, S, 4, H + 2*PAD, W + 2*PAD] uint8 -> [B, 2, H, W] uint8
    quarter-pel prediction of lists 0 and 1 (0 where a list is unused)."""
    dev = cuda_device(dpb_y)
    if dev is None:
        return mc_luma_plain(dpb_y, mv, refslot, mb_w, mb_h)
    B, S = dpb_y.shape[:2]
    H, W = mb_h * 16, mb_w * 16
    _check_dpb(dpb_y, "dpb_y", (B, S, 4, H + 2 * PAD, W + 2 * PAD), dev)
    _check_motion(mv, refslot, B, mb_w * mb_h, dev)
    out = torch.empty((B, 2, H, W), dtype=torch.uint8, device=dev)
    return _launch("mc_luma", (dpb_y, mv, refslot), out, B, S, mb_w, mb_h)


def mc_chroma(dpb_c, mv, refslot, cvoff, mb_w: int, mb_h: int):
    """dpb_c [B, S, 2, H/2 + 2*PADC, W/2 + 2*PADC] uint8 -> [B, 2 (list),
    2 (plane), H/2, W/2] uint8 1/8-pel prediction (0 for unused lists).
    cvoff [B, S] int32: each slot's vertical chroma offset in 1/8 samples
    (ops/inter.py::mc_chroma_plain)."""
    dev = cuda_device(dpb_c)
    if dev is None:
        return mc_chroma_plain(dpb_c, mv, refslot, cvoff, mb_w, mb_h)
    B, S = dpb_c.shape[:2]
    Hc, Wc = mb_h * 8, mb_w * 8
    _check_dpb(dpb_c, "dpb_c", (B, S, 2, Hc + 2 * PADC, Wc + 2 * PADC), dev)
    _check_motion(mv, refslot, B, mb_w * mb_h, dev)
    require(cvoff, "cvoff", torch.int32, (B, S), dev)
    out = torch.empty((B, 2, 2, Hc, Wc), dtype=torch.uint8, device=dev)
    return _launch("mc_chroma", (dpb_c, mv, refslot, cvoff), out, B, S,
                   mb_w, mb_h)
