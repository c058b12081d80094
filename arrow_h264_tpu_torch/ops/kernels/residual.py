"""Wrapper of the residual kernel K9 (csrc/residual.cu).

Replaces no pallas_call: the reference computes the residual planes in
XLA (arrow_h264_tpu/ops/transforms.py::residual_planes), fused into its
one jitted decode.  The plain version is ops/transforms.py::
residual_planes, hundreds of eager torch launches a call; the kernel is
one launch, a warp an MB, a block a strip of MBs of one MB row, each
MB's classes staged with 16-byte copies.  A coefficient class absent
from the ABI (COEFF_KEYS: the upload leaves out all-zero classes)
reaches the kernel as a null pointer and reads as zero.  A class whose
base is not 16-byte aligned (a view, or an upload that packs tensors
back to back) is taken as well: bit k of the launch's `vec` is clear for
it, and the kernel stages it a word at a time.
"""

from __future__ import annotations

import torch

from ..transforms import (
    _CQP, COEFF_KEYS, device_copy, residual_planes as residual_plain,
)
from . import LAUNCHES, build, cuda_device, require

# the coefficient classes in the C entry's order and their shapes per MB
CLASS_SHAPES = (("luma4", (16, 4, 4)), ("luma8", (4, 8, 8)),
                ("luma_dc", (4, 4)), ("chroma_dc", (2, 2, 2)),
                ("chroma_ac", (2, 2, 2, 4, 4)), ("pcm", (384,)))
# the modes the bypass DPCM reads
MODE_SHAPES = (("i4_modes", (16,)), ("i8_modes", (4,)), ("i16_mode", ()),
               ("chroma_mode", ()))
assert tuple(k for k, _ in CLASS_SHAPES) == COEFF_KEYS


def aligned_mask(classes) -> int:
    """The launch's `vec`: bit k set where class k (CLASS_SHAPES order) is
    present and its base is 16-byte aligned, so that the kernel stages it
    with 16-byte copies (a word at a time otherwise)."""
    return sum(1 << i for i, t in enumerate(classes)
               if t is not None and t.data_ptr() % 16 == 0)


def residual_planes(abi, mb_w: int, mb_h: int, ws4, ws8, cqp_off=(0, 0),
                    bypass: bool = False):
    """ops/transforms.py::residual_planes of [B] pictures: on a CUDA
    device one launch of K9, on the CPU the plain version.  Returns
    (res_y [B, H, W], res_cb, res_cr [B, H/2, W/2]) int32."""
    dev = cuda_device(abi["kind"])
    if dev is None:
        return residual_plain(abi, mb_w, mb_h, ws4, ws8, cqp_off, bypass)
    B = abi["kind"].shape[0]
    n = mb_w * mb_h
    H, W = 16 * mb_h, 16 * mb_w
    for k in ("kind", "qp", "tr8"):
        require(abi[k], k, torch.int32, (B, n), dev)
    classes = [abi.get(k) for k, _ in CLASS_SHAPES]
    for t, (k, shape) in zip(classes, CLASS_SHAPES):
        if t is not None:
            require(t, k, torch.int32, (B, n) + shape, dev)
    modes = [abi[k] if bypass else None for k, _ in MODE_SHAPES]
    for t, (k, shape) in zip(modes, MODE_SHAPES):
        if t is not None:
            require(t, k, torch.int32, (B, n) + shape, dev)
    require(ws4, "ws4", torch.int32, (6, 6, 4, 4), dev)
    require(ws8, "ws8", torch.int32, (2, 6, 8, 8), dev)
    if ws4.data_ptr() % 16 or ws8.data_ptr() % 16:   # read as int4 rows
        raise ValueError("ws4, ws8: data_ptr() is not 16-byte aligned")
    cqp = device_copy(_CQP, dev)
    out = (torch.empty((B, H, W), dtype=torch.int32, device=dev),
           *(torch.empty((B, H // 2, W // 2), dtype=torch.int32, device=dev)
             for _ in range(2)))
    ptrs = [abi[k].data_ptr() for k in ("kind", "qp", "tr8")] + \
        [None if t is None else t.data_ptr() for t in classes + modes] + \
        [t.data_ptr() for t in (ws4, ws8, cqp, *out)]
    vec = aligned_mask(classes)
    fn = build.function("residual_launch", len(ptrs), 7)
    with torch.cuda.device(dev):
        err = fn(*ptrs, B, mb_w, mb_h, int(cqp_off[0]), int(cqp_off[1]),
                 int(bool(bypass)), vec,
                 torch.cuda.current_stream().cuda_stream)
    build.check("residual_launch", err)
    LAUNCHES["residual"] += 1
    return out
