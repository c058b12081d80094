"""Wrapper of the inter combine kernel K10 (csrc/inter_combine.cu).

Replaces no pallas_call: the reference weights and combines the lists'
predictions and adds the residual in XLA
(arrow_h264_tpu/ops/pallas/mc_kernel.py::_mc_combine, with
models/pipeline.py::resolve_weights and _post_mc's add and clip), fused
into its one jitted decode.  The plain version is ops/inter.py::
inter_init_plain, ~150 eager torch launches a call; the kernel is one
launch, a thread a 4x4 cell, that looks each cell's weights up in the
per-slice tables (wtab, slogwd at slice_id and refidx) or, for a dense
upload (abi["wp"]), in wp/logwd, and reads and writes each row of a cell
as one access (`ALIGN`: the alignment each tensor's address must have).
"""

from __future__ import annotations

import torch

from ..abi import MAX_SLICES
from ..inter import inter_init_plain
from . import LAUNCHES, build, cuda_device, require

WTAB_LANE = (MAX_SLICES, 33, 33, 3, 4)     # a lane's weight table
# the bytes each tensor's address must be a multiple of: a row of a cell
# is a 4-byte luma and a 2-byte chroma prediction load, a 16-byte luma
# and an 8-byte chroma residual load and store; a cell's refslot and
# refidx pairs and an MB's logwd or slogwd pair are 8-byte loads, its 12
# weight words three 16-byte loads
ALIGN = {"pred_y": 4, "pred_c": 2, "res_y": 16, "res_cb": 8, "res_cr": 8,
         "refslot": 8, "refidx": 8, "wtab": 16, "wp": 16, "slogwd": 8,
         "logwd": 8}


def _wtab_stride(wtab, B: int, dev) -> int:
    """wtab's lane stride in elements: a full [B, ...] table, or one
    table expanded over the lanes (stride 0, as ops/wire.py::unpack_wire
    gives it when no lane ships weights)."""
    require(wtab[:1], "wtab", torch.int32, (1,) + WTAB_LANE, dev)
    if wtab.shape[0] != B:
        raise ValueError(f"wtab: {wtab.shape[0]} lanes, expected {B}")
    return wtab.stride(0) if B > 1 else 0


def inter_combine(abi, pred_y, pred_c, res_y, res_cb, res_cr, mb_w: int,
                  mb_h: int):
    """ops/inter.py::inter_init_plain of [B] pictures: pred_y [B, 2, H, W]
    and pred_c [B, 2, 2, H/2, W/2] uint8 (K3's and K4's lists), the
    residual planes int32 -> (init_y, init_cb, init_cr) int32, clip(the
    weighted prediction + residual, 0, 255) on inter MBs and 0 elsewhere.
    On a CUDA device one launch of K10, on the CPU the plain version."""
    dev = cuda_device(pred_y)
    if dev is None:
        return inter_init_plain(abi, pred_y, pred_c, res_y, res_cb, res_cr,
                                mb_w, mb_h)
    B = pred_y.shape[0]
    n = mb_w * mb_h
    H, W = 16 * mb_h, 16 * mb_w
    require(pred_y, "pred_y", torch.uint8, (B, 2, H, W), dev)
    require(pred_c, "pred_c", torch.uint8, (B, 2, 2, H // 2, W // 2), dev)
    require(res_y, "res_y", torch.int32, (B, H, W), dev)
    for k, t in (("res_cb", res_cb), ("res_cr", res_cr)):
        require(t, k, torch.int32, (B, H // 2, W // 2), dev)
    require(abi["kind"], "kind", torch.int32, (B, n), dev)
    require(abi["refslot"], "refslot", torch.int32, (B, n, 4, 4, 2), dev)
    dense = "wp" in abi or "wtab" not in abi
    if dense:
        require(abi["wp"], "wp", torch.int32, (B, n, 4, 4, 2, 3, 2), dev)
        require(abi["logwd"], "logwd", torch.int32, (B, n, 2), dev)
        tables = [None] * 4 + [abi["wp"].data_ptr(),
                               abi["logwd"].data_ptr()]
        stride = 0
    else:
        stride = _wtab_stride(abi["wtab"], B, dev)
        require(abi["slogwd"], "slogwd", torch.int32, (B, MAX_SLICES, 2),
                dev)
        require(abi["slice_id"], "slice_id", torch.int32, (B, n), dev)
        require(abi["refidx"], "refidx", torch.int32, (B, n, 4, 4, 2), dev)
        tables = [abi[k].data_ptr() for k in ("wtab", "slogwd", "slice_id",
                                              "refidx")] + [None, None]
    named = {"pred_y": pred_y, "pred_c": pred_c, "res_y": res_y,
             "res_cb": res_cb, "res_cr": res_cr}
    named.update((k, abi[k]) for k in ("refslot",) + (
        ("wp", "logwd") if dense else ("wtab", "slogwd", "refidx")))
    for k, t in named.items():
        if t.data_ptr() % ALIGN[k]:
            raise ValueError(f"inter_combine: {k} at address "
                             f"{t.data_ptr()}, not a multiple of "
                             f"{ALIGN[k]} bytes")
    if stride % 4:
        raise ValueError(f"inter_combine: wtab lane stride {stride}, not a "
                         "multiple of 16 bytes")
    out = (torch.empty((B, H, W), dtype=torch.int32, device=dev),
           *(torch.empty((B, H // 2, W // 2), dtype=torch.int32, device=dev)
             for _ in range(2)))
    ptrs = [t.data_ptr() for t in (pred_y, pred_c, res_y, res_cb, res_cr,
                                   abi["kind"], abi["refslot"])] + \
        tables + [t.data_ptr() for t in out]
    fn = build.function("inter_combine_launch", len(ptrs), 5)
    with torch.cuda.device(dev):
        err = fn(*ptrs, stride, B, mb_w, mb_h, int(dense),
                 torch.cuda.current_stream().cuda_stream)
    build.check("inter_combine_launch", err)
    LAUNCHES["inter_combine"] += 1
    return out
