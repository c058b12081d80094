"""Wrapper of the wire's bm8 expansion kernel K8 (csrc/unpack_bm8.cu).

Replaces no pallas_call: the reference expands the wire's bm8
coefficient sections in XLA (arrow_h264_tpu/ops/wire.py::_scatter_bm8),
inside its jitted unpack.  The plain version is ops/wire.py::
_scatter_bm8, about 15 eager torch launches a class with an int64 cumsum
over every significance bit.  One call expands every bm8 class of a wire
round (ops/kernels/unpack_wire.py::unpack_wire makes one a round that
ships any) in at most two launches (DEVICE_LAUNCHES): a chunked scan of
the rows' set bits, then the dense rows, each output word written once.
`class_table` lays the classes out as the kernel's table; it reads the
sections where they lie (a lane's row stride apart in the wire buffer),
so the wrapper copies nothing.  `unpack_bm8` is the one-class form of
the same call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..wire import _scatter_bm8
from . import LAUNCHES, build, cuda_device, lane_stride

DEVICE_LAUNCHES = 2        # kernels one call puts on the card
# csrc/unpack_bm8.cu's Bm8Class, field by field (int64 each)
FIELDS = ("idx", "bm", "vals", "s_idx", "s_bm", "s_vals", "br", "bmw", "bv",
          "grid", "w", "out", "rowmap", "first", "sums", "chunks", "tiles",
          "rows", "block1", "block2")
CHUNK = 256 * 8            # csrc/unpack_bm8.cu kChunk: kThreads x
                           # kRowsPerThread, the rows of a scan block
TILE_WORDS = 4096          # the words of an expand block (as many rows
                           # as they hold, at most TILE_ROWS)
TILE_ROWS = 512            # csrc/unpack_bm8.cu kTileRows
MAX_CHUNKS = 2048          # kMaxChunks: the chunks of a (class, lane)
MAX_CLASSES = 5            # kMaxClasses


class Table(NamedTuple):
    """K8's work for one call: `rows` [classes, len(FIELDS)] int64 (the
    kernel's table), each launch's blocks a lane, and the int32 words of
    scratch it needs."""
    rows: np.ndarray
    blocks1: int
    blocks2: int
    scratch: int


def class_table(classes, B: int) -> Table:
    """The table of `classes`, each (idx, bm, vals: byte addresses of lane
    0's sections, relative to the call's base; s_idx, s_bm, s_vals: the
    lanes' strides in bytes; br, bv, grid, w; out: the word offset of its
    [B, grid, w] output, a multiple of 4), for B lanes.  Each class's
    scratch (row map [B, grid], first positions [B, br], chunk totals [B,
    chunks]) gets its own 16-byte aligned region."""
    if len(classes) > MAX_CLASSES:
        raise ValueError(f"unpack_bm8: {len(classes)} classes, at most "
                         f"{MAX_CLASSES}")
    rows, blocks1, blocks2, scratch = [], 0, 0, 0
    for (idx, bm, vals, s_idx, s_bm, s_vals, br, bv, grid, w,
         out) in classes:
        bmw = (w + 15) // 16
        chunks = -(-br // CHUNK)
        if w % 4 or not 0 < w <= 64 or bv < 1 or grid < 0 or out % 4 \
                or max(grid * w, br * 64) >= 2**31 or chunks > MAX_CHUNKS:
            raise ValueError(f"unpack_bm8: w {w}, {br} rows, {bv} values, "
                             f"grid {grid}, output at word {out}")
        per_tile = min(TILE_WORDS // w, TILE_ROWS)
        tiles = -(-grid // per_tile)
        regions = []
        for words in (B * grid, B * br, B * chunks):
            regions.append(scratch)
            scratch += -(-words // 4) * 4
        rows.append([idx, bm, vals, s_idx, s_bm, s_vals, br, bmw, bv, grid,
                     w, out, *regions, chunks, tiles, per_tile, blocks1,
                     blocks2])
        blocks1 += chunks
        blocks2 += tiles
    table = np.array(rows, np.int64).reshape(-1, len(FIELDS))
    table.setflags(write=False)
    return Table(table, blocks1, blocks2, scratch)


def device_launches(t: Table) -> int:
    """Kernels one call on table t puts on the card: the scan where a
    class has rows, the expansion where one has dense rows."""
    return (t.blocks1 > 0) + (t.blocks2 > 0)


def launch(src: int, out, t: Table, B: int, dev) -> None:
    """K8 over the classes of table t: their sections at the addresses
    src + t's offsets, their outputs in `out` (an int32 tensor on dev,
    16-byte aligned) at t's word offsets.  One scratch allocation."""
    if not 0 <= B < 2**16 or max(t.blocks1, t.blocks2) >= 2**31:
        raise ValueError(f"unpack_bm8: {B} lanes, {t.blocks1} and "
                         f"{t.blocks2} blocks a lane")
    if out.data_ptr() % 16:
        raise ValueError("unpack_bm8: output not 16-byte aligned")
    scratch = torch.empty(max(t.scratch, 1), dtype=torch.int32, device=dev)
    fn = build.function("unpack_bm8_launch", 4, 4)
    with torch.cuda.device(dev):
        err = fn(src, out.data_ptr(), scratch.data_ptr(), t.rows.ctypes.data,
                 len(t.rows), B, t.blocks1, t.blocks2,
                 torch.cuda.current_stream().cuda_stream)
    build.check("unpack_bm8_launch", err)
    LAUNCHES["unpack_bm8"] += 1


def unpack_bm8(idx, bm, vals, grid: int, w: int):
    """ops/wire.py::_scatter_bm8 of [B] lanes: idx [B, br] int32, bm [B,
    br, (w + 15) // 16] int16 (bitmaps, masked to 16 bits), vals [B, bv]
    int8 -> dense [B, grid, w] int32.  On a CUDA device the kernel (one
    class), on the CPU the plain version."""
    dev = cuda_device(bm)
    if dev is None:
        return _scatter_bm8(idx, bm, vals, grid, w)
    B, br, bmw = bm.shape
    bv = vals.shape[1]
    if bmw != (w + 15) // 16:
        raise ValueError(f"unpack_bm8: w {w}, {bmw} bitmap words")
    strides = (lane_stride(idx, "idx", torch.int32, (B, br), dev) * 4,
               lane_stride(bm, "bm", torch.int16, (B, br, bmw), dev) * 2,
               lane_stride(vals, "vals", torch.int8, (B, bv), dev))
    t = class_table([(idx.data_ptr(), bm.data_ptr(), vals.data_ptr(),
                      *strides, br, bv, grid, w, 0)], B)
    out = torch.empty((B, grid, w), dtype=torch.int32, device=dev)
    launch(0, out, t, B, dev)
    return out
