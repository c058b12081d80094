"""The work orders of the persistent intra and deblock kernels: the
knight-move wavefront (csrc/intra_phase.cu, csrc/deblock_phase.cu) and
the row pipeline (csrc/intra_raster.cu, csrc/deblock_raster.cu).

MB (mx, my) of a frame depends on MBs of smaller knight phase 2*my + mx
only: its left (phase - 1), top-right (phase - 1), top (phase - 2) and
top-left (phase - 3) neighbours.  `wavefront_order` lists the MBs of one
frame sorted by phase, then by row, so a kernel that hands out its work
in that order (tickets) never waits on an MB that no running block holds.
The row-pipelined kernels hand out whole MB rows, in row order, and need
no order table (`row_args`).
"""

from __future__ import annotations

import numpy as np
import torch

_orders: dict = {}


def wavefront_order(mb_w: int, mb_h: int) -> np.ndarray:
    """[mb_w * mb_h] int32 MB indices (my * mb_w + mx) in knight-phase
    order 2 * my + mx, rows ascending within a phase."""
    my, mx = np.divmod(np.arange(mb_w * mb_h), mb_w)
    return np.lexsort((my, 2 * my + mx)).astype(np.int32)


def wavefront_args(B: int, mb_w: int, mb_h: int, device,
                   parts: int = 1) -> tuple:
    """(order, scratch) for one launch of a persistent wavefront kernel:
    the order table, cached on `device` per frame size, and an
    uninitialised int32 scratch of parts * B * n ready flags (one set per
    part of an MB that the kernel chains on its own) plus the ticket
    counter, which the kernel's C entry zeroes on the launch stream."""
    key = (mb_w, mb_h, device)
    if key not in _orders:
        _orders[key] = torch.from_numpy(wavefront_order(mb_w, mb_h)) \
            .to(device)
    scratch = torch.empty(parts * B * mb_w * mb_h + 1, dtype=torch.int32,
                          device=device)
    return _orders[key], scratch


def row_args(B: int, mb_h: int, device, parts: int = 1) -> tuple:
    """(scratch,) for one launch of a row-pipelined kernel: an
    uninitialised int32 scratch of parts * B * mb_h row progress counters
    (MBs finished, one per part, stream and MB row) plus the ticket
    counter, which the kernel's C entry zeroes on the launch stream."""
    return (torch.empty(parts * B * mb_h + 1, dtype=torch.int32,
                        device=device),)
