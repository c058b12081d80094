"""Wrapper of the deblocking-table kernel K7 (csrc/deblock_tables.cu).

Replaces no pallas_call: the reference computes the tables in XLA
(arrow_h264_tpu/ops/deblock.py::deblock_tables), fused into its one
jitted decode.  The plain version is ops/deblock.py::deblock_tables,
about 450 eager torch launches a call; the kernel is one launch, a block
a strip of 32 MBs of one lane staged in shared memory, a thread an (MB,
direction, edge), with the four constant tables of common/tables.py
passed in as device tensors.  The result has the plain version's keys,
shapes and int32 values, each table a 16-byte aligned view of one
allocation (the kernel stores 16 bytes at a time), as the deblock
kernels K2/K6 take them.
"""

from __future__ import annotations

import math

import torch

from ..deblock import (
    _ALPHA, _BETA, _CQP, _TC0, TABLE_KEYS, TABLE_SHAPES,
    deblock_tables as deblock_tables_plain,
)
from ..transforms import device_copy
from . import LAUNCHES, build, cuda_device, require

# the ABI fields the kernel reads, in its C entry's order, and their
# shapes per MB
ABI_FIELDS = (("kind", ()), ("qp", ()), ("slice_id", ()),
              ("disable_idc", ()), ("alpha_off", ()), ("beta_off", ()),
              ("tr8", ()), ("nz", (4, 4)), ("mv", (4, 4, 2, 2)),
              ("refid", (4, 4, 2)))


def deblock_tables(abi, mb_w: int, mb_h: int, cqp_off=(0, 0),
                   field: bool = False) -> dict:
    """ops/deblock.py::deblock_tables of [B] pictures: on a CUDA device
    one launch of K7, on the CPU the plain version.  The ABI fields are
    contiguous int32 [B, n, ...] in the shapes of ABI_FIELDS."""
    dev = cuda_device(abi["kind"])
    if dev is None:
        return deblock_tables_plain(abi, mb_w, mb_h, cqp_off, field)
    B = abi["kind"].shape[0]
    n = mb_w * mb_h
    ins = [abi[k] for k, _ in ABI_FIELDS]
    for t, (k, shape) in zip(ins, ABI_FIELDS):
        require(t, k, torch.int32, (B, n) + shape, dev)
    consts = [device_copy(t, dev) for t in (_ALPHA, _BETA, _TC0, _CQP)]
    sizes = [B * n * math.prod(TABLE_SHAPES[k]) for k in TABLE_KEYS]
    flat = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    out = {k: t.view((B, n) + TABLE_SHAPES[k])
           for k, t in zip(TABLE_KEYS, flat.split(sizes))}
    ptrs = [t.data_ptr() for t in ins + consts] + \
        [out[k].data_ptr() for k in TABLE_KEYS]
    fn = build.function("deblock_tables_launch", len(ptrs), 6)
    with torch.cuda.device(dev):
        err = fn(*ptrs, B, mb_w, mb_h, int(cqp_off[0]), int(cqp_off[1]),
                 int(bool(field)), torch.cuda.current_stream().cuda_stream)
    build.check("deblock_tables_launch", err)
    LAUNCHES["deblock_tables"] += 1
    return out
