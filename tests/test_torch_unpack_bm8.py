"""K8, the wire's bm8 expansion kernel (csrc/unpack_bm8.cu), on the CPU.

`chunked_scan` is a numpy model of the kernel's three launches: chunk
totals of kThreads x kRowsPerThread rows (constants parsed from the .cu,
or smaller ones, so that chunk boundaries cut every lane), each row's
first value position from the totals before its chunk and the exclusive
scan of its thread's rows, and the dense rows through the row map.  It
must equal the port's plain ops/wire.py::_scatter_bm8, the JAX package's
_scatter_bm8 lane by lane and the host's ops/wire.py::_expand_bm8_np.
Every comparison is exact (atol 0).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu.ops import wire as jwire
from arrow_h264_tpu_torch.ops import wire
from arrow_h264_tpu_torch.ops.kernels import LAUNCHES
from arrow_h264_tpu_torch.ops.kernels.unpack_bm8 import unpack_bm8

CU = (Path(wire.__file__).resolve().parents[1] / "csrc" /
      "unpack_bm8.cu").read_text()
THREADS, ROWS = (int(re.search(rf"constexpr int {k} = (\d+);", CU)[1])
                 for k in ("kThreads", "kRowsPerThread"))
# (threads a block, rows a thread): the kernel's, and small chunks
CHUNKINGS = [(THREADS, ROWS), (4, 3), (1, 1)]


def chunked_scan(idx, bm, vals, grid: int, w: int, threads: int = THREADS,
                 rows: int = ROWS) -> np.ndarray:
    """The kernel's three launches over numpy idx [B, br] int32, bm [B,
    br, bmw] uint16, vals [B, bv] int8 -> [B, grid, w] int32."""
    B, br, bmw = bm.shape
    bv = vals.shape[1]
    chunk = threads * rows
    chunks = -(-br // chunk)
    words = bm.astype(np.uint64)
    bits = sum(words[..., i] << np.uint64(16 * i) for i in range(bmw))
    if w < 64:
        bits &= np.uint64((1 << w) - 1)
    bitmat = (bits[..., None] >> np.arange(64, dtype=np.uint64)) & 1
    pop = bitmat.sum(-1).astype(np.int64)                      # [B, br]
    # 1. sums: each chunk's set bits; the row map filled with -1
    padded = np.zeros((B, chunks * chunk), np.int64)
    padded[:, :br] = pop
    by_thread = padded.reshape(B, chunks, threads, rows).sum(-1)
    sums = by_thread.sum(-1)                                   # [B, chunks]
    rowmap = np.full((B, grid), -1, np.int64)
    # 2. offsets: the chunks before, the thread's exclusive prefix, then
    # the thread's own rows in order; the row map entered
    before = np.cumsum(sums, 1) - sums
    excl = np.cumsum(by_thread, 2) - by_thread
    in_thread = np.cumsum(padded.reshape(B, chunks, threads, rows), 3) - \
        padded.reshape(B, chunks, threads, rows)
    first = (before[:, :, None, None] + excl[..., None] + in_thread) \
        .reshape(B, -1)[:, :br]
    for b in range(B):
        ok = (idx[b] >= 0) & (idx[b] < grid)
        rowmap[b, idx[b][ok]] = np.arange(br)[ok]
    # 3. expand: word k of dense row g
    out = np.zeros((B, grid, w), np.int32)
    for b in range(B):
        g = np.nonzero(rowmap[b] >= 0)[0]
        j = rowmap[b, g]
        set_ = bitmat[b, j, :w].astype(bool)                   # [rows, w]
        pos = first[b, j][:, None] + np.cumsum(set_, 1) - set_
        v = vals[b].astype(np.int32)[np.minimum(pos, bv - 1)]
        out[b, g] = np.where(set_, v, 0)
    return out


def _case(name: str, w: int, B: int, seed: int):
    """(idx, bm, vals, grid) numpy: B lanes of one class, as the wire
    ships them (rows of nonzero blocks, then padding rows at idx ==
    grid), with what `name` asks for."""
    rng = np.random.default_rng(seed)
    bmw = (w + 15) // 16
    grid = {"small": 40, "cut": 3000}.get(name, 700)
    br = {"small": 32, "cut": 2500}.get(name, 600)
    counts = rng.integers(br // 3, br, B)          # lanes' real rows differ
    counts[0] = br                                 # one lane has no padding
    idx = np.full((B, br), grid, np.int32)
    bm = rng.integers(0, 1 << 16, (B, br, bmw)).astype(np.uint16)
    for b, k in enumerate(counts):
        idx[b, :k] = np.sort(rng.choice(grid, k, replace=False))
        bm[b, k:] = 0                              # padding rows are empty
    if name == "full_and_empty":
        bm[:, ::3] = 0xFFFF
        bm[:, 1::3] = 0
    if name == "dirty_padding":                    # padding bits still count
        bm[:, -5:] = rng.integers(1, 1 << 16, (B, 5, bmw))
    if name == "unsorted":
        for b in range(B):
            perm = rng.permutation(br)
            idx[b], bm[b] = idx[b, perm], bm[b, perm]
    need = int(max(((bm[b, :, :, None] >> np.arange(16)) & 1)
                   .reshape(br, -1)[:, :w].sum() for b in range(B)))
    bv = need if name == "clamped" else need + int(rng.integers(0, 40))
    if name == "clamped":                          # positions past the end
        bv = max(1, need // 2)
    vals = rng.integers(-128, 128, (B, bv)).astype(np.int8)
    return idx, bm, vals, grid


CASES = ["random", "small", "cut", "full_and_empty", "dirty_padding",
         "unsorted", "clamped"]


@pytest.mark.parametrize("chunking", CHUNKINGS, ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("w", [8, 16, 64])
@pytest.mark.parametrize("name", CASES)
def test_chunked_scan(name, w, chunking):
    B = 3
    idx, bm, vals, grid = _case(name, w, B, seed=100 * CASES.index(name) + w)
    got = chunked_scan(idx, bm, vals, grid, w, *chunking)
    t = (torch.from_numpy(idx), torch.from_numpy(bm.view(np.int16)),
         torch.from_numpy(vals))
    plain = wire._scatter_bm8(*t, grid, w)
    assert plain.dtype == torch.int32 and plain.shape == (B, grid, w)
    assert np.array_equal(got, plain.numpy())
    before = dict(LAUNCHES)
    wrapped = unpack_bm8(*t, grid, w)
    assert LAUNCHES == before                  # CPU tensors: plain version
    assert torch.equal(wrapped, plain)
    for b in range(B):
        want = jwire._scatter_bm8(jnp.asarray(idx[b]), jnp.asarray(bm[b]),
                                  jnp.asarray(vals[b]), grid, w)
        assert np.array_equal(got[b], np.asarray(want)), f"lane {b} vs JAX"
        if name != "clamped":                  # the host's needs no clamp
            assert np.array_equal(got[b], wire._expand_bm8_np(
                idx[b], bm[b], vals[b], grid, w)), f"lane {b} vs host"
    if name == "cut":
        assert idx.shape[1] > THREADS * ROWS   # the kernel's chunks cut it


def test_unpack_wire_sections_on_cpu():
    """unpack_wire's bm8 sections are strided views of the wire buffer:
    the wrapper on them equals the plain version on copies."""
    B, n, w, br, bv = 3, 20, 16, 32, 64
    rng = np.random.default_rng(5)
    idx = np.stack([np.sort(rng.choice(n * 16, br, replace=False))
                    for _ in range(B)]).astype(np.int32)
    bm = rng.integers(0, 1 << 16, (B, br, 1)).astype(np.uint16)
    vals = rng.integers(-128, 128, (B, bv)).astype(np.int8)
    total = 4 * br + 2 * br + bv + 24
    buf = torch.zeros((B, total), dtype=torch.uint8)
    buf[:, :4 * br] = torch.from_numpy(idx.view(np.uint8).reshape(B, -1))
    buf[:, 4 * br:6 * br] = torch.from_numpy(bm.view(np.uint8)
                                             .reshape(B, -1))
    buf[:, 6 * br:6 * br + bv] = torch.from_numpy(vals.view(np.uint8))
    views = (buf[:, :4 * br].view(torch.int32),
             buf[:, 4 * br:6 * br].view(torch.int16).reshape(B, br, 1),
             buf[:, 6 * br:6 * br + bv].view(torch.int8))
    assert not views[0].is_contiguous()
    want = wire._scatter_bm8(*(v.contiguous() for v in views), n * 16, w)
    assert torch.equal(unpack_bm8(*views, n * 16, w), want)
    assert np.array_equal(chunked_scan(idx, bm, vals, n * 16, w),
                          want.numpy())
