"""The memory plan of the per-MB deblocking body
(arrow_h264_tpu_torch/csrc/deblock_mb.cuh), on the CPU.  The tile layout
is parsed from the header and checked (alignment of the staged rows, no
overlap, the banks of a pass's lanes); then a numpy replay of the body
runs over random planes and random tables: each MB part stages its own
samples before its wait (taken from the kernel's input), gathers only
its border after it (K6 carries the left border from the MB before),
filters its tile with ops/deblock.py's filters, vertical edges first, and
writes back only the region the header declares.  The MBs run in steps
that model the kernels' schedules: K2's knight phases, both parts, and
K6's row pipeline with the lag of 2, where every MB of a step runs at the
same time as the others.  The replay must equal deblock_filter_planes
byte for byte; no MB may stage samples that an MB of an earlier or of its
own step writes, and no two MBs of one step may touch a sample that one
of them writes."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from arrow_h264_tpu_torch.ops.deblock import (
    _filter_chroma, _filter_luma, deblock_filter_planes,
)
from arrow_h264_tpu_torch.ops.synthetic import random_deblock_tables

HEADER = Path(__file__).resolve().parents[1] / "arrow_h264_tpu_torch" / \
    "csrc" / "deblock_mb.cuh"
SIZES = [(7, 5), (1, 1), (1, 6), (6, 1)]
B = 2


def header_consts() -> dict:
    """The `constexpr int` names of the header and their values."""
    const = {}
    for decl in re.findall(r"constexpr int (.*?);", HEADER.read_text(),
                           re.S):
        for name, expr in re.findall(r"(\w+) = ([^,]+)", decl):
            const[name] = eval(expr, {}, dict(const))
    return const


C = header_consts()


def test_tile_layout():
    """The tiles fit the buffer and do not overlap, the MB's rows start
    8-byte aligned (8-byte cp.async) and the border words 4-byte aligned;
    each word load of a vertical pass puts its 16 lanes on 16 banks; the
    table words sit where `stage` copies the tables' rows."""
    LS, LX, CS, CX, CP = (C[k] for k in ("LS", "LX", "CS", "CX", "CP"))
    assert C["LROWS"] == 20 and C["CROWS"] == 10
    assert LX >= 4 and LX + 16 <= LS and CX >= 4 and CX + 8 <= CS
    assert C["CROWS"] * CS <= CP and CP + C["CROWS"] * CS <= C["TILE_BYTES"]
    assert C["TILE_BYTES"] >= C["LROWS"] * LS and C["TILE_BYTES"] % 16 == 0
    for r in range(16):
        assert ((4 + r) * LS + LX) % 8 == 0 and (LX - 4) % 4 == 0
    for p in range(2):
        for r in range(8):
            assert (p * CP + (2 + r) * CS + CX) % 8 == 0 and (CX - 4) % 4 == 0
    luma = [((4 + k) * LS + LX - 4) // 4 for k in range(16)]
    chroma = [((k >> 3) * CP + (2 + (k & 7)) * CS + CX - 4) // 4
              for k in range(16)]
    for rows, words in ((luma, 5), (chroma, 3)):
        for j in range(words):
            assert len({(w + j) % 32 for w in rows}) == 16
    luma_tab = ("BSV", 16), ("TCV", 16), ("BSH", 16), ("TCH", 16), \
        ("AV", 4), ("BV", 4), ("AH", 4), ("BH", 4)
    chroma_tab = ("BSC", 16), ("TCC", 32), ("AC", 8), ("BC", 8)
    for tab in (luma_tab, chroma_tab):
        at = 0
        for name, words in tab:
            assert C["T_" + name] == at
            at += words
        assert at <= C["TAB_WORDS"]


def _filter_lines(lines, q, filt, half, bs, tc0, alpha, beta):
    """Filter the edge before sample q of each line (int32 [L, n]) in
    place with ops/deblock.py's filter."""
    t = torch.from_numpy(lines)
    p_new, q_new = filt(t[:, q - half:q], t[:, q:q + half],
                        *(torch.as_tensor(np.asarray(x)) for x in
                          (bs, tc0, alpha, beta)))
    lines[:, q - half:q] = p_new.numpy()
    lines[:, q:q + half] = q_new.numpy()


class Replay:
    """The kernels' body on numpy planes [B, H, W] (luma) and
    [2, B, H/2, W/2] (Cb, Cr), the tiles as byte arrays of TILE_BYTES."""

    def __init__(self, planes, tables, mb_w, mb_h):
        self.y = planes[0].copy()
        self.c = np.stack([planes[1], planes[2]])
        self.input = (self.y.copy(), self.c.copy())
        self.t = {k: v for k, v in tables.items()}
        self.mb_w, self.mb_h = mb_w, mb_h

    # regions: sets of (plane, b, y, x), plane 0 luma, 1 Cb, 2 Cr
    def own(self, part, b, mx, my):
        if part == 0:
            return {(0, b, 16 * my + r, 16 * mx + c)
                    for r in range(16) for c in range(16)}
        return {(1 + p, b, 8 * my + r, 8 * mx + c)
                for p in range(2) for r in range(8) for c in range(8)}

    def border(self, part, b, mx, my, carried):
        """What `gather` reads from the planes."""
        n, m = (16, 4) if part == 0 else (8, 2)
        planes = (0,) if part == 0 else (1, 2)
        out = set()
        for p in planes:
            if mx > 0 and not carried:
                out |= {(p, b, n * my + r, n * mx - 1 - c)
                        for r in range(n) for c in range(m)}
            if my > 0:
                out |= {(p, b, n * my - 1 - r, n * mx + c)
                        for r in range(m) for c in range(n)}
        return out

    def written(self, part, b, mx, my):
        """What `store` writes: the MB, the left MB's right columns (a
        4-byte word, chroma 2 bytes, a row) and the top MB's bottom rows
        that the horizontal edge 0 changes (3, chroma 1)."""
        n, m, top = (16, 4, 3) if part == 0 else (8, 2, 1)
        planes = (0,) if part == 0 else (1, 2)
        out = self.own(part, b, mx, my)
        for p in planes:
            if mx > 0:
                out |= {(p, b, n * my + r, n * mx - 1 - c)
                        for r in range(n) for c in range(m)}
            if my > 0:
                out |= {(p, b, n * my - 1 - r, n * mx + c)
                        for r in range(top) for c in range(n)}
        return out

    def stage(self, part, b, mx, my):
        """A fresh tile with the MB's own samples from the kernel's input,
        and the MB's table rows."""
        tile = np.full(C["TILE_BYTES"], 0xAB, np.uint8)   # never read
        y_in, c_in = self.input
        if part == 0:
            for r in range(16):
                o = (4 + r) * C["LS"] + C["LX"]
                tile[o:o + 16] = y_in[b, 16 * my + r, 16 * mx:16 * mx + 16]
        else:
            for p in range(2):
                for r in range(8):
                    o = p * C["CP"] + (2 + r) * C["CS"] + C["CX"]
                    tile[o:o + 8] = c_in[p, b, 8 * my + r, 8 * mx:8 * mx + 8]
        m = my * self.mb_w + mx
        return tile, {k: v[b, m] for k, v in self.t.items()}

    def gather(self, tile, part, b, mx, my, carried):
        LS, LX, CS, CX, CP = (C[k] for k in ("LS", "LX", "CS", "CX", "CP"))
        if part == 0:
            for r in range(16):
                o = (4 + r) * LS + LX
                if not carried:
                    tile[o - 4:o] = self.y[b, 16 * my + r,
                                           16 * mx - 4:16 * mx] \
                        if mx > 0 else 0
            for j in range(4):
                o = j * LS + LX
                tile[o:o + 16] = self.y[b, 16 * my - 4 + j,
                                        16 * mx:16 * mx + 16] \
                    if my > 0 else 0
            return
        for p in range(2):
            for r in range(8):
                o = p * CP + (2 + r) * CS + CX
                if not carried:
                    tile[o - 2:o] = self.c[p, b, 8 * my + r,
                                           8 * mx - 2:8 * mx] \
                        if mx > 0 else 0
            for j in range(2):
                o = p * CP + j * CS + CX
                tile[o:o + 8] = self.c[p, b, 8 * my - 2 + j,
                                       8 * mx:8 * mx + 8] if my > 0 else 0

    def filter(self, tile, part, tab):
        """The vertical pass on the tile's rows, then the horizontal pass
        on its columns: lines of tile bytes, each pass's edges in order."""
        LS, LX, CS, CX, CP = (C[k] for k in ("LS", "LX", "CS", "CX", "CP"))
        if part == 0:
            passes = (
                # (line -> byte indices, bS, tc0, alpha, beta table names)
                ([[(4 + k) * LS + LX - 4 + i for i in range(20)]
                  for k in range(16)], "v"),
                ([[i * LS + LX + k for i in range(20)] for k in range(16)],
                 "h"))
            for idx, d in passes:
                idx = np.array(idx)
                lines = tile[idx].astype(np.int32)
                seg = np.arange(16) // 4
                for e in range(4):
                    _filter_lines(lines, 4 + 4 * e, _filter_luma, 4,
                                  tab["bs_" + d][e][seg],
                                  tab["tc_" + d][e][seg],
                                  tab["a_" + d][e], tab["b_" + d][e])
                tile[idx] = lines
            return
        for d in range(2):
            idx = np.array([[
                (k >> 3) * CP + (2 + (k & 7)) * CS + CX - 2 + i if d == 0
                else (k >> 3) * CP + i * CS + CX + (k & 7)
                for i in range(10)] for k in range(16)])
            lines = tile[idx].astype(np.int32)
            p, l = np.arange(16) >> 3, np.arange(16) & 7
            for e in range(2):
                _filter_lines(lines, 2 + 4 * e, _filter_chroma, 2,
                              tab["bs_c"][d, e][l >> 1],
                              tab["tc_c"][d, e][l >> 1, p],
                              tab["a_c"][d, e][p], tab["b_c"][d, e][p])
            tile[idx] = lines

    def store(self, tile, part, b, mx, my):
        LS, LX, CS, CX, CP = (C[k] for k in ("LS", "LX", "CS", "CX", "CP"))
        if part == 0:
            for r in range(16):
                o = (4 + r) * LS + LX
                self.y[b, 16 * my + r, 16 * mx:16 * mx + 16] = tile[o:o + 16]
                if mx > 0:
                    self.y[b, 16 * my + r, 16 * mx - 4:16 * mx] = \
                        tile[o - 4:o]
            for j in range(1, 4) if my > 0 else ():
                o = j * LS + LX
                self.y[b, 16 * my - 4 + j, 16 * mx:16 * mx + 16] = \
                    tile[o:o + 16]
            return
        for p in range(2):
            for r in range(8):
                o = p * CP + (2 + r) * CS + CX
                self.c[p, b, 8 * my + r, 8 * mx:8 * mx + 8] = tile[o:o + 8]
                if mx > 0:
                    self.c[p, b, 8 * my + r, 8 * mx - 2:8 * mx] = \
                        tile[o - 2:o]
            if my > 0:
                o = p * CP + CS + CX
                self.c[p, b, 8 * my - 1, 8 * mx:8 * mx + 8] = tile[o:o + 8]

    def carry(self, tile, part):
        """K6: (indices, bytes) of the next MB's tile that get this MB's
        right columns as its left border."""
        LS, LX, CS, CX, CP = (C[k] for k in ("LS", "LX", "CS", "CX", "CP"))
        if part == 0:
            rows = [(4 + r) * LS + LX for r in range(16)]
            idx = np.array([[o - 4 + i for i in range(4)] for o in rows])
            return idx, tile[idx + 16]
        rows = [p * CP + (2 + r) * CS + CX for p in range(2)
                for r in range(8)]
        idx = np.array([[o - 2 + i for i in range(2)] for o in rows])
        return idx, tile[idx + 8]


def _schedule(kernel, mb_w, mb_h, lag=2):
    """[step] -> [(b, part, mx, my)] of the MB parts that run at once: K2
    one knight phase a step, its tickets' streams and parts; K6 each row
    worker's MB mx at the first step at which row my - 1 has finished
    min(mx + lag, mb_w) MBs and the worker has finished mx - 1."""
    steps = {}
    if kernel == "K2":
        for my in range(mb_h):
            for mx in range(mb_w):
                for b in range(B):
                    for part in range(2):
                        steps.setdefault(2 * my + mx, []).append(
                            (b, part, mx, my))
        return [steps[s] for s in sorted(steps)]
    at = np.zeros((mb_h, mb_w), np.int64)
    for my in range(mb_h):
        for mx in range(mb_w):
            after = at[my, mx - 1] + 1 if mx > 0 else 0
            if my > 0:
                after = max(after, at[my - 1, min(mx + lag, mb_w) - 1] + 1)
            at[my, mx] = after
    for my in range(mb_h):
        for mx in range(mb_w):
            for b in range(B):
                for part in range(2):
                    steps.setdefault(int(at[my, mx]), []).append(
                        (b, part, mx, my))
    return [steps[s] for s in sorted(steps)]


def _replay(kernel, mb_w, mb_h, planes, tables, lag=2):
    """Run the replay; returns (its planes, the conflicts it saw)."""
    rp = Replay(planes, tables, mb_w, mb_h)
    k6 = kernel == "K6"
    carried = {}                       # K6: (b, part, my) -> next tile
    written_before = set()
    bad = []
    for jobs in _schedule(kernel, mb_w, mb_h, lag):
        regions = []
        for b, part, mx, my in jobs:
            reads = rp.border(part, b, mx, my, k6 and mx > 0)
            regions.append((rp.own(part, b, mx, my), reads,
                            rp.written(part, b, mx, my)))
        for i, (own, reads, writes) in enumerate(regions):
            if own & written_before:
                bad.append(("staged after a write", jobs[i]))
            for j, (own2, reads2, writes2) in enumerate(regions):
                if i != j and writes & (own2 | reads2 | writes2):
                    bad.append(("same step", jobs[i], jobs[j]))
        # every MB of the step gathers before any of them stores
        tiles = []
        for b, part, mx, my in jobs:
            tile, tab = rp.stage(part, b, mx, my)
            if k6 and mx > 0:
                idx, vals = carried.pop((b, part, my))
                tile[idx] = vals
            rp.gather(tile, part, b, mx, my, k6 and mx > 0)
            tiles.append((tile, tab))
        for (b, part, mx, my), (tile, tab) in zip(jobs, tiles):
            rp.filter(tile, part, tab)
            rp.store(tile, part, b, mx, my)
            if k6 and mx + 1 < mb_w:
                carried[(b, part, my)] = rp.carry(tile, part)
        for _, _, writes in regions:
            written_before |= writes
    return (rp.y, rp.c[0], rp.c[1]), bad


def _inputs(mb_w, mb_h, seed):
    rng = np.random.default_rng(seed)
    H, W = 16 * mb_h, 16 * mb_w
    planes = [rng.integers(0, 256, s).astype(np.uint8)
              for s in ((B, H, W), (B, H // 2, W // 2), (B, H // 2, W // 2))]
    return planes, random_deblock_tables(mb_w, mb_h, B, seed)


@pytest.mark.parametrize("kernel", ["K2", "K6"])
@pytest.mark.parametrize("mb_w,mb_h", SIZES)
def test_body_replay(kernel, mb_w, mb_h):
    """The replay of K2 or K6 equals the plain version byte for byte over
    random planes and random tables (bS 0..4, tc0 0..25, alpha and beta
    0..255), and sees no conflict."""
    planes, tables = _inputs(mb_w, mb_h, 10 * mb_w + mb_h)
    got, bad = _replay(kernel, mb_w, mb_h, planes, tables)
    assert not bad, bad[:5]
    want = deblock_filter_planes(
        *(torch.from_numpy(p) for p in planes),
        {k: torch.from_numpy(v) for k, v in tables.items()}, mb_w, mb_h)
    for g, w, p in zip(got, want, planes):
        assert np.array_equal(g, w.numpy().astype(np.uint8))
    assert any((w.numpy() != p).any() for w, p in zip(want, planes))


def test_body_replay_sees_a_short_lag():
    """With a lag of one MB, the K6 replay's step holds an MB that gathers
    the top MB's bottom rows beside the top-right MB, whose vertical edge
    writes them."""
    planes, tables = _inputs(7, 5, 1)
    _, bad = _replay("K6", 7, 5, planes, tables, lag=1)
    assert any(kind == "same step" for kind, *_ in bad)
