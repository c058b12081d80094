"""The tables and the I4x4 schedule of the per-MB intra body
(arrow_h264_tpu_torch/csrc/intra_mb.cuh), on the CPU: the packed 3-tap
words that the wrapper builds (ops/kernels/intra_phase.py) against the
prediction tables of ops/intra_tables.py, the table's layout against the
constants of the header, and the lane map replayed sub-step by sub-step:
every sample written once, every read of a sample of the MB after the
sub-step that wrote it, and every read outside the MB inside the border
that the body gathers."""

import re
from pathlib import Path

import numpy as np
import pytest

from arrow_h264_tpu_torch.ops.intra_tables import LINEAR_MODES, build_tables
from arrow_h264_tpu_torch.ops.kernels.intra_phase import (
    intra_tables, lane_map, pack_taps,
)

HEADER = Path(__file__).resolve().parents[1] / "arrow_h264_tpu_torch" / \
    "csrc" / "intra_mb.cuh"


def unpack(words):
    """Packed words -> (indices [..., 3], weights [..., 3], R, S)."""
    w = words.astype(np.int64)[..., None]
    k = np.arange(3)
    return (w >> 5 * k) & 31, (w >> 15 + 2 * k) & 3, \
        (words >> 21) & 3, (words >> 23) & 3


@pytest.mark.parametrize("n", [4, 8])
def test_packed_taps_give_the_tables(n):
    """(w0 v[i0] + w1 v[i1] + w2 v[i2] + R) >> S equals (W . v + R) >> S
    for every mode and sample, over random reference vectors, and the
    words hold W, R and S exactly."""
    W, S, R = build_tables(n)
    idx, wt, r, s = unpack(pack_taps(W, S, R))
    dense = np.zeros(W.shape, np.int64)
    np.add.at(dense, (np.arange(9)[:, None, None],
                      np.arange(n * n)[None, :, None], idx), wt)
    assert np.array_equal(dense, W)
    assert np.array_equal(r, R) and np.array_equal(s, S)
    v = np.random.default_rng(n).integers(0, 256, (500, 1 + 3 * n))
    for m in LINEAR_MODES:
        want = (v @ W[m].T.astype(np.int64) + R[m]) >> S[m]
        got = ((v[:, idx[m]] * wt[m]).sum(-1) + r[m]) >> s[m]
        assert np.array_equal(got, want), m
    assert not pack_taps(W, S, R)[2].any()          # DC: no taps


def test_pack_taps_refuses_more_than_three_taps():
    W, S, R = build_tables(4)
    W = W.copy()
    W[0, 0, :4] = 1
    with pytest.raises(ValueError):
        pack_taps(W, S, R)


def test_table_layout_matches_the_header():
    """intra_tables() is TAPS4 | TAPS8 | LANES at the header's offsets."""
    text = HEADER.read_text()
    decl = re.search(r"constexpr int TAPS4 = (.*?);", text, re.S).group(1)
    const = {}
    for name, expr in re.findall(r"(\w+) = ([^,]+)", decl):
        const[name] = eval(expr, {}, dict(const))
    const["TAPS4"] = 0
    t = intra_tables()
    assert t.dtype == np.int32 and t.shape == (const["TAB_WORDS"],)
    W4, S4, R4 = build_tables(4)
    W8, S8, R8 = build_tables(8)
    assert np.array_equal(t[const["TAPS4"]:const["TAPS8"]],
                          pack_taps(W4, S4, R4).ravel())
    assert np.array_equal(t[const["TAPS8"]:const["LANES"]],
                          pack_taps(W8, S8, R8).ravel())
    assert np.array_equal(t[const["LANES"]:], lane_map().ravel())


def _gathered(y, x):
    """A sample outside the MB that the body's border gather holds: the
    line above (x -1..23), the column to the left, and the right
    neighbour's lines 3, 7 and 11 (x 16..23)."""
    return (y == -1 and -1 <= x <= 23) or (x == -1 and 0 <= y < 16) or \
        (y in (3, 7, 11) and 16 <= x <= 23)


def _ref_yx(i, n, bx, by, atr):
    """MB-relative (y, x) of entry i of the reference vector of the n x n
    block at (bx, by), as the body reads it (top-right -> top[n-1]
    without atr)."""
    if i == 0:
        return by - 1, bx - 1
    if i <= 2 * n:
        j = i - 1
        return by - 1, bx + (n - 1 if j >= n and not atr else j)
    return by + i - 1 - 2 * n, bx - 1


def _check_reads(reads, done, where):
    for y, x in reads:
        if 0 <= y < 16 and 0 <= x < 16:
            assert done[y, x], (where, y, x)
        else:
            assert _gathered(y, x), (where, y, x)


def test_lane_map_is_a_schedule():
    """Replay the I4x4 warp's ten sub-steps: each lane's (block, sample)
    is written exactly once, by one lane, and every sample a lane may
    read (each directional mode's taps with atr 0 and 1, DC's lines) is
    finished in an earlier sub-step or lies in the gathered border."""
    lanes = lane_map()
    assert lanes.shape == (10, 32) and lanes.dtype == np.int32
    W, _, _ = build_tables(4)
    taps = [np.flatnonzero(W[m, q]) for m in range(9) for q in range(16)]
    taps = {(m, q): taps[16 * m + q] for m in range(9) for q in range(16)}
    done = np.zeros((16, 16), bool)
    written = []
    for s in range(10):
        now = []
        for lane in range(32):
            if lanes[s, lane] < 0:
                continue
            g, q = divmod(int(lanes[s, lane]), 16)
            x4, y4 = g & 3, g >> 2
            assert 2 * y4 + x4 == s                 # the plain version's order
            bx, by = 4 * x4, 4 * y4
            for atr in (False, True):
                reads = [(by - 1, bx + k) for k in range(4)] + \
                    [(by + k, bx - 1) for k in range(4)]    # DC
                for m in LINEAR_MODES:
                    reads += [_ref_yx(i, 4, bx, by, atr)
                              for i in taps[(m, q)]]
                _check_reads(reads, done, (s, lane))
            now.append((by + (q >> 2), bx + (q & 3)))
        for y, x in now:
            done[y, x] = True
        written += now
    assert sorted(written) == [(y, x) for y in range(16) for x in range(16)]


def test_i8x8_reads_are_gathered():
    """The four 8x8 blocks in order: every raw reference (atr 0 and 1) is
    a finished sample of the MB or lies in the gathered border."""
    done = np.zeros((16, 16), bool)
    for b8 in range(4):
        bx, by = 8 * (b8 & 1), 8 * (b8 >> 1)
        for atr in (False, True):
            _check_reads([_ref_yx(i, 8, bx, by, atr) for i in range(25)],
                         done, b8)
        done[by:by + 8, bx:bx + 8] = True
