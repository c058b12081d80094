"""The staging plan of the MC kernels K3 (mc_luma) and K4 (mc_chroma) in
arrow_h264_tpu_torch/csrc/mc.cu, on the CPU.

The constants (strip width, threads, piece size, shared-memory sizes) and
the luma position table are parsed from the source; a numpy replay
mirrors what each block does: it copies the strip's motion into its
shared memory at the kernel's offsets and reads each thread's slot and MV
back from there, stages each thread's pieces (per read or plane and row,
the aligned piece that holds the row's first sample and the next one
where the row runs into it; rows clamped; a piece outside the padded
plane filled with the row's edge sample) at the kernel's offsets, and
computes the predictions from the bytes it staged.  The replay checks
that no byte of shared memory is written twice, that every piece is
aligned and wholly inside or wholly outside its row, that every byte the
compute reads was staged, from the sample the plain version reads
(ops/inter.py), and that the predictions equal mc_luma_plain and
mc_chroma_plain byte for byte.  A plan one row short must fail."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from arrow_h264_tpu_torch.ops.inter import (
    LUMA_TAB, PAD, PADC, mc_chroma_plain, mc_luma_plain,
)
from tools.mc_bench import SPLITS, partitioned_motion, synthetic_motion

SOURCE = Path(__file__).resolve().parents[1] / "arrow_h264_tpu_torch" / \
    "csrc" / "mc.cu"
SIZES = [(1, 1), (7, 5), (22, 18), (6, 1)]
KINDS = ["synthetic", "partitions", "wild", "edge", "positions"]
S = 3                                    # DPB slots; refslot draws -1 .. S + 1


def source_consts() -> dict:
    """The `constexpr int` names of mc.cu and their values, and the two
    words of the luma position table."""
    text = SOURCE.read_text()
    const = {}
    for decl in re.findall(r"constexpr int (.*?);", text, re.S):
        for name, expr in re.findall(r"(\w+) = ([^,]+)", decl):
            const[name] = eval(expr, {}, dict(const))
    for name in ("kLumaLo", "kLumaHi"):
        const[name] = int(re.search(name + r" = (0x[0-9A-Fa-f]+)ull",
                                    text).group(1), 16)
    return const


C = source_consts()
SW, THREADS, PIECE = C["SW"], C["THREADS"], C["PIECE"]


def luma_entry(pos):
    """The kernel's table byte of quarter-sample positions `pos`."""
    word = np.where(pos < 8, C["kLumaLo"], C["kLumaHi"]).astype(np.uint64)
    return ((word >> (8 * (pos & 7)).astype(np.uint64)) & 0xff).astype(
        np.int64)


def motion(kind: str, mb_w: int, mb_h: int, B: int, seed: int):
    """(mv [B, n, 4, 4, 2, 2], refslot [B, n, 4, 4, 2]) int32 numpy."""
    rng = np.random.default_rng(seed)
    if kind == "partitions":
        pairs = [partitioned_motion(mb_w, mb_h, seed + b, tuple(SPLITS),
                                    n_slots=S + 2, bi_frac=0.5)
                 for b in range(B)]
    else:
        pairs = [synthetic_motion(mb_w, mb_h, seed + b, n_slots=S + 2,
                                  bi_frac=0.5) for b in range(B)]
    mv, rs = (np.stack(a) for a in zip(*pairs))
    if kind == "wild":
        mv = rng.integers(-2048, 2049, mv.shape)
    elif kind == "edge":
        near = np.array([PAD + k for k in (-3, -2, -1, 0, 1, 2, 3)])
        ints = np.concatenate([near, -near, [-512, 512, 0, 3, -5]])
        mv = rng.choice(ints, mv.shape) * 4 + rng.integers(0, 8, mv.shape)
    elif kind == "positions":
        # every (xFrac, yFrac) of 1/8 chroma samples, hence every luma
        # quarter-sample position, in turn over the cells
        k = np.arange(mv[..., 0].size).reshape(mv.shape[:-1]) % 64
        mv = (mv & ~7) | np.stack([k & 7, k >> 3], -1)
    if kind in ("wild", "edge"):
        rs = rng.integers(-1, S + 2, rs.shape)
    return mv.astype(np.int32), rs.astype(np.int32)


def dpbs(mb_w: int, mb_h: int, B: int, seed: int):
    """Random luma [B, S, 4, Hp, Wp] and chroma [B, S, 2, Hcp, Wcp] uint8
    DPBs, padding included, and random cvoff [B, S] of -2, 0 or +2."""
    rng = np.random.default_rng(seed)
    H, W = mb_h * 16, mb_w * 16
    y = rng.integers(0, 256, (B, S, 4, H + 2 * PAD, W + 2 * PAD), np.uint8)
    c = rng.integers(0, 256, (B, S, 2, H // 2 + 2 * PADC, W // 2 + 2 * PADC),
                     np.uint8)
    return y, c, (rng.integers(-1, 2, (B, S)) * 2).astype(np.int32)


class Smem:
    """The shared memory of every block [blocks, bytes], with a mask of
    the bytes written."""

    def __init__(self, blocks: int, size: int):
        self.data = np.zeros((blocks, size), np.uint8)
        self.written = np.zeros((blocks, size), bool)

    def write(self, blk, off, values):
        """Bytes `values` [..., k] at offsets off[..., None] + 0 .. k - 1 of
        blocks blk[...]."""
        offs = off[..., None] + np.arange(values.shape[-1])
        blks = np.broadcast_to(blk[..., None], offs.shape)
        assert offs.min(initial=0) >= 0 and \
            offs.max(initial=0) < self.data.shape[1]
        flat = blks * self.data.shape[1] + offs
        assert not self.written.reshape(-1)[flat].any(), "written twice"
        assert len(np.unique(flat)) == flat.size, "written twice"
        self.data.reshape(-1)[flat] = values
        self.written.reshape(-1)[flat] = True

    def read(self, blk, off):
        assert self.written[blk, off].all(), "read a byte never staged"
        return self.data[blk, off]


def threads(mb_w: int, mb_h: int, B: int):
    """Index arrays over (block, thread): block (b, my, strip) and the
    thread's (list, y4, MB of the strip, x4), as the kernels split it;
    only threads whose MB exists."""
    strips = -(-mb_w // SW)
    blk, tid = np.meshgrid(np.arange(B * mb_h * strips), np.arange(THREADS),
                           indexing="ij")
    blk, tid = blk.ravel(), tid.ravel()
    b, rest = divmod(blk, mb_h * strips)
    my, strip = divmod(rest, strips)
    t = dict(blk=blk, tid=tid, b=b, my=my, strip=strip,
             l=tid // (16 * SW), y4=(tid // (4 * SW)) & 3,
             m=(tid >> 2) % SW, x4=tid & 3)
    t["mx"] = t["strip"] * SW + t["m"]
    keep = t["mx"] < mb_w
    return {k: v[keep] for k, v in t.items()}, B * mb_h * strips


def stage_motion(smem: Smem, tile: int, mv, rs, mb_w: int, mb_h: int,
                 B: int):
    """Each block's strip of mv and refslot into its shared memory after
    the tile, as the kernel lays it out."""
    strips = -(-mb_w // SW)
    mvb = mv.reshape(B, mb_h, mb_w, -1).view(np.uint8).reshape(
        B, mb_h, mb_w, -1)
    rsb = rs.reshape(B, mb_h, mb_w, -1).view(np.uint8).reshape(
        B, mb_h, mb_w, -1)
    assert mvb.shape[-1] == C["MV_BYTES"] and rsb.shape[-1] == C["RS_BYTES"]
    for b in range(B):
        for my in range(mb_h):
            for s in range(strips):
                blk = np.array((b * mb_h + my) * strips + s)
                for j in range(min(SW, mb_w - s * SW)):
                    mx = s * SW + j
                    smem.write(blk, np.array(tile + j * C["MV_BYTES"]),
                               mvb[b, my, mx])
                    smem.write(blk, np.array(tile + SW * C["MV_BYTES"] +
                                             j * C["RS_BYTES"]),
                               rsb[b, my, mx])


def read_motion(smem: Smem, tile: int, t: dict):
    """Each thread's (slot, mvx, mvy) read back from the shared motion."""
    cell = (t["m"] * 16 + t["y4"] * 4 + t["x4"]) * 2 + t["l"]
    mv_off = tile + cell * 8
    rs_off = tile + SW * C["MV_BYTES"] + cell * 4
    word = lambda off: smem.read(t["blk"][:, None], off[:, None] +
                                 np.arange(4)).copy().view(np.int32)[:, 0]
    return word(rs_off), word(mv_off), word(mv_off + 4)


def stage_rows(smem: Smem, t: dict, sel, dst, plane_of, y0, x, rows: int,
               last: int, Hp: int, Wp: int):
    """Stage `rows` rows of one read of the threads `sel`: pieces at dst
    + ((r * 2 + p) * THREADS + tid) * PIECE; plane_of(b, y) gives rows of
    the read's plane."""
    assert Wp % PIECE == 0
    col = x & ~(PIECE - 1)
    two = (x & (PIECE - 1)) + last >= PIECE
    for r in range(rows):
        y = np.clip(y0 + r, 0, Hp - 1)
        row = plane_of(y)                                   # [n, Wp]
        for p in range(2):
            m = sel & ((p == 0) | two)
            c = col + p * PIECE
            assert (c % PIECE == 0).all()
            assert ((c < 0) | (c >= Wp) | (c + PIECE <= Wp)).all()
            cols = np.where(c[:, None] < 0, 0, np.where(
                c[:, None] >= Wp, Wp - 1, c[:, None] + np.arange(PIECE)))
            vals = np.take_along_axis(row, cols, 1)
            off = dst + ((r * 2 + p) * THREADS + t["tid"]) * PIECE
            smem.write(t["blk"][m], off[m], vals[m])


def read_row(smem: Smem, t: dict, sel, base, o, nbytes: int):
    """`nbytes` bytes from byte o of each staged row at base (its first
    piece, then its second THREADS * PIECE bytes on)."""
    q = o[:, None] + np.arange(nbytes)
    off = base[:, None] + (q >> 3) * THREADS * PIECE + (q & (PIECE - 1))
    return smem.read(t["blk"][sel, None], off[sel]).astype(np.int32)


def replay_luma(dy, mv, rs, mb_w: int, mb_h: int, rows: int = 4):
    """K3's plan over every block; returns the prediction [B, 2, H, W]."""
    B, _, _, Hp, Wp = dy.shape
    H, W = mb_h * 16, mb_w * 16
    t, blocks = threads(mb_w, mb_h, B)
    tile = THREADS * C["LCELL"]
    smem = Smem(blocks, C["LSMEM"])
    stage_motion(smem, tile, mv, rs, mb_w, mb_h, B)
    slot, vx, vy = read_motion(smem, tile, t)
    used = slot >= 0
    slot = np.clip(slot, 0, S - 1)
    e = luma_entry((vy & 3) * 4 + (vx & 3))
    t0, t1 = e & 15, e >> 4
    nread = np.where(t0 == t1, 1, 2)
    X = t["mx"] * 16 + t["x4"] * 4 + (vx >> 2) + PAD
    Y = t["my"] * 16 + t["y4"] * 4 + (vy >> 2) + PAD
    xs = []
    for k, tk in enumerate((t0, t1)):
        sel = used & (nread > k)
        xk = X + (tk >> 3)
        stage_rows(smem, t, sel, k * 8 * THREADS * PIECE,
                   lambda y, tk=tk: dy[t["b"], slot, tk & 3, y],
                   Y + ((tk >> 2) & 1), xk, rows, 3, Hp, Wp)
        xs.append(xk)
    out = np.zeros((B, 2, H, W), np.uint8)
    k1 = nread - 1
    o0, o1 = xs[0] & 7, np.where(k1 == 1, xs[1], xs[0]) & 7
    for r in range(4):
        a = read_row(smem, t, used, r * 2 * THREADS * PIECE +
                     t["tid"] * PIECE, o0, 4)
        c = read_row(smem, t, used, (k1 * 4 + r) * 2 * THREADS * PIECE +
                     t["tid"] * PIECE, o1, 4)
        yy = t["my"][used] * 16 + t["y4"][used] * 4 + r
        xx = t["mx"][used, None] * 16 + t["x4"][used, None] * 4 + \
            np.arange(4)
        out[t["b"][used, None], t["l"][used, None], yy[:, None], xx] = \
            (a + c + 1) >> 1
    return out


def replay_chroma(dc, mv, rs, cvoff, mb_w: int, mb_h: int, rows: int = 3):
    """K4's plan over every block; returns [B, 2, 2, H/2, W/2]."""
    B, _, _, Hp, Wp = dc.shape
    Hc, Wc = mb_h * 8, mb_w * 8
    t, blocks = threads(mb_w, mb_h, B)
    tile = THREADS * C["CCELL"]
    smem = Smem(blocks, C["CSMEM"] + 4 * S)
    stage_motion(smem, tile, mv, rs, mb_w, mb_h, B)
    for blk in range(blocks):        # cvoff[S] after the motion
        smem.write(np.array(blk), np.array(tile + SW * C["MOTION"]),
                   cvoff[blk // (blocks // B)].view(np.uint8))
    slot, vx, vy = read_motion(smem, tile, t)
    used = slot >= 0
    slot = np.clip(slot, 0, S - 1)
    cv_off = tile + SW * C["MOTION"] + slot * 4
    cv = smem.read(t["blk"][:, None], cv_off[:, None] + np.arange(4)) \
        .copy().view(np.int32)[:, 0]
    vy = vy + cv
    X = t["mx"] * 8 + t["x4"] * 2 + (vx >> 3) + PADC
    Y = t["my"] * 8 + t["y4"] * 2 + (vy >> 3) + PADC
    for pl in range(2):
        stage_rows(smem, t, used, pl * 6 * THREADS * PIECE,
                   lambda y, pl=pl: dc[t["b"], slot, pl, y], Y, X, rows, 2,
                   Hp, Wp)
    xf, yf, o = vx & 7, vy & 7, X & 7
    out = np.zeros((B, 2, 2, Hc, Wc), np.uint8)
    u = used
    for pl in range(2):
        q = [read_row(smem, t, u, (pl * 3 + r) * 2 * THREADS * PIECE +
                      t["tid"] * PIECE, o, 3) for r in range(3)]
        for dyy in range(2):
            for dxx in range(2):
                A, Bv = q[dyy][:, dxx], q[dyy][:, dxx + 1]
                Cv, D = q[dyy + 1][:, dxx], q[dyy + 1][:, dxx + 1]
                v = ((8 - xf[u]) * (8 - yf[u]) * A + xf[u] * (8 - yf[u]) * Bv +
                     (8 - xf[u]) * yf[u] * Cv + xf[u] * yf[u] * D + 32) >> 6
                out[t["b"][u], t["l"][u], pl,
                    t["my"][u] * 8 + t["y4"][u] * 2 + dyy,
                    t["mx"][u] * 8 + t["x4"][u] * 2 + dxx] = v
    return out


def test_constants_and_budget():
    """A thread a (list, cell), both lists of a strip of SW MBs; the
    worst-case tile (2 reads or planes x rows x 2 pieces a thread) and the
    strip's motion within the stated shared memory, below the 48 KB that
    needs an opt-in and far below the 227 KB a block may have; the
    kernel's luma position table equal to ops/inter.py's."""
    assert THREADS == SW * 2 * 16 and PIECE == 8
    assert C["LCELL"] == 2 * 4 * 2 * PIECE and C["CCELL"] == 2 * 3 * 2 * PIECE
    assert C["MV_BYTES"] == 16 * 2 * 2 * 4 and C["RS_BYTES"] == 16 * 2 * 4
    assert C["LSMEM"] == THREADS * C["LCELL"] + SW * C["MOTION"] == 35840
    assert C["CSMEM"] == THREADS * C["CCELL"] + SW * C["MOTION"] == 27648
    assert C["LSMEM"] <= 48 * 1024 and C["CSMEM"] + 4 * 33 <= 48 * 1024
    assert 0 < C["kLumaCarveout"] <= 100
    for pos in range(16):
        e = int(luma_entry(np.array(pos)))
        reads = [(r & 3, (r >> 2) & 1, r >> 3) for r in (e & 15, e >> 4)]
        tab = LUMA_TAB[pos]
        assert reads == [tuple(tab[0:3]), tuple(tab[3:6])], pos
    for mb_w in (1, 6, 7, 22, 120, 240):          # rows of whole pieces
        assert (mb_w * 16 + 2 * PAD) % PIECE == 0
        assert (mb_w * 8 + 2 * PADC) % PIECE == 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("mb_w,mb_h", SIZES)
def test_plan_equals_plain(mb_w, mb_h, B, kind):
    """The replayed plan covers every sample the plain versions read and
    gives their predictions byte for byte."""
    seed = 17 + 5 * mb_w + mb_h + B
    mv, rs = motion(kind, mb_w, mb_h, B, seed)
    dy, dc, cvoff = dpbs(mb_w, mb_h, B, seed)
    if kind == "positions" and mb_w * mb_h > 1:     # 64+ (cell, list)s
        used = rs >= 0
        assert len(np.unique((mv[..., 1] & 7) * 8 + (mv[..., 0] & 7))) == 64
        assert len(np.unique(((mv[..., 1] & 3) * 4 + (mv[..., 0] & 3))[
            used])) == 16
    if kind in ("wild", "edge"):
        assert rs.min() == -1 and rs.max() >= S
    want_y = mc_luma_plain(torch.from_numpy(dy), torch.from_numpy(mv),
                           torch.from_numpy(rs), mb_w, mb_h).numpy()
    want_c = mc_chroma_plain(torch.from_numpy(dc), torch.from_numpy(mv),
                             torch.from_numpy(rs), torch.from_numpy(cvoff),
                             mb_w, mb_h).numpy()
    np.testing.assert_array_equal(replay_luma(dy, mv, rs, mb_w, mb_h),
                                  want_y)
    np.testing.assert_array_equal(
        replay_chroma(dc, mv, rs, cvoff, mb_w, mb_h), want_c)


@pytest.mark.parametrize("kernel", ["luma", "chroma"])
def test_plan_one_row_short_fails(kernel):
    """Staging one row fewer than the kernel does leaves bytes the compute
    reads unstaged, and the replay says so."""
    mv, rs = motion("synthetic", 7, 5, 1, 3)
    dy, dc, cvoff = dpbs(7, 5, 1, 3)
    with pytest.raises(AssertionError, match="never staged"):
        if kernel == "luma":
            replay_luma(dy, mv, rs, 7, 5, rows=3)
        else:
            replay_chroma(dc, mv, rs, cvoff, 7, 5, rows=2)
