"""K11, the reference store kernel (csrc/store_ref.cu), on the CPU.

`thread_program` is a model of the kernel in numpy: block by block (a
tile of TILE_H x TILE_W samples of a padded luma or chroma plane of one
storing lane) and thread by thread (16 columns of ROWS_T rows), it
stages the picture rows and 16-byte column groups the tile's filters
reach (interior groups as 16-byte copies, or byte by byte for a lane off
16-byte alignment; outside groups as the replicated edge sample) into a
poisoned array shaped as the .cu's shared memory (constants parsed from
the .cu), walks each thread's six-row window down its rows (h1 of its
21 columns, then G, b, h and j), and writes each 16-byte row piece of
each plane once, checking every access's alignment; chroma tiles copy
8-byte halves, stored as 16 bytes (even mb_w) or as 8-byte pieces.  It must equal the port's plain ops/inter.py::store_refs_plain
on DPBs full of other pictures (lanes and slots that do not store stay
as they were), and both must equal the JAX package's store_ref_fn,
carried over by convert.py::dpb_from_jax.  Every comparison is exact.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu.models import pipeline as jp
from arrow_h264_tpu_torch import convert
from arrow_h264_tpu_torch.models import pipeline as tp
from arrow_h264_tpu_torch.ops import inter as ti
from arrow_h264_tpu_torch.ops.kernels import LAUNCHES, lane_stride
from arrow_h264_tpu_torch.ops.kernels.store_ref import store_refs

SRC = (Path(__file__).resolve().parent.parent / "arrow_h264_tpu_torch" /
       "csrc" / "store_ref.cu").read_text()


def _const(name):
    """A constexpr int of the .cu, its expression evaluated over the
    constants parsed before it."""
    expr = re.search(rf"\b{name} = ([^,;]+)[,;]", SRC).group(1)
    CONSTS[name] = eval(expr.replace("/", "//"), {}, dict(CONSTS))
    return CONSTS[name]


CONSTS: dict = {}
PAD, PADC = _const("kPad"), _const("kPadC")
TILE_W, TILE_H, ROWS_T = _const("kTileW"), _const("kTileH"), _const("kRowsT")
THREADS_X = _const("kThreadsX")
STAGE_H, STAGE_W = _const("kStageH"), _const("kStageW")
GROUPS = _const("kGroups")
TAPS = (1, -5, 20, 20, -5, 1)
GRIDS = [(4, 3), (5, 2), (1, 1)]


def _tap6(v, axis):
    """The 6-tap along `axis` of v (its length there less 5 out)."""
    n = v.shape[axis] - 5
    return sum(c * np.take(v, np.arange(k, k + n), axis)
               for k, c in enumerate(TAPS))


def _addr(t: np.ndarray) -> int:
    return t.__array_interface__["data"][0]


def thread_program(dpb_y, dpb_c, lanes, slots, y, cb, cr):
    """store_refs_kernel, block by block and thread by thread, in place
    on numpy DPBs: dpb_y [B, S, 4, Hp, Wp], dpb_c [B, S, 2, Hcp, Wcp]
    uint8 (16-byte aligned, as the wrapper requires); y, cb, cr the
    pictures [B, H, W] / [B, H/2, W/2], lanes a row stride apart.  Every
    16-byte (8-byte) access is checked for its alignment, every read of
    shared memory for a staged byte, and every written byte of a storing
    slot for being written once."""
    H, W = y.shape[1:]
    Hp, Wp = H + 2 * PAD, W + 2 * PAD
    Hc, Wc = H // 2, W // 2
    Hcp, Wcp = Hc + 2 * PADC, Wc + 2 * PADC
    tiles_x, tiles_y = -(-Wp // TILE_W), -(-Hp // TILE_H)
    tiles_cx, tiles_cy = -(-Wcp // TILE_W), -(-Hcp // TILE_H)
    assert _addr(dpb_y) % 16 == 0 and _addr(dpb_c) % 16 == 0
    plane_y, plane_c = Hp * Wp, Hcp * Wcp
    threads = [divmod(i, THREADS_X)[::-1] for i in
               range(THREADS_X * TILE_H // ROWS_T)]       # (tx, ty)
    for lane, slot in zip(lanes, slots):
        written_y = np.zeros((4, Hp, Wp), np.int64)
        written_c = np.zeros((2, Hcp, Wcp), np.int64)
        for tile in range(tiles_x * tiles_y + 2 * tiles_cx * tiles_cy):
            if tile >= tiles_x * tiles_y:              # chroma
                t = tile - tiles_x * tiles_y
                per = tiles_cx * tiles_cy
                pl = t // per
                src = (cr if pl else cb)[lane]
                vec = _addr(src) % 8 == 0
                wide, out = Wcp % 16 == 0, dpb_c[lane, slot, pl]
                for tx, ty in threads:
                    r0 = (t % per) // tiles_cx * TILE_H + ty * ROWS_T
                    c = (t % per) % tiles_cx * TILE_W + 16 * tx
                    if c >= Wcp:
                        continue
                    two = c + 8 < Wcp
                    for r in range(r0, min(r0 + ROWS_T, Hcp)):
                        row = src[min(max(r - PADC, 0), Hc - 1)]
                        halves = []
                        for x in (c - PADC, c - PADC + 8)[:1 + two]:
                            assert x % 8 == 0
                            if x < 0 or x >= Wc:       # a replicated edge
                                halves.append(np.full(8, row[0 if x < 0
                                                             else Wc - 1]))
                            else:
                                assert x + 8 <= Wc
                                assert not vec or _addr(row[x:]) % 8 == 0
                                halves.append(row[x:x + 8])
                        at = ((lane * dpb_c.shape[1] + slot) * 2 + pl) \
                            * plane_c + r * Wcp + c
                        # one 16-byte store, or 8-byte ones (odd mb_w)
                        assert at % (16 if wide else 8) == 0
                        v = np.concatenate(halves)
                        out[r, c:c + v.size] = v
                        written_c[pl, r, c:c + v.size] += 1
                continue
            r0, c0 = tile // tiles_x * TILE_H, tile % tiles_x * TILE_W
            src = y[lane]
            vec = _addr(src) % 16 == 0
            # staging: a 16-byte group of a picture row, or a replicated
            # edge sample, into shared memory poisoned with -1
            s_y = np.full((STAGE_H, STAGE_W), -1, np.int64)
            for i in range(STAGE_H * GROUPS):
                rr, g = divmod(i, GROUPS)
                row = src[min(max(r0 - PAD - 2 + rr, 0), H - 1)]
                x = c0 - PAD - 16 + 16 * g
                if 0 <= x < W:
                    assert x + 16 <= W
                    assert not vec or _addr(row[x:]) % 16 == 0
                    s_y[rr, 16 * g:16 * g + 16] = row[x:x + 16]
                else:
                    s_y[rr, 16 * g:16 * g + 16] = row[0 if x < 0 else W - 1]
            out = dpb_y[lane, slot]
            for tx, ty in threads:
                c = c0 + 16 * tx
                if c >= Wp:
                    continue
                for t in range(ROWS_T):
                    r = r0 + ty * ROWS_T + t
                    if r >= Hp:
                        break
                    # the window: six staged rows, 24 bytes from 16 tx + 12
                    win = s_y[ty * ROWS_T + t:ty * ROWS_T + t + 6,
                              16 * tx + 12:16 * tx + 36]
                    taps = win[:, 2:23]
                    assert win.shape == (6, 24) and (taps >= 0).all()
                    s = taps[2]
                    h1 = _tap6(taps, 0)[0]             # 21 columns
                    b = np.clip((_tap6(s, 0) + 16) >> 5, 0, 255)
                    h = np.clip((h1[2:18] + 16) >> 5, 0, 255)
                    j = np.clip((_tap6(h1, 0) + 512) >> 10, 0, 255)
                    at = (lane * dpb_y.shape[1] + slot) * 4 * plane_y \
                        + r * Wp + c
                    assert at % 16 == 0
                    for p, v in enumerate((win[2, 4:20], b, h, j)):
                        out[p, r, c:c + 16] = v
                        written_y[p, r, c:c + 16] += 1
        assert (written_y == 1).all() and (written_c == 1).all()


def _pictures(B, H, W, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, H, W), np.uint8),
            rng.integers(0, 256, (B, H // 2, W // 2), np.uint8),
            rng.integers(0, 256, (B, H // 2, W // 2), np.uint8))


@pytest.mark.parametrize("lanes,slots", [([0], [0]), ([2, 0], [1, 2]),
                                         ([1, 2, 0], [0, 0, 1])])
@pytest.mark.parametrize("mb_w,mb_h", GRIDS)
def test_thread_program(mb_w, mb_h, lanes, slots):
    """The model and the wrapper on CPU tensors (the plain version) store
    into DPBs full of other pictures; everything else stays."""
    B, S = 3, 3
    H, W = 16 * mb_h, 16 * mb_w
    rng = np.random.default_rng(mb_w * 10 + len(lanes))
    dy = rng.integers(0, 256, (B, S, 4, H + 2 * PAD, W + 2 * PAD), np.uint8)
    dc = rng.integers(0, 256, (B, S, 2, H // 2 + 2 * PADC,
                               W // 2 + 2 * PADC), np.uint8)
    pics = _pictures(B, H, W, seed=len(lanes))
    model = (dy.copy(), dc.copy())
    thread_program(*model, lanes, slots, *pics)
    plain = (torch.from_numpy(dy.copy()), torch.from_numpy(dc.copy()))
    ti.store_refs_plain(*plain, lanes, slots,
                        *(torch.from_numpy(p) for p in pics))
    wrapped = (torch.from_numpy(dy.copy()), torch.from_numpy(dc.copy()))
    before = dict(LAUNCHES)
    store_refs(*wrapped, lanes, slots, *(torch.from_numpy(p) for p in pics))
    assert LAUNCHES == before                 # CPU tensors: plain version
    for m, p, w in zip(model, plain, wrapped):
        assert torch.equal(w, p)
        assert np.array_equal(m, p.numpy())
    stored = np.zeros((B, S), bool)
    stored[lanes, slots] = True
    assert np.array_equal(model[0][~stored], dy[~stored])


@pytest.mark.parametrize("mb_w,mb_h,pic_off", [
    (9, 3, 0), (11, 9, 0), (11, 9, 3), (10, 4, 8)])
def test_thread_program_tiles(mb_w, mb_h, pic_off):
    """Grids wider and taller than one tile, with ragged tiles on both
    axes (9 x 3 MBs: 208 x 112 padded luma samples; 11 x 9: 240 x 208),
    odd mb_w (chroma rows 8 bytes off 16-byte alignment: 8-byte
    stores), and pictures whose lanes start `pic_off` bytes past a
    16-byte boundary (3: every staging copy byte by byte; 8: luma byte
    by byte, chroma 8-byte loads)."""
    B, S = 2, 2
    H, W = 16 * mb_h, 16 * mb_w
    rng = np.random.default_rng(mb_w + pic_off)
    dy = rng.integers(0, 256, (B, S, 4, H + 2 * PAD, W + 2 * PAD), np.uint8)
    dc = rng.integers(0, 256, (B, S, 2, H // 2 + 2 * PADC,
                               W // 2 + 2 * PADC), np.uint8)
    pics = []
    for p in _pictures(B, H, W, seed=mb_h):
        buf = np.empty(p.size + 32, np.uint8)
        at = -_addr(buf) % 16 + pic_off
        pics.append(buf[at:at + p.size].reshape(p.shape))
        pics[-1][...] = p
    assert all(_addr(p) % 16 == pic_off for p in pics)
    model = (dy.copy(), dc.copy())
    thread_program(*model, [1, 0], [0, 1], *pics)
    plain = (torch.from_numpy(dy.copy()), torch.from_numpy(dc.copy()))
    store_refs(*plain, [1, 0], [0, 1], *(torch.from_numpy(p) for p in pics))
    for m, w in zip(model, plain):
        assert np.array_equal(m, w.numpy())


def test_thread_program_lane_strides():
    """Pictures that are slots of a [B, S, H, W] stack (lanes apart by
    S pictures), as the bench's reference_dpb stores them."""
    mb_w, mb_h, B, S = 5, 2, 2, 3
    H, W = 16 * mb_h, 16 * mb_w
    rng = np.random.default_rng(7)
    y = rng.integers(0, 256, (B, S, H, W), np.uint8)
    c = rng.integers(0, 256, (B, S, 2, H // 2, W // 2), np.uint8)
    dy, dc = (t.numpy() for t in tp.dpb_alloc(mb_w, mb_h, B * S, "cpu"))
    dy, dc = dy.reshape((B, S) + dy.shape[1:]), dc.reshape((B, S)
                                                           + dc.shape[1:])
    for s in range(S):
        ty, tc = torch.from_numpy(dy.copy()), torch.from_numpy(dc.copy())
        pics = (torch.from_numpy(y)[:, s], torch.from_numpy(c)[:, s, 0],
                torch.from_numpy(c)[:, s, 1])
        assert not pics[0].is_contiguous()
        store_refs(ty, tc, [0, 1], [s, s], *pics)
        thread_program(dy, dc, [0, 1], [s, s], y[:, s], c[:, s, 0],
                       c[:, s, 1])
        assert np.array_equal(ty.numpy(), dy) and \
            np.array_equal(tc.numpy(), dc)


@pytest.mark.parametrize("mb_w,mb_h", GRIDS)
def test_store_matches_jax(mb_w, mb_h):
    """Three pictures stored into three slots of each of two lanes: the
    model's DPB (and store_refs_fn's on CPU tensors) == the JAX package's
    store_ref_fn, carried over by convert.py::dpb_from_jax."""
    B, S = 2, 3
    H, W = 16 * mb_h, 16 * mb_w
    model = [t.numpy().reshape((B, S) + t.shape[1:]) for t in
             tp.dpb_alloc(mb_w, mb_h, B * S, "cpu")]
    port = [torch.from_numpy(m.copy()) for m in model]
    jax_dpbs = [jp.dpb_alloc(mb_w, mb_h, S) for _ in range(B)]
    for s in range(S):
        pics = _pictures(B, H, W, seed=20 + s)
        lanes = [1, 0] if s % 2 else [0, 1]
        thread_program(*model, lanes, [s] * B, *pics)
        tp.store_refs_fn(*port, lanes, [s] * B,
                         *(torch.from_numpy(p) for p in pics))
        for b in range(B):
            jax_dpbs[b] = jp.store_ref_fn(*jax_dpbs[b], s,
                                          *(jnp.asarray(p[b]) for p in pics))
    for b in range(B):
        want = convert.dpb_from_jax(*(np.asarray(t) for t in jax_dpbs[b]),
                                    mb_w, mb_h)
        for m, p, w in zip(model, port, want):
            assert np.array_equal(m[b], w.numpy())
            assert torch.equal(p[b], w)


@pytest.mark.parametrize("case,error", [
    ("ok", None), ("stack", None), ("device", ValueError),
    ("dtype", TypeError), ("shape", ValueError), ("lanes", ValueError),
    ("lane_layout", ValueError), ("address", ValueError)])
def test_lane_stride(case, error):
    """ops/kernels/__init__.py::lane_stride, the check that K8's and
    K11's wrappers share: lanes may lie apart (a slot of a [B, S, H, W]
    stack), but each lane must be contiguous, on the device, of the
    dtype and shape, and the address a multiple of the element size."""
    cpu = torch.device("cpu")
    t = torch.zeros((2, 3, 4, 5), dtype=torch.int16)[:, 1]   # lanes apart
    want = {"ok": (t.contiguous(), 20), "stack": (t, 60)}
    args = {"device": (t, torch.int16, (2, 4, 5), torch.device("meta")),
            "dtype": (t, torch.int32, (2, 4, 5), cpu),
            "shape": (t, torch.int16, (2, 5, 4), cpu),
            "lanes": (t, torch.int16, (3, 4, 5), cpu),
            "lane_layout": (t.transpose(1, 2), torch.int16, (2, 5, 4), cpu),
            "address": (torch.from_numpy(np.frombuffer(
                np.zeros(81, np.uint8).data, np.int16, 40, 1).reshape(
                    2, 4, 5)), torch.int16, (2, 4, 5), cpu)}
    if error is None:
        got, stride = want[case]
        assert lane_stride(got, case, torch.int16, (2, 4, 5), cpu) == stride
        return
    x, dtype, shape, dev = args[case]
    with pytest.raises(error):
        lane_stride(x, case, dtype, shape, dev)
