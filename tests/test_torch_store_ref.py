"""K11, the reference store kernel (csrc/store_ref.cu), on the CPU.

`thread_program` is a model of the kernel in numpy: block by block (a
tile of TILE_H x TILE_W samples of a padded luma or chroma plane of one
storing lane), it stages the picture samples the tile's filters reach
with clamped coordinates, then the int32 horizontal 6-tap b1 of the
tile's rows and their 5-row halo, as the .cu's shared memory holds
them, and each thread's 4 samples of G, b, h and j (or of the padded
chroma).  It must equal the port's plain ops/inter.py::store_refs_plain
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
from arrow_h264_tpu_torch.ops.kernels import LAUNCHES
from arrow_h264_tpu_torch.ops.kernels.store_ref import store_refs

SRC = (Path(__file__).resolve().parent.parent / "arrow_h264_tpu_torch" /
       "csrc" / "store_ref.cu").read_text()


def _const(name):
    return int(re.search(rf"\b{name} = (\d+)[,;]", SRC).group(1))


TILE_W, TILE_H = _const("kTileW"), _const("kTileH")
PAD, PADC = _const("kPad"), _const("kPadC")
TAPS = (1, -5, 20, 20, -5, 1)
GRIDS = [(4, 3), (5, 2), (1, 1)]


def _tap6(v, axis):
    """The 6-tap along `axis` of v (its length there less 5 out)."""
    n = v.shape[axis] - 5
    return sum(c * np.take(v, np.arange(k, k + n), axis)
               for k, c in enumerate(TAPS))


def thread_program(dpb_y, dpb_c, lanes, slots, y, cb, cr):
    """store_refs_kernel, block by block, in place on numpy DPBs: dpb_y
    [B, S, 4, Hp, Wp], dpb_c [B, S, 2, Hcp, Wcp] uint8; y, cb, cr the
    pictures [B, H, W] / [B, H/2, W/2]."""
    H, W = y.shape[1:]
    Hp, Wp = H + 2 * PAD, W + 2 * PAD
    Hc, Wc = H // 2, W // 2
    Hcp, Wcp = Hc + 2 * PADC, Wc + 2 * PADC
    tiles_x, tiles_y = -(-Wp // TILE_W), -(-Hp // TILE_H)
    tiles_cx, tiles_cy = -(-Wcp // TILE_W), -(-Hcp // TILE_H)
    # each thread's (row, column of its first sample) in the tile
    ty, tx = np.divmod(np.arange(TILE_W // 4 * TILE_H), TILE_W // 4)
    cols = tx[:, None] * 4 + np.arange(4)                  # [threads, 4]
    rows = np.broadcast_to(ty[:, None], cols.shape)
    for k, (lane, slot) in enumerate(zip(lanes, slots)):
        for tile in range(tiles_x * tiles_y + 2 * tiles_cx * tiles_cy):
            if tile >= tiles_x * tiles_y:              # chroma
                t = tile - tiles_x * tiles_y
                per = tiles_cx * tiles_cy
                pl = t // per
                r0, c0 = (t % per) // tiles_cx * TILE_H, \
                    (t % per) % tiles_cx * TILE_W
                r, c = r0 + rows, c0 + cols
                ok = (r0 + ty < Hcp) & (c0 + tx * 4 < Wcp)
                src = (cr if pl else cb)[lane]
                v = src[np.clip(r - PADC, 0, Hc - 1),
                        np.clip(c - PADC, 0, Wc - 1)]
                dpb_c[lane, slot, pl, r[ok], c[ok]] = v[ok]
                continue
            r0, c0 = tile // tiles_x * TILE_H, tile % tiles_x * TILE_W
            ii = np.arange(TILE_H + 5)[:, None]
            jj = np.arange(TILE_W + 5)[None]
            s_y = y[lane][np.clip(r0 - PAD - 2 + ii, 0, H - 1),
                          np.clip(c0 - PAD - 2 + jj, 0, W - 1)] \
                .astype(np.int64)                      # [21, 69]
            s_b1 = _tap6(s_y, 1)                        # [21, 64]
            g = s_y[rows + 2, cols + 2]
            b = np.clip((s_b1[rows + 2, cols] + 16) >> 5, 0, 255)
            h = np.clip((sum(c * s_y[rows + k, cols + 2]
                             for k, c in enumerate(TAPS)) + 16) >> 5, 0, 255)
            j = np.clip((sum(c * s_b1[rows + k, cols]
                             for k, c in enumerate(TAPS)) + 512) >> 10,
                        0, 255)
            r, c = r0 + rows, c0 + cols
            ok = (r0 + ty < Hp) & (c0 + tx * 4 < Wp)
            for p, v in enumerate((g, b, h, j)):
                dpb_y[lane, slot, p, r[ok], c[ok]] = v[ok]


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
