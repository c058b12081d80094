"""K9, the residual kernel (csrc/residual.cu), on the CPU.

`thread_program` is a model of the kernel in Python: it runs each block
(a strip of STRIP MBs of one MB row) warp by warp and lane by lane, with
the .cu's shared-memory tiles, index arithmetic and branch order (the
luma 4x4 lanes, the chroma lanes, the 8x8 rows then columns, the DPCM
column and row scans, I_PCM, the strip's row-by-row write-out).  It must
equal the port's plain ops/transforms.py::residual_planes, which must
equal the JAX package's residual_planes lane by lane
(tests/torch_ref.py::jax_residual), on `random_residual_abi` with every
MB kind, qp 0..51, tr8, absent classes, bypass and both chroma QP
offsets.  Every comparison is exact (atol 0).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu.ops import transforms as jt
from arrow_h264_tpu_torch import convert
from arrow_h264_tpu_torch.common.tables import CHROMA_QP_TABLE
from arrow_h264_tpu_torch.ops import transforms as tt
from arrow_h264_tpu_torch.ops.kernels import LAUNCHES
from arrow_h264_tpu_torch.ops.kernels.residual import (
    CLASS_SHAPES, residual_planes,
)
from arrow_h264_tpu_torch.ops.synthetic import random_residual_abi
from tests.torch_ref import FLAT4, FLAT8, assert_same, jax_residual

SRC = Path(__file__).resolve().parent.parent / "arrow_h264_tpu_torch" / \
    "csrc" / "residual.cu"
STRIP = int(re.search(r"constexpr int kStrip = (\d+);",
                      SRC.read_text()).group(1))
GRIDS = [(4, 3), (5, 2), (9, 1), (1, 2)]     # 9 > STRIP: a ragged strip
H_SIGN = 0xa6c0                              # residual.cu hsign
# a custom scaling matrix (not flat), so that every position's scale
# and both lists take part
SCALING4 = [[6 + (7 * i + 3 * k) % 40 for k in range(16)] for i in range(6)]
SCALING8 = [[6 + (5 * i + 11 * k) % 60 for k in range(64)] for i in range(2)]


def _dequant4(c, ls, qp):
    q6 = qp // 6
    return (c * ls) << (q6 - 4) if qp >= 24 else \
        (c * ls + (1 << (3 - q6))) >> (4 - q6)


def _dequant6(c, ls, qp):
    q6 = qp // 6
    return (c * ls) << (q6 - 6) if qp >= 36 else \
        (c * ls + (1 << (5 - q6))) >> (6 - q6)


def _idct4(m):
    for step, lead in ((1, 4), (4, 1)):
        for r in range(4):
            o = r * lead
            v0, v1, v2, v3 = (m[o + i * step] for i in range(4))
            e0, e1 = v0 + v2, v0 - v2
            e2, e3 = (v1 >> 1) - v3, v1 + (v3 >> 1)
            for i, e in enumerate((e0 + e3, e1 + e2, e1 - e2, e0 - e3)):
                m[o + i * step] = e
    for i in range(16):
        m[i] = (m[i] + 32) >> 6


def _idct8_line(v, o, s):
    d = [v[o + i * s] for i in range(8)]
    e0 = d[0] + d[4]
    e1 = -d[3] + d[5] - d[7] - (d[7] >> 1)
    e2 = d[0] - d[4]
    e3 = d[1] + d[7] - d[3] - (d[3] >> 1)
    e4 = (d[2] >> 1) - d[6]
    e5 = -d[1] + d[7] + d[5] + (d[5] >> 1)
    e6 = d[2] + (d[6] >> 1)
    e7 = d[3] + d[5] + d[1] + (d[1] >> 1)
    f = (e0 + e6, e1 + (e7 >> 2), e2 + e4, e3 + (e5 >> 2), e2 - e4,
         (e3 >> 2) - e5, e0 - e6, e7 - (e1 >> 2))
    out = (f[0] + f[7], f[2] + f[5], f[4] + f[3], f[6] + f[1], f[6] - f[1],
           f[4] - f[3], f[2] - f[5], f[0] - f[7])
    for i in range(8):
        v[o + i * s] = out[i]


def _hsign(i, k):
    return -1 if (H_SIGN >> (4 * i + k)) & 1 else 1


def thread_program(abi: dict, mb_w: int, mb_h: int, ws4, ws8,
                   cqp_off=(0, 0), bypass: bool = False):
    """residual_kernel, block by block: abi's fields as numpy [B, n, ...]
    (a class absent from the dict is a null pointer), ws4/ws8 numpy ->
    (res_y, res_cb, res_cr) int64 numpy."""
    flat = {k: (None if abi.get(k) is None else
                np.asarray(abi[k]).reshape(-1).astype(np.int64).tolist())
            for k in ("kind", "qp", "tr8", "i4_modes", "i8_modes",
                      "i16_mode", "chroma_mode")
            + tuple(k for k, _ in CLASS_SHAPES)}
    ws4 = np.asarray(ws4).reshape(-1).tolist()
    ws8 = np.asarray(ws8).reshape(-1).tolist()
    cqp = list(CHROMA_QP_TABLE)
    B = np.asarray(abi["kind"]).shape[0]
    n = mb_w * mb_h
    H, W = 16 * mb_h, 16 * mb_w
    res_y = np.full(B * H * W, -(1 << 40), np.int64)
    res_c = [np.full(B * H * W // 4, -(1 << 40), np.int64) for _ in "cc"]
    luma4, luma8, luma_dc = flat["luma4"], flat["luma8"], flat["luma_dc"]
    chroma_dc, chroma_ac, pcm = (flat["chroma_dc"], flat["chroma_ac"],
                                 flat["pcm"])
    for b in range(B):
        for my in range(mb_h):
            for bx in range((mb_w + STRIP - 1) // STRIP):
                mx0 = bx * STRIP
                nmb = min(STRIP, mb_w - mx0)
                s_y = [[None] * 256 for _ in range(STRIP)]
                s_c = [[[None] * 64 for _ in range(2)] for _ in range(STRIP)]
                for warp in range(nmb):
                    y, c = s_y[warp], s_c[warp]
                    mb = b * n + my * mb_w + mx0 + warp
                    kind, qp = flat["kind"][mb], flat["qp"][mb]
                    intra = kind <= 3
                    byp = bypass and qp == 0
                    use8 = luma8 is not None and flat["tr8"][mb] > 0
                    if pcm is not None and kind == 3:
                        for i in range(256):
                            y[i] = pcm[mb * 384 + i]
                        for i in range(128):
                            c[i >> 6][i & 63] = pcm[mb * 384 + 256 + i]
                        continue
                    for lane in range(32):
                        if lane < 16 and not use8:
                            gy, gx = lane >> 2, lane & 3
                            ls = ((0 if intra else 3) * 6 + qp % 6) * 16
                            raw = [luma4[mb * 256 + lane * 16 + i]
                                   if luma4 else 0 for i in range(16)]
                            d = [_dequant4(raw[i], ws4[ls + i], qp)
                                 if luma4 else 0 for i in range(16)]
                            if luma_dc is not None and kind == 2:
                                dc = luma_dc[mb * 16:mb * 16 + 16]
                                f = sum(_hsign(gy, k) * dc[k * 4 + l]
                                        * _hsign(l, gx)
                                        for k in range(4) for l in range(4))
                                d[0] = _dequant6(f, ws4[(qp % 6) * 16], qp)
                                raw[0] = dc[lane]
                            if not byp:
                                _idct4(d)
                            o = raw if byp else d
                            for r in range(4):
                                for x in range(4):
                                    y[(gy * 4 + r) * 16 + gx * 4 + x] = \
                                        o[r * 4 + x]
                        elif 16 <= lane < 24:
                            pl, k = (lane - 16) >> 2, (lane - 16) & 3
                            by, bxx = k >> 1, k & 1
                            if chroma_ac is not None or chroma_dc is not None:
                                off = cqp_off[pl]
                                qpc = cqp[min(max(qp + off, 0), 51)]
                                ls = (((1 if intra else 4) + pl) * 6
                                      + qpc % 6) * 16
                                raw = [chroma_ac[mb * 128 + pl * 64 + k * 16
                                                 + i] if chroma_ac else 0
                                       for i in range(16)]
                                d = [_dequant4(raw[i], ws4[ls + i], qpc)
                                     if chroma_ac else 0 for i in range(16)]
                                if chroma_dc is not None:
                                    dc = chroma_dc[mb * 8 + pl * 4:
                                                   mb * 8 + pl * 4 + 4]
                                    sx, sy = (-1 if bxx else 1,
                                              -1 if by else 1)
                                    f = dc[0] + sx * dc[1] + sy * dc[2] \
                                        + sx * sy * dc[3]
                                    d[0] = (f * ws4[ls] << (qpc // 6)) >> 5
                                    raw[0] = dc[k]
                                if not byp:
                                    _idct4(d)
                            else:
                                d = raw = [0] * 16
                            o = raw if byp else d
                            for r in range(4):
                                for x in range(4):
                                    c[pl][(by * 4 + r) * 8 + bxx * 4 + x] = \
                                        o[r * 4 + x]
                    if use8:
                        for lane in range(32):          # rows
                            blk, r = lane >> 3, lane & 7
                            base = (blk >> 1) * 128 + (blk & 1) * 8
                            src = mb * 256 + blk * 64 + r * 8
                            ls = ((0 if intra else 1) * 6 + qp % 6) * 64 \
                                + r * 8
                            v = [luma8[src + j] if byp else
                                 _dequant6(luma8[src + j], ws8[ls + j], qp)
                                 for j in range(8)]
                            if not byp:
                                _idct8_line(v, 0, 1)
                            for j in range(8):
                                y[base + r * 16 + j] = v[j]
                        if not byp:
                            for lane in range(32):      # columns
                                blk, r = lane >> 3, lane & 7
                                base = (blk >> 1) * 128 + (blk & 1) * 8
                                _idct8_line(y, base + r, 16)
                                for i in range(8):
                                    p = base + i * 16 + r
                                    y[p] = (y[p] + 32) >> 6
                    if byp and kind <= 2:
                        t = 4 if kind == 0 else 8 if kind == 1 else 16
                        for lane in range(32):
                            vert, line = lane < 16, lane & 15
                            run = 0
                            for i in range(16):
                                yy, xx = (i, line) if vert else (line, i)
                                if kind == 0:
                                    mode = flat["i4_modes"][
                                        mb * 16 + (yy >> 2) * 4 + (xx >> 2)]
                                elif kind == 1:
                                    mode = flat["i8_modes"][
                                        mb * 4 + (yy >> 3) * 2 + (xx >> 3)]
                                else:
                                    mode = flat["i16_mode"][mb]
                                if i % t == 0:
                                    run = 0
                                if mode == (0 if vert else 1):
                                    run += y[yy * 16 + xx]
                                    y[yy * 16 + xx] = run
                            if chroma_ac is None and chroma_dc is None:
                                continue
                            cm = flat["chroma_mode"][mb]
                            pl, l8 = line >> 3, line & 7
                            if cm == (2 if vert else 1):
                                run_c = 0
                                for i in range(8):
                                    p = i * 8 + l8 if vert else l8 * 8 + i
                                    run_c += c[pl][p]
                                    c[pl][p] = run_c
                # the strip's write-out, thread by thread
                wy, wc = nmb * 16, nmb * 8
                for i in range(16 * wy):
                    r, x = i // wy, i % wy
                    res_y[(b * H + my * 16 + r) * W + mx0 * 16 + x] = \
                        s_y[x >> 4][r * 16 + (x & 15)]
                for i in range(2 * 8 * wc):
                    pl, r, x = i // (8 * wc), (i // wc) % 8, i % wc
                    res_c[pl][(b * (H // 2) + my * 8 + r) * (W // 2)
                              + mx0 * 8 + x] = s_c[x >> 3][pl][r * 8 + (x & 7)]
    return (res_y.reshape(B, H, W),
            *(p.reshape(B, H // 2, W // 2) for p in res_c))


def _abi(mb_w, mb_h, B, seed, drop=()):
    abi = random_residual_abi(mb_w, mb_h, B, seed)
    return {k: v for k, v in abi.items() if k not in drop}


def _check(abi, mb_w, mb_h, cqp_off=(0, 0), bypass=False, scaled=False):
    """The model against the plain version, the wrapper on CPU tensors
    and the JAX package lane by lane."""
    ws4, ws8 = jt.make_ws_consts(SCALING4 if scaled else FLAT4,
                                 SCALING8 if scaled else FLAT8)
    tws4, tws8 = convert.ws_from_jax(ws4, ws8)
    got = thread_program(abi, mb_w, mb_h, ws4, ws8, cqp_off, bypass)
    ta = {k: torch.from_numpy(v) for k, v in abi.items()}
    plain = tt.residual_planes(ta, mb_w, mb_h, tws4, tws8, cqp_off, bypass)
    before = dict(LAUNCHES)
    wrapped = residual_planes(ta, mb_w, mb_h, tws4, tws8, cqp_off, bypass)
    assert LAUNCHES == before                 # CPU tensors: plain version
    for g, p, w, name in zip(got, plain, wrapped, ("y", "cb", "cr")):
        assert p.dtype == w.dtype == torch.int32
        assert torch.equal(w, p), name
        assert_same(g, p, f"model res_{name}")
    for b in range(abi["kind"].shape[0]):
        ja = {k: jnp.asarray(v[b]) for k, v in abi.items()}
        fn = jax_residual(mb_w, mb_h, tuple(sorted(ja)), tuple(cqp_off),
                          bypass)
        want = fn(ja, jnp.asarray(ws4), jnp.asarray(ws8))
        for g, w, name in zip(got, want, ("y", "cb", "cr")):
            assert_same(g[b], w, f"res_{name}[{b}] vs JAX")
    return got


@pytest.mark.parametrize("bypass", [False, True], ids=["lossy", "bypass"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mb_w,mb_h", GRIDS)
def test_thread_program(mb_w, mb_h, B, bypass):
    abi = _abi(mb_w, mb_h, B, seed=40 + B)
    _check(abi, mb_w, mb_h, cqp_off=(2, -3), bypass=bypass)


@pytest.mark.parametrize("drop", [
    ("luma4",), ("luma8",), ("luma_dc",), ("luma4", "luma_dc"),
    ("chroma_dc",), ("chroma_ac",), ("chroma_dc", "chroma_ac"), ("pcm",),
    tuple(k for k, _ in CLASS_SHAPES)], ids=lambda d: "-".join(d))
@pytest.mark.parametrize("bypass", [False, True], ids=["lossy", "bypass"])
def test_thread_program_absent_classes(drop, bypass):
    """Classes left out of the ABI read as zero: tr8 picks the 8x8 result
    even without luma4, the 4x4 path runs on zeros plus the I16 DC
    without luma4, and no chroma class leaves the chroma planes 0."""
    mb_w, mb_h = 5, 2
    _check(_abi(mb_w, mb_h, 2, seed=50, drop=drop), mb_w, mb_h,
           cqp_off=(-4, 5), bypass=bypass)


@pytest.mark.parametrize("cqp_off", [(0, 0), (12, -12), (-12, 12)])
def test_thread_program_scaling_and_offsets(cqp_off):
    """A non-flat scaling matrix and the chroma QP offsets at their ends."""
    _check(_abi(4, 3, 2, seed=60), 4, 3, cqp_off=cqp_off, scaled=True)


@pytest.mark.parametrize("mode", range(4))
def test_thread_program_dpcm_modes(mode):
    """Bypass MBs of one intra kind a lane, every block in one mode (0
    vertical, 1 horizontal, 2 and 3 none; chroma 2 vertical, 1
    horizontal), against the closed-form cumsum of the plain version."""
    mb_w, mb_h = 4, 3
    abi = _abi(mb_w, mb_h, 3, seed=70 + mode)
    for b, kind in enumerate((0, 1, 2)):
        abi["kind"][b] = kind
    abi["qp"][:] = 0
    abi["tr8"][:] = abi["kind"] == 1
    for k in ("i4_modes", "i8_modes", "i16_mode", "chroma_mode"):
        abi[k][:] = mode
    got = _check(abi, mb_w, mb_h, bypass=True)
    assert got[0].any() and got[1].any()


def test_thread_program_extremes():
    """qp 0 and 51 everywhere, and the dequant switches 23/24 and 35/36."""
    mb_w, mb_h = 4, 3
    abi = _abi(mb_w, mb_h, 3, seed=80)
    abi["qp"][0] = 51
    abi["qp"][1] = np.where(np.arange(mb_w * mb_h) % 2, 24, 23)
    abi["qp"][2] = np.where(np.arange(mb_w * mb_h) % 2, 36, 35)
    _check(abi, mb_w, mb_h, cqp_off=(12, 12))
