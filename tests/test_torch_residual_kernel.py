"""K9, the residual kernel (csrc/residual.cu), on the CPU.

`thread_program` is a model of the kernel in Python: it runs each block
(a strip of STRIP MBs of one MB row) warp by warp and lane by lane, with
the .cu's shared-memory layout (offsets and pitches parsed from the
.cu), index arithmetic and branch order: each warp stages its MB's
classes into a poisoned staging area in 16-byte groups, in the swizzled
piece order (a word at a time for a class whose base is off 16-byte
alignment, bit clear in `vec`; an I_PCM MB's samples straight into its
result tiles); the lanes read only staged words (lanes 0-23 the luma
and chroma 4x4 blocks in one pass, the 8x8 rows then columns), then the
DPCM column and row scans; then the strip's write-out in 16-byte aligned
int4 groups indexed by shifts and masks (ragged strips masked), each
output word once.  It must
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
    CLASS_SHAPES, aligned_mask, residual_planes,
)
from arrow_h264_tpu_torch.ops.synthetic import random_residual_abi
from tests.torch_ref import FLAT4, FLAT8, assert_same, jax_residual

SRC = (Path(__file__).resolve().parent.parent / "arrow_h264_tpu_torch" /
       "csrc" / "residual.cu").read_text()
CONSTS: dict = {}


def _const(name):
    """A constexpr int of the .cu, its expression evaluated over the
    constants parsed before it."""
    expr = re.search(rf"\b{name} = ([^,;]+)[,;]", SRC).group(1)
    CONSTS[name] = eval(expr.replace("/", "//"), {}, dict(CONSTS))
    return CONSTS[name]


STRIP = _const("kStrip")
Y_GROUPS, C_GROUPS = _const("kYGroups"), _const("kCGroups")
LUMA_DC, CHROMA_DC = _const("kLumaDc"), _const("kChromaDc")
CHROMA_AC, STAGE = _const("kChromaAc"), _const("kStage")
YPITCH, CPITCH = _const("kYPitch"), _const("kCPitch")
POISON = -(1 << 40)                          # an unstaged shared word
GRIDS = [(4, 3), (5, 2), (9, 1), (1, 2), (3, 6)]   # 9 > STRIP: a ragged
# strip
H_SIGN = 0xa6c0                              # residual.cu hsign
# a custom scaling matrix (not flat), so that every position's scale
# and both lists take part
SCALING4 = [[6 + (7 * i + 3 * k) % 40 for k in range(16)] for i in range(6)]
SCALING8 = [[6 + (5 * i + 11 * k) % 60 for k in range(64)] for i in range(2)]


def _dequant4(c, ls, qp):
    """residual.cu Dequant4: qp's left shift, rounding and right shift,
    one of the shifts 0."""
    q6 = qp // 6
    lsh, rsh = max(q6 - 4, 0), max(4 - q6, 0)
    rnd = 1 << (rsh - 1) if rsh else 0
    return (((c * ls) << lsh) + rnd) >> rsh


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


def _swz4(q):           # residual.cu swz4: 4x4 block q's piece order
    return (q >> 1) & 3


def _swz8(r):           # swz8: 8x8 row r's half order
    return (r >> 2) & 1


def thread_program(abi: dict, mb_w: int, mb_h: int, ws4, ws8,
                   cqp_off=(0, 0), bypass: bool = False, vec: int = 63,
                   base: dict | None = None):
    """residual_kernel, block by block: abi's fields as numpy [B, n, ...]
    (a class absent from the dict is a null pointer), ws4/ws8 numpy, the
    launch's `vec` and each class's base address mod 16 (`base`, 0 when
    not given) -> (res_y, res_cb, res_cr) int64 numpy."""
    base = base or {}
    flat = {k: (None if abi.get(k) is None else
                np.asarray(abi[k]).reshape(-1).astype(np.int64).tolist())
            for k in ("kind", "qp", "tr8", "i4_modes", "i8_modes",
                      "i16_mode", "chroma_mode")
            + tuple(k for k, _ in CLASS_SHAPES)}
    bits = {k: 1 << i for i, (k, _) in enumerate(CLASS_SHAPES)}
    ws4 = np.asarray(ws4).reshape(-1).tolist()
    ws8 = np.asarray(ws8).reshape(-1).tolist()
    cqp = list(CHROMA_QP_TABLE)
    B = np.asarray(abi["kind"]).shape[0]
    n = mb_w * mb_h
    H, W = 16 * mb_h, 16 * mb_w
    res_y = np.full(B * H * W, POISON, np.int64)
    res_c = [np.full(B * H * W // 4, POISON, np.int64) for _ in "cc"]
    written = [np.zeros(r.size, np.int64) for r in (res_y, *res_c)]
    luma4, luma8, luma_dc = flat["luma4"], flat["luma8"], flat["luma_dc"]
    chroma_dc, chroma_ac, pcm = (flat["chroma_dc"], flat["chroma_ac"],
                                 flat["pcm"])

    def copy16(st, at, key, word):
        """One lane's 16-byte group of class `key` from its word `word` to
        st[at:at + 4]: one 16-byte cp.async where vec has the class's
        bit (its base, and so the group, is 16-byte aligned), else four
        of a word."""
        assert at % 4 == 0 and word % 4 == 0
        if vec & bits[key]:
            assert (base.get(key, 0) + 4 * word) % 16 == 0
        st[at:at + 4] = flat[key][word:word + 4]

    def stage(mb, kind, use8, lane, st, y, c):
        """residual.cu stage_mb: lane's copies of MB mb's classes (an
        I_PCM MB's samples straight into its result tiles)."""
        if pcm is not None and kind == 3:
            for q in range(lane, 96, 32):
                dst, at = (y, 4 * q) if q < 64 else \
                    (c, ((q - 64) >> 4) * CPITCH + 4 * ((q - 64) & 15))
                copy16(dst, at, "pcm", mb * 384 + 4 * q)
            return
        for q in range(lane, 64, 32):
            if use8:
                copy16(st, (q >> 1) * 8 + 4 * ((q & 1) ^ _swz8(q >> 1)),
                       "luma8", mb * 256 + 4 * q)
            elif luma4 is not None:
                copy16(st, (q >> 2) * 16 + 4 * ((q & 3) ^ _swz4(q >> 2)),
                       "luma4", mb * 256 + 4 * q)
        if luma_dc is not None and kind == 2 and not use8 and lane < 4:
            copy16(st, LUMA_DC + 4 * lane, "luma_dc", mb * 16 + 4 * lane)
        if chroma_dc is not None and lane < 2:
            copy16(st, CHROMA_DC + 4 * lane, "chroma_dc", mb * 8 + 4 * lane)
        if chroma_ac is not None:
            copy16(st, CHROMA_AC + (lane >> 2) * 16
                   + 4 * ((lane & 3) ^ _swz4(lane >> 2)), "chroma_ac",
                   mb * 128 + 4 * lane)

    def block4(lane, st, y, c, kind, qp, intra, byp, dc16):
        """A 4x4 block in the one pass of lanes 0-23: luma block `lane`,
        or chroma block k of plane pl (lane 16 + pl * 4 + k)."""
        is_c = lane >= 16
        blk = lane - 16 if is_c else lane
        pl, k = blk >> 2, blk & 3
        qq, row = qp, (0 if intra else 3) * 6 + qp % 6
        if is_c:
            qq = cqp[min(max(qp + cqp_off[pl], 0), 51)]
            row = ((1 if intra else 4) + pl) * 6 + qq % 6
        ls = ws4[row * 16:row * 16 + 16]
        have = (chroma_ac if is_c else luma4) is not None
        co = (CHROMA_AC if is_c else 0) + blk * 16
        raw = [0] * 16
        if have:
            for p in range(4):          # 16-byte reads, swizzled
                at = co + 4 * (p ^ _swz4(blk))
                raw[4 * p:4 * p + 4] = st[at:at + 4]
        d = [_dequant4(raw[i], ls[i], qq) if have else 0 for i in range(16)]
        if not is_c and dc16:
            dc = st[LUMA_DC:LUMA_DC + 16]
            gy, gx = blk >> 2, blk & 3
            f = sum(_hsign(gy, i) * dc[i * 4 + l] * _hsign(l, gx)
                    for i in range(4) for l in range(4))
            d[0] = _dequant6(f, ws4[(qp % 6) * 16], qp)
            raw[0] = dc[blk]
        if is_c and chroma_dc is not None:
            dc = st[CHROMA_DC + pl * 4:CHROMA_DC + pl * 4 + 4]
            sx, sy = (-1 if k & 1 else 1), (-1 if k >> 1 else 1)
            f = dc[0] + sx * dc[1] + sy * dc[2] + sx * sy * dc[3]
            d[0] = (f * ls[0] << (qq // 6)) >> 5
            raw[0] = dc[k]
        if not byp:
            _idct4(d)
        o = raw if byp else d
        out, at, pitch = (c, pl * CPITCH + (k >> 1) * 32 + (k & 1) * 4, 8) \
            if is_c else (y, (blk >> 2) * 64 + (blk & 3) * 4, 16)
        for r in range(4):              # an int4 a row
            out[at + r * pitch:at + r * pitch + 4] = o[r * 4:r * 4 + 4]

    def compute(mb, st, y, c):
        """residual.cu compute_mb (not I_PCM), lane by lane."""
        kind, qp = flat["kind"][mb], flat["qp"][mb]
        intra = kind <= 3
        byp = bypass and qp == 0
        use8 = luma8 is not None and flat["tr8"][mb] > 0
        dc16 = luma_dc is not None and kind == 2 and not use8
        chroma = chroma_ac is not None or chroma_dc is not None
        for lane in range(24):
            if lane >= 16 or not use8:
                block4(lane, st, y, c, kind, qp, intra, byp, dc16)
        if use8:
            for lane in range(32):              # rows
                blk, r = lane >> 3, lane & 7
                base8 = (blk >> 1) * 128 + (blk & 1) * 8
                ls = ((0 if intra else 1) * 6 + qp % 6) * 64 + r * 8
                lo = lane * 8 + 4 * _swz8(lane)
                hi = lane * 8 + 4 * (1 ^ _swz8(lane))
                v = st[lo:lo + 4] + st[hi:hi + 4]
                if not byp:
                    v = [_dequant6(v[j], ws8[ls + j], qp) for j in range(8)]
                    _idct8_line(v, 0, 1)
                y[base8 + r * 16:base8 + r * 16 + 8] = v
            if not byp:
                for lane in range(32):          # columns
                    blk, r = lane >> 3, lane & 7
                    base8 = (blk >> 1) * 128 + (blk & 1) * 8
                    _idct8_line(y, base8 + r, 16)
                    for i in range(8):
                        p = base8 + i * 16 + r
                        y[p] = (y[p] + 32) >> 6
        if not (byp and kind <= 2):
            return
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
            if not chroma:
                continue
            cm = flat["chroma_mode"][mb]
            cb0, l8 = (line >> 3) * CPITCH, line & 7
            if cm == (2 if vert else 1):
                run_c = 0
                for i in range(8):
                    p = cb0 + (i * 8 + l8 if vert else l8 * 8 + i)
                    run_c += c[p]
                    c[p] = run_c

    for b in range(B):
        for my in range(mb_h):
            for mx0 in range(0, mb_w, STRIP):
                nmb = min(STRIP, mb_w - mx0)
                s_st = [[POISON] * STAGE for _ in range(STRIP)]
                s_y = [[POISON] * YPITCH for _ in range(STRIP)]
                s_c = [[POISON] * (2 * CPITCH) for _ in range(STRIP)]
                for warp in range(nmb):
                    mb = b * n + my * mb_w + mx0 + warp
                    kind = flat["kind"][mb]
                    use8 = luma8 is not None and flat["tr8"][mb] > 0
                    for lane in range(32):
                        stage(mb, kind, use8, lane, s_st[warp], s_y[warp],
                              s_c[warp])
                    if not (pcm is not None and kind == 3):
                        compute(mb, s_st[warp], s_y[warp], s_c[warp])
                # the write-out: int4 groups, thread by thread
                for i in range(16 * Y_GROUPS):
                    r, x = i // Y_GROUPS, (i % Y_GROUPS) * 4
                    if x < nmb * 16:
                        o = (b * H + my * 16 + r) * W + mx0 * 16 + x
                        assert o % 4 == 0
                        at = r * 16 + (x & 15)
                        res_y[o:o + 4] = s_y[x >> 4][at:at + 4]
                        written[0][o:o + 4] += 1
                for i in range(2 * 8 * C_GROUPS):
                    pl, r = i // (8 * C_GROUPS), i // C_GROUPS % 8
                    x = (i % C_GROUPS) * 4
                    if x < nmb * 8:
                        o = (b * (H // 2) + my * 8 + r) * (W // 2) \
                            + mx0 * 8 + x
                        assert o % 4 == 0
                        at = pl * CPITCH + r * 8 + (x & 7)
                        res_c[pl][o:o + 4] = s_c[x >> 3][at:at + 4]
                        written[1 + pl][o:o + 4] += 1
    for w in written:
        assert (w == 1).all()                 # each output word once
    return (res_y.reshape(B, H, W),
            *(p.reshape(B, H // 2, W // 2) for p in res_c))


def _abi(mb_w, mb_h, B, seed, drop=()):
    abi = random_residual_abi(mb_w, mb_h, B, seed)
    return {k: v for k, v in abi.items() if k not in drop}


def _shifted(a: np.ndarray, words: int) -> torch.Tensor:
    """a as a contiguous int32 tensor whose base lies `words` words past
    a 16-byte boundary."""
    buf = torch.empty(a.size + 8, dtype=torch.int32)
    at = (-buf.data_ptr() % 16) // 4 + words
    t = buf[at:at + a.size].view(a.shape)
    t.copy_(torch.from_numpy(np.ascontiguousarray(a, np.int32)))
    assert t.is_contiguous() and t.data_ptr() % 16 == 4 * words
    return t


def _check(abi, mb_w, mb_h, cqp_off=(0, 0), bypass=False, scaled=False,
           shift=()):
    """The model against the plain version, the wrapper on CPU tensors
    and the JAX package lane by lane.  The classes named in `shift` lie
    one word past a 16-byte boundary, the others on one: the model
    stages them as the kernel would with the wrapper's `vec`."""
    ws4, ws8 = jt.make_ws_consts(SCALING4 if scaled else FLAT4,
                                 SCALING8 if scaled else FLAT8)
    tws4, tws8 = convert.ws_from_jax(ws4, ws8)
    ta = {k: _shifted(v, int(k in shift)) if k in tt.COEFF_KEYS
          else torch.from_numpy(v) for k, v in abi.items()}
    vec = aligned_mask([ta.get(k) for k, _ in CLASS_SHAPES])
    assert all(vec >> i & 1 == (k in ta and k not in shift)
               for i, (k, _) in enumerate(CLASS_SHAPES))
    got = thread_program(abi, mb_w, mb_h, ws4, ws8, cqp_off, bypass, vec,
                         {k: ta[k].data_ptr() % 16 for k in tt.COEFF_KEYS
                          if k in ta})
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


@pytest.mark.parametrize("bypass", [False, True], ids=["lossy", "bypass"])
@pytest.mark.parametrize("shift", [tuple(k for k, _ in CLASS_SHAPES),
                                   ("luma4", "chroma_ac", "pcm"),
                                   ("luma8", "luma_dc", "chroma_dc")],
                         ids=lambda s: "-".join(s))
def test_thread_program_unaligned_classes(shift, bypass):
    """Classes whose base lies one word past a 16-byte boundary (a view,
    or an upload that packs tensors back to back): the wrapper clears
    their bits of `vec` and the kernel stages them a word at a time; a
    ragged strip (9 MBs) and both paths in one launch."""
    mb_w, mb_h = 9, 2
    _check(_abi(mb_w, mb_h, 2, seed=90), mb_w, mb_h, cqp_off=(2, -3),
           bypass=bypass, scaled=True, shift=shift)
