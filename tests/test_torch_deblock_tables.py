"""K7, the deblocking-table kernel (csrc/deblock_tables.cu), on the CPU.

`thread_program` is a numpy model of the kernel: a block a strip of
kStrip consecutive MBs of one lane, which first stages its inputs (the
strip's MBs and the one before it whole, row 3 of the MBs above, the
scalar fields in 16-byte chunks where the lane's span and shared memory
share their alignment, word by word at the head, the tail or where they
do not), then a thread a (MB, direction, edge) that reads only what was
staged and stores its tables as the kernel does (int4, int2 and word
stores, each output word once).  Its constants (kStrip, kThreads,
kPitch) are parsed from the .cu.  It must equal the port's plain
ops/deblock.py::deblock_tables on every input, and, for frame pictures,
the JAX package's deblock_tables (tests/torch_ref.py::jax_deblock);
field pictures are held to the port's plain version only, since the JAX
package uses the frame MV limit there (ROADMAP §C2).  Every comparison is
exact (atol 0).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu_torch.common.tables import (
    ALPHA_TABLE, BETA_TABLE, CHROMA_QP_TABLE, TC0_TABLE,
)
from arrow_h264_tpu_torch.ops import deblock as td
from arrow_h264_tpu_torch.ops.kernels import LAUNCHES
from arrow_h264_tpu_torch.ops.kernels.deblock_tables import (
    ABI_FIELDS, deblock_tables,
)
from arrow_h264_tpu_torch.ops.synthetic import (
    random_deblock_abi, synthetic_abi, synthetic_abi_p,
)
from arrow_h264_tpu_torch.ops.wire import NX_FLAG
from tests.torch_ref import DEBLOCK_KEYS, assert_same, jax_deblock

CU = (Path(td.__file__).resolve().parents[1] / "csrc" /
      "deblock_tables.cu").read_text()
STRIP, PITCH = (int(re.search(rf"constexpr int {k} = (\d+);", CU)[1])
                for k in ("kStrip", "kPitch"))
GRIDS = [(1, 1), (1, 6), (6, 1), (11, 9)]
SOURCES = ["synthetic_i", "synthetic_p", "synthetic_b", "random"]
ALPHA, BETA, CQP = (np.asarray(t, np.int64) for t in
                    (ALPHA_TABLE, BETA_TABLE, CHROMA_QP_TABLE))
TC0 = np.asarray(TC0_TABLE, np.int64).reshape(-1)       # [3 * 52]
POISON = -(1 << 40)              # an unstaged word of shared memory
SCALARS = ("kind", "qp", "slice_id", "disable_idc", "alpha_off",
           "beta_off", "tr8")


def test_constants_match_the_kernel():
    assert "constexpr int kThreads = 8 * kStrip;" in CU
    assert PITCH >= 16 and PITCH % 4 == 0     # 16-byte aligned MB slots


def stage_words(dst: np.ndarray, at: int, src: np.ndarray, off: int,
                count: int, log: dict) -> None:
    """The kernel's stage_words: `count` words of src from word `off`
    (the ABI arrays are 16-byte aligned) into dst from word `at` (the
    shared arrays are): 16-byte copies where the two share their
    alignment, after a head of up to 3 words, then a tail; word by word
    where they do not.  log counts the copies of each width."""
    head = count
    if (off - at) % 4 == 0:
        head = min(count, -off % 4)
    chunks = (count - head) // 4
    for c in range(chunks):
        w = head + 4 * c
        assert (off + w) % 4 == 0 and (at + w) % 4 == 0   # cp.async 16
        dst[at + w:at + w + 4] = src[off + w:off + w + 4]
    for w in list(range(head)) + list(range(head + 4 * chunks, count)):
        dst[at + w] = src[off + w]
    log[16] += chunks
    log[4] += count - 4 * chunks


def stage(f: dict, b: int, x: int, n: int, mb_w: int, log: dict) -> dict:
    """Block (x, b)'s shared memory after its copies: its strip of
    `count` MBs from m0 = x * kStrip; unstaged words hold POISON."""
    m0 = x * STRIP
    count = min(STRIP, n - m0)
    lane = b * n
    S = {"nz": np.full((STRIP + 1, PITCH), POISON),
         "mv": np.full((STRIP + 1, PITCH, 4), POISON),
         "ref": np.full((STRIP + 1, PITCH, 2), POISON),
         "top_nz": np.full((STRIP, 4), POISON),
         "top_mv": np.full((STRIP, 4, 4), POISON),
         "top_ref": np.full((STRIP, 4, 2), POISON)}
    # slot k: MB m0 - 1 + k, whole (the MB before MB 0: none)
    for k in range(0 if m0 > 0 else 1, count + 1):
        mb = lane + m0 - 1 + k
        S["nz"][k, :16] = f["nz"][mb * 16:mb * 16 + 16]
        S["mv"][k, :16] = f["mv"][mb * 64:mb * 64 + 64].reshape(16, 4)
        S["ref"][k, :16] = f["refid"][mb * 32:mb * 32 + 32].reshape(16, 2)
        log[16] += 28
    # row 3 (blocks 12-15) of the MB above, for strip MBs t0..count-1
    t0 = max(0, mb_w - m0)
    for ll in range(t0, count):
        mb = lane + m0 + ll - mb_w
        S["top_nz"][ll] = f["nz"][mb * 16 + 12:mb * 16 + 16]
        S["top_mv"][ll] = f["mv"][mb * 64 + 48:mb * 64 + 64].reshape(4, 4)
        S["top_ref"][ll] = f["refid"][mb * 32 + 24:mb * 32 + 32] \
            .reshape(4, 2)
        log[16] += 7
    for k in SCALARS:
        S[k] = np.full(STRIP, POISON)
        stage_words(S[k], 0, f[k], lane + m0, count, log)
    for k in ("kind", "qp", "slice_id"):
        S["top_" + k] = np.full(STRIP, POISON)
        if count > t0:
            stage_words(S["top_" + k], t0, f[k], lane + m0 + t0 - mb_w,
                        count - t0, log)
        S["left_" + k] = f[k][lane + m0 - 1] if m0 > 0 else POISON
    return S, m0, count


def thread_program(abi: dict, mb_w: int, mb_h: int, cqp_off=(0, 0),
                   field: bool = False, log: dict | None = None) -> dict:
    """deblock_tables_kernel, block by block, each block's threads at
    once: abi's fields as numpy [B, n, ...] -> the twelve tables, int32,
    in their shapes.  log (if given) gets the copies of each width."""
    B = abi["kind"].shape[0]
    n = mb_w * mb_h
    f = {k: np.ascontiguousarray(abi[k]).reshape(-1).astype(np.int64)
         for k, _ in ABI_FIELDS}
    out = {k: np.full(B * n * int(np.prod(s)), -99, np.int64)
           for k, s in td.TABLE_SHAPES.items()}
    writes = {k: np.zeros(len(v), np.int64) for k, v in out.items()}
    log = {16: 0, 4: 0} if log is None else log
    limit_y = 2 if field else 4
    t = np.arange(8 * STRIP)
    d_all, l_all, e_all = t // (4 * STRIP), (t // 4) % STRIP, t % 4

    def store(key, unit, width, vals):
        """Each thread's store of `width` words at unit `unit` of key."""
        idx = (unit[:, None] * width + np.arange(width)).ravel()
        out[key][idx] = np.asarray(vals).T.ravel() if width > 1 else vals
        np.add.at(writes[key], idx, 1)

    for b in range(B):
        for x in range(-(-n // STRIP)):
            S, m0, count = stage(f, b, x, n, mb_w, log)
            ok = l_all < count
            d, ll, e = d_all[ok], l_all[ok], e_all[ok]
            m = m0 + ll
            horiz = d == 1
            has_nb = np.where(horiz, m >= mb_w, m % mb_w > 0)
            nb = {}
            for k in ("kind", "qp", "slice_id"):
                left = np.where(ll > 0, S[k][np.maximum(ll - 1, 0)],
                                S["left_" + k])
                nb[k] = np.where(has_nb, np.where(horiz, S["top_" + k][ll],
                                                  left), S[k][ll])
            qp, dis = S["qp"][ll], S["disable_idc"][ll]
            do_any = dis != 1
            mb_edge = e == 0
            mask = np.where(mb_edge, do_any & has_nb & ~(
                (dis == 2) & (nb["slice_id"] != S["slice_id"][ll])),
                do_any & ((e == 2) | (S["tr8"][ll] <= 0)))
            qpp = np.where(mb_edge, nb["qp"], qp)
            qpav = (qpp + qp + 1) >> 1
            aoff, boff = S["alpha_off"][ll], S["beta_off"][ll]
            ia = np.clip(qpav + aoff, 0, 51)
            ib = np.clip(qpav + boff, 0, 51)
            intra = (S["kind"][ll] <= 3) | (np.where(
                mb_edge, nb["kind"], S["kind"][ll]) <= 3)
            strong = np.where(mb_edge & ~(field & horiz), 4, 3)
            step = np.where(horiz, 1, 4)
            q0 = np.where(horiz, 4 * e, e)
            # p's source: "slot" (S[nz|mv|ref][pslot]) or "top" (S[top_*])
            pslot = np.where(mb_edge & ~horiz & has_nb, ll, ll + 1)
            ptop = mb_edge & horiz & has_nb
            p0 = np.where(mb_edge, np.where(horiz, np.where(has_nb, 0, 12),
                                            3),
                          np.where(horiz, 4 * (e - 1), e - 1))
            bs, tc = [], []
            for s in range(4):
                qb, pb = q0 + s * step, p0 + s * step
                pbs = np.minimum(pb, 3)
                pnz = np.where(ptop, S["top_nz"][ll, pbs],
                               S["nz"][pslot, pb])
                pmv = np.where(ptop[:, None], S["top_mv"][ll, pbs],
                               S["mv"][pslot, pb])
                pref = np.where(ptop[:, None], S["top_ref"][ll, pbs],
                                S["ref"][pslot, pb])
                qnz, qmv = S["nz"][ll + 1, qb], S["mv"][ll + 1, qb]
                qref = S["ref"][ll + 1, qb]
                used = ~intra & mask
                for v in (pnz, qnz, pmv, qmv, pref, qref):
                    vv = v if v.ndim == 1 else v.min(-1)
                    assert (vv[used] != POISON).all(), "read unstaged"
                v = np.where(intra, strong, bs_inter(
                    pnz > 0, qnz > 0, pref, qref, pmv, qmv, limit_y))
                v = np.where(mask, v, 0)
                bs.append(v)
                tc.append(TC0[np.clip(v - 1, 0, 2) * 52 + ia])
            self_ = b * n + m
            at = self_ * 4 + e
            for h, tag in ((False, "v"), (True, "h")):
                sel = horiz == h
                store(f"bs_{tag}", at[sel], 4, [v[sel] for v in bs])
                store(f"tc_{tag}", at[sel], 4, [v[sel] for v in tc])
                store(f"a_{tag}", at[sel], 1, ALPHA[ia][sel])
                store(f"b_{tag}", at[sel], 1, BETA[ib][sel])
            ev = e % 2 == 0
            de = ((self_ * 2 + d) * 2 + e // 2)[ev]
            store("bs_c", de, 4, [v[ev] for v in bs])
            ac, bc, tcc = [], [], []
            for pl in range(2):
                qpc_p = CQP[np.clip(qpp + cqp_off[pl], 0, 51)]
                qpc_q = CQP[np.clip(qp + cqp_off[pl], 0, 51)]
                qpavc = (qpc_p + qpc_q + 1) >> 1
                iac = np.clip(qpavc + aoff, 0, 51)
                ibc = np.clip(qpavc + boff, 0, 51)
                ac.append(ALPHA[iac][ev])
                bc.append(BETA[ibc][ev])
                tcc.append([TC0[np.clip(v - 1, 0, 2) * 52 + iac][ev]
                            for v in bs])
            store("tc_c", 2 * de, 4, [tcc[0][0], tcc[1][0], tcc[0][1],
                                      tcc[1][1]])
            store("tc_c", 2 * de + 1, 4, [tcc[0][2], tcc[1][2], tcc[0][3],
                                          tcc[1][3]])
            store("a_c", de, 2, ac)
            store("b_c", de, 2, bc)
    for k, w in writes.items():
        assert (w == 1).all(), f"{k}: a word written {w.min()}-{w.max()} x"
    return {k: v.reshape((B, n) + td.TABLE_SHAPES[k]).astype(np.int32)
            for k, v in out.items()}


def bs_inter(nzp, nzq, rp, rq, mp, mq, limit_y):
    """The kernel's bs_inter, over threads: rp/rq [T, list], mp/mq [T,
    list x component] (x, y, z, w)."""
    def far(px, py, qx, qy):
        return (np.abs(px - qx) >= 4) | (np.abs(py - qy) >= limit_y)
    n_p = (rp >= 0).sum(-1)
    n_q = (rq >= 0).sum(-1)
    sets_eq = (rp.min(-1) == rq.min(-1)) & (rp.max(-1) == rq.max(-1))
    p0, q0 = rp[:, 0] >= 0, rq[:, 0] >= 0
    far1 = far(np.where(p0, mp[:, 0], mp[:, 2]),
               np.where(p0, mp[:, 1], mp[:, 3]),
               np.where(q0, mq[:, 0], mq[:, 2]),
               np.where(q0, mq[:, 1], mq[:, 3]))
    straight = far(mp[:, 0], mp[:, 1], mq[:, 0], mq[:, 1]) | \
        far(mp[:, 2], mp[:, 3], mq[:, 2], mq[:, 3])
    crossed = far(mp[:, 0], mp[:, 1], mq[:, 2], mq[:, 3]) | \
        far(mp[:, 2], mp[:, 3], mq[:, 0], mq[:, 1])
    far2 = np.where(rp[:, 0] == rp[:, 1], straight & crossed,
                    np.where(rq[:, 0] == rp[:, 0], straight, crossed))
    return np.where(nzp | nzq, 2, np.where(
        (n_p != n_q) | ~sets_eq, 1, np.where(
            n_p == 1, far1, np.where(n_p == 2, far2, 0))))


def _abi(source: str, mb_w: int, mb_h: int, B: int, seed: int) -> dict:
    """The deblocking fields of B pictures, numpy int32 [B, n, ...]."""
    if source == "random":
        return random_deblock_abi(mb_w, mb_h, B, seed)
    lanes = []
    for b in range(B):
        if source == "synthetic_i":
            a = synthetic_abi(mb_w, mb_h, seed + b, qp=30 + b)
        else:
            a = synthetic_abi_p(mb_w, mb_h, seed + b, qp=36, n_slots=3,
                                intra_frac=0.2, bi_frac=0.5 if
                                source == "synthetic_b" else 0.0)
            a["mv"] = (a["mv"] // 16).astype(np.int32)   # bS 0 and 1 too
        lanes.append(a)
    return {k: np.stack([np.asarray(a[k]) for a in lanes]).astype(np.int32)
            for k in DEBLOCK_KEYS}


def _check(abi: dict, mb_w: int, mb_h: int, cqp_off=(0, 0),
           field: bool = False, log: dict | None = None) -> dict:
    """The model against the plain version (and, for frames, the JAX
    package lane by lane) and the wrapper on CPU tensors; returns the
    model's tables."""
    got = thread_program(abi, mb_w, mb_h, cqp_off, field, log)
    ta = {k: torch.from_numpy(v) for k, v in abi.items()}
    plain = td.deblock_tables(ta, mb_w, mb_h, cqp_off, field)
    before = dict(LAUNCHES)
    wrapped = deblock_tables(ta, mb_w, mb_h, cqp_off, field)
    assert LAUNCHES == before                 # CPU tensors: plain version
    assert list(plain) == list(got) == list(td.TABLE_KEYS)
    for k in td.TABLE_KEYS:
        assert plain[k].dtype == wrapped[k].dtype == torch.int32
        assert_same(got[k], plain[k], k)
        assert torch.equal(wrapped[k], plain[k]), k
    if not field:
        _, jtables = jax_deblock(mb_w, mb_h)
        for b in range(abi["kind"].shape[0]):
            want = jtables({k: jnp.asarray(abi[k][b]) for k in DEBLOCK_KEYS},
                           jnp.asarray(cqp_off, jnp.int32))
            for k in td.TABLE_KEYS:
                assert_same(got[k][b], want[k], f"{k}[{b}] vs JAX")
    return got


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mb_w,mb_h", GRIDS)
@pytest.mark.parametrize("source", SOURCES)
def test_thread_program_frames(source, mb_w, mb_h, B):
    abi = _abi(source, mb_w, mb_h, B, seed=31)
    tables = _check(abi, mb_w, mb_h, cqp_off=(2, -3))
    if source != "synthetic_i" and (mb_w, mb_h) == (11, 9):
        bs = np.concatenate([tables[k].ravel() for k in ("bs_v", "bs_h")])
        assert {0, 1, 2} <= set(bs.tolist())  # the MV rules took part


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mb_w,mb_h", GRIDS)
@pytest.mark.parametrize("source", ["synthetic_p", "random"])
def test_thread_program_fields(source, mb_w, mb_h, B):
    """field=True: vertical MV limit 2, bS 3 on horizontal intra MB
    edges; held to the port's plain version."""
    abi = _abi(source, mb_w, mb_h, B, seed=32)
    tables = _check(abi, mb_w, mb_h, cqp_off=(-1, 4), field=True)
    if mb_h > 1:
        assert 4 not in set(tables["bs_h"][..., 0, :].ravel().tolist())


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mb_w,mb_h", [(7, 5), (33, 2), (40, 3), (45, 2)])
def test_thread_program_strips(mb_w, mb_h, B):
    """Strips that end mid-row, a ragged last strip (n not a multiple of
    kStrip), MBs above only part of a strip, and lanes or rows whose
    scalar spans do not share shared memory's 16-byte alignment (n or
    mb_w not a multiple of 4): those come word by word, the rest in
    16-byte copies."""
    n = mb_w * mb_h
    assert n % STRIP
    abi = _abi("random", mb_w, mb_h, B, seed=36)
    log = {16: 0, 4: 0}
    _check(abi, mb_w, mb_h, cqp_off=(1, -1), log=log)
    assert log[16] > 0
    aligned = mb_w % 4 == 0 and (B == 1 or n % 4 == 0)
    assert (log[4] == 0) == aligned, log


@pytest.mark.parametrize("qp,off,cqp", [(0, -12, (-12, -12)),
                                        (51, 12, (12, 12)),
                                        (0, 12, (12, -12)),
                                        (51, -12, (-12, 12))])
def test_thread_program_extremes(qp, off, cqp):
    """qp and the offsets at their ends: every table index clamps."""
    mb_w, mb_h = 11, 9
    abi = _abi("random", mb_w, mb_h, 2, seed=33)
    abi["qp"][:] = qp
    abi["qp"][1, ::3] = 51 - qp               # neighbours at the other end
    abi["alpha_off"][:] = off
    abi["beta_off"][:] = -off
    _check(abi, mb_w, mb_h, cqp_off=cqp)


@pytest.mark.parametrize("idc", [0, 1, 2])
def test_thread_program_disable_idc(idc):
    """disable_idc across slice changes, with and without tr8: 1 masks
    every edge, 2 the MB edges between slices only."""
    mb_w, mb_h = 11, 9
    abi = _abi("synthetic_p", mb_w, mb_h, 2, seed=34)
    n = mb_w * mb_h
    abi["slice_id"][:] = (np.arange(n) // 17) % 4
    abi["disable_idc"][:] = idc
    abi["disable_idc"][1, abi["slice_id"][1] == 3] = (idc + 1) % 3
    abi["tr8"][:, ::2] = 1
    got = _check(abi, mb_w, mb_h)
    if idc == 1:
        assert not got["bs_v"][0].any() and not got["bs_h"][0].any()


def test_thread_program_refid_forms():
    """refids as the dense upload ships them (picture uids) and as the
    wire does (slot, with NX_FLAG for gap pictures): the same tables."""
    mb_w, mb_h = 11, 9
    abi = _abi("random", mb_w, mb_h, 2, seed=35)
    uid = {-1: -1, 0: 700, 1: 702, 2: 704, 3: 706, 64: 900, 65: 902}
    dense = dict(abi, refid=np.vectorize(uid.get)(abi["refid"])
                 .astype(np.int32))
    assert (abi["refid"] >= NX_FLAG).any()
    wire = thread_program(abi, mb_w, mb_h)
    for k, v in _check(dense, mb_w, mb_h).items():
        assert np.array_equal(v, wire[k]), k
