"""K7, the deblocking-table kernel (csrc/deblock_tables.cu), on the CPU.

`thread_program` is a numpy model of the kernel: one lane of the vectors
is one thread, a (MB, direction), and it reads and writes the flat ABI
and table arrays with the .cu's index arithmetic and constant-table
reads.  It must equal the port's plain ops/deblock.py::deblock_tables on
every input, and, for frame pictures, the JAX package's deblock_tables
(tests/torch_ref.py::jax_deblock); field pictures are held to the port's
plain version only, since the JAX package uses the frame MV limit there
(ROADMAP §C2).  Every comparison is exact (atol 0).
"""

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

GRIDS = [(1, 1), (1, 6), (6, 1), (11, 9)]
SOURCES = ["synthetic_i", "synthetic_p", "synthetic_b", "random"]
ALPHA, BETA, CQP = (np.asarray(t, np.int64) for t in
                    (ALPHA_TABLE, BETA_TABLE, CHROMA_QP_TABLE))
TC0 = np.asarray(TC0_TABLE, np.int64).reshape(-1)       # [3 * 52]


def thread_program(abi: dict, mb_w: int, mb_h: int, cqp_off=(0, 0),
                   field: bool = False) -> dict:
    """deblock_tables_kernel, every thread at once: abi's fields as
    numpy [B, n, ...] -> the twelve tables, int32, in their shapes."""
    B = abi["kind"].shape[0]
    n = mb_w * mb_h
    f = {k: np.ascontiguousarray(abi[k]).reshape(-1).astype(np.int64)
         for k, _ in ABI_FIELDS}
    out = {k: np.full(B * n * int(np.prod(s)), -99, np.int64)
           for k, s in td.TABLE_SHAPES.items()}
    t = np.arange(2 * B * n)
    d = t & 1
    self_ = t >> 1
    m = self_ % n
    mx, my = m % mb_w, m // mb_w
    horiz = d == 1
    has_nb = np.where(horiz, my > 0, mx > 0)
    nb = np.where(has_nb, self_ - np.where(horiz, mb_w, 1), self_)

    q_intra, p_intra = f["kind"][self_] <= 3, f["kind"][nb] <= 3
    qp, qp_nb = f["qp"][self_], f["qp"][nb]
    dis = f["disable_idc"][self_]
    do_any = dis != 1
    edge0_ok = do_any & has_nb & ~((dis == 2) & (f["slice_id"][nb] !=
                                                 f["slice_id"][self_]))
    tr8 = f["tr8"][self_] > 0
    aoff, boff = f["alpha_off"][self_], f["beta_off"][self_]
    limit_y = 2 if field else 4

    def load_blk(mb, blk):
        c = mb * 16 + blk
        ref = np.stack([f["refid"][c * 2 + ll] for ll in range(2)], -1)
        mv = np.stack([np.stack([f["mv"][(c * 2 + ll) * 2 + k]
                                 for k in range(2)], -1)
                       for ll in range(2)], -2)            # [T, list, comp]
        return f["nz"][c] > 0, ref, mv

    def far(a, b):
        return (np.abs(a[..., 0] - b[..., 0]) >= 4) | \
            (np.abs(a[..., 1] - b[..., 1]) >= limit_y)

    def bs_pair(ip, iq, mb_edge, p, q):
        nzp, rp, mvp = p
        nzq, rq, mvq = q
        n_p = (rp >= 0).sum(-1)
        n_q = (rq >= 0).sum(-1)
        sets_eq = (rp.min(-1) == rq.min(-1)) & (rp.max(-1) == rq.max(-1))
        ix = np.arange(len(rp))
        far1 = far(mvp[ix, np.where(rp[:, 0] >= 0, 0, 1)],
                   mvq[ix, np.where(rq[:, 0] >= 0, 0, 1)])
        straight = far(mvp[:, 0], mvq[:, 0]) | far(mvp[:, 1], mvq[:, 1])
        crossed = far(mvp[:, 0], mvq[:, 1]) | far(mvp[:, 1], mvq[:, 0])
        far2 = np.where(rp[:, 0] == rp[:, 1], straight & crossed,
                        np.where(rq[:, 0] == rp[:, 0], straight, crossed))
        strong = np.where(mb_edge & ~(field & horiz), 4, 3)
        return np.where(ip | iq, strong, np.where(
            nzp | nzq, 2, np.where(
                (n_p != n_q) | ~sets_eq, 1, np.where(
                    n_p == 1, far1, np.where(n_p == 2, far2, False)))))

    def put(names, index, vals):
        for h, arr in enumerate((out[names[0]], out[names[1]])):
            sel = horiz == bool(h)
            arr[index[sel]] = vals[sel]

    clamp = lambda v: np.clip(v, 0, 51)
    bs_chroma = np.zeros((2, 4, len(t)), np.int64)
    for e in range(4):
        mb_edge = e == 0
        mask = edge0_ok if mb_edge else do_any & ((e == 2) | ~tr8)
        p_mb = nb if mb_edge else self_
        qpp = qp_nb if mb_edge else qp
        qpav = (qpp + qp + 1) >> 1
        ia, ib = clamp(qpav + aoff), clamp(qpav + boff)
        put(("a_v", "a_h"), self_ * 4 + e, ALPHA[ia])
        put(("b_v", "b_h"), self_ * 4 + e, BETA[ib])
        for s in range(4):
            q_blk = np.where(horiz, e * 4 + s, s * 4 + e)
            pe = 3 if mb_edge else e - 1
            p_blk = np.where(horiz, pe * 4 + s, s * 4 + pe)
            bs = bs_pair(p_intra if mb_edge else q_intra, q_intra,
                         np.full(len(t), mb_edge), load_blk(p_mb, p_blk),
                         load_blk(self_, q_blk)).astype(np.int64)
            bs = np.where(mask, bs, 0)
            row = np.clip(bs - 1, 0, 2)
            put(("bs_v", "bs_h"), (self_ * 4 + e) * 4 + s, bs)
            put(("tc_v", "tc_h"), (self_ * 4 + e) * 4 + s, TC0[row * 52 + ia])
            if e % 2 == 0:
                bs_chroma[e // 2, s] = bs
    for e in range(2):
        qpp = qp_nb if e == 0 else qp
        de = (self_ * 2 + d) * 2 + e
        for s in range(4):
            out["bs_c"][de * 4 + s] = bs_chroma[e, s]
        for pl in range(2):
            qpc_p = CQP[clamp(qpp + cqp_off[pl])]
            qpc_q = CQP[clamp(qp + cqp_off[pl])]
            qpav = (qpc_p + qpc_q + 1) >> 1
            ia, ib = clamp(qpav + aoff), clamp(qpav + boff)
            out["a_c"][de * 2 + pl] = ALPHA[ia]
            out["b_c"][de * 2 + pl] = BETA[ib]
            for s in range(4):
                row = np.clip(bs_chroma[e, s] - 1, 0, 2)
                out["tc_c"][(de * 4 + s) * 2 + pl] = TC0[row * 52 + ia]
    return {k: v.reshape((B, n) + td.TABLE_SHAPES[k]).astype(np.int32)
            for k, v in out.items()}


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
           field: bool = False) -> dict:
    """The model against the plain version (and, for frames, the JAX
    package lane by lane) and the wrapper on CPU tensors; returns the
    model's tables."""
    got = thread_program(abi, mb_w, mb_h, cqp_off, field)
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
