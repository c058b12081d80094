"""K3/K4's plain versions against the TPU kernels themselves.

The port's `ops/inter.py::mc_luma_plain` and `::mc_chroma_plain` (the
plain versions of `csrc/mc.cu`) against `mc_luma_pallas` and
`mc_chroma_pallas` of `arrow_h264_tpu/ops/pallas/mc_kernel.py`, run in
interpret mode, list by list: the same reference pictures (stored by the
JAX package and carried over by `convert.dpb_from_jax`) and the same MVs
inside the Pallas kernels' envelope.  Every sample of a cell whose list
is in use must be equal (atol 0); the port's predictions are uint8, as
the TPU kernels store them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu.models import pipeline as jp
from arrow_h264_tpu.ops.pallas import mc_kernel as mk
from arrow_h264_tpu.ops.synthetic import synthetic_abi_p
from arrow_h264_tpu_torch import convert
from arrow_h264_tpu_torch.ops.inter import (
    PAD, PADC, mc_chroma_plain, mc_luma_plain,
)
from arrow_h264_tpu_torch.ops.kernels import LAUNCHES
from arrow_h264_tpu_torch.ops.kernels.mc import mc_chroma, mc_luma

MB_W, MB_H = 6, 4
H, W = MB_H * 16, MB_W * 16
N_SLOTS = 3
SLOTS = [0, 1, 2, -1]           # the Pallas kernels' slot list


def _random_dpb(seed):
    """Three random pictures stored into the JAX packed DPB."""
    rng = np.random.default_rng(seed)
    jy, jc = jp.dpb_alloc(MB_W, MB_H, N_SLOTS)
    for s in range(N_SLOTS):
        y, cb, cr = (jnp.asarray(rng.integers(0, 256, shp, dtype=np.uint8))
                     for shp in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
        jy, jc = jp.store_ref_fn(jy, jc, s, y, cb, cr)
    return jy, jc


def _coordinate_dpb():
    """A packed DPB whose every plane holds (3 row + 7 column + 50 plane +
    90 slot) % 256: a row or column offset, or a wrong plane or slot,
    changes every sample it touches."""
    jy, jc = jp.dpb_alloc(MB_W, MB_H, N_SLOTS)
    planes = []
    for (S, P, R, L), wpx in ((jy.shape, W + 2 * PAD),
                              (jc.shape, W // 2 + 2 * PADC)):
        s, p, r, c = np.ix_(range(S), range(P), range(R), range(wpx))
        code = ((3 * r + 7 * c + 50 * p + 90 * s) % 256).astype(np.uint8)
        planes.append(jnp.stack([jnp.stack([
            mk.pack_u8_plane(jnp.asarray(code[i, j]), L) for j in range(P)])
            for i in range(S)]))
    return tuple(planes)


def _motion(case):
    """(mv [n, 4, 4, 2, 2], refslot [n, 4, 4, 2]) int32 of one case."""
    if case == "uniform":
        n = MB_W * MB_H
        mv = np.zeros((n, 4, 4, 2, 2), np.int32)
        mv[..., 0, :] = [11, 7]      # luma b+1 row, h+1 column; chroma 3/8, 7/8
        mv[..., 1, :] = [-6, 5]
        refslot = np.zeros((n, 4, 4, 2), np.int32)
        refslot[..., 1] = 2
        return mv, refslot
    abi = synthetic_abi_p(MB_W, MB_H, seed=11, n_slots=N_SLOTS, n_mv=12,
                          intra_frac=0.1,
                          bi_frac=0.5 if case == "both lists" else 0.0)
    return abi["mv"].astype(np.int32), abi["refslot"].astype(np.int32)


def _cells(used, size):
    """[n, 4, 4] cell mask -> sample mask [mb_h*4*size, mb_w*4*size]."""
    m = used.reshape(MB_H, MB_W, 4, 4).transpose(0, 2, 1, 3) \
        .reshape(MB_H * 4, MB_W * 4)
    return np.kron(m, np.ones((size, size), bool))


@pytest.mark.parametrize("case", ["one list", "both lists", "uniform"])
def test_mc_plain_matches_pallas(case):
    jy, jc = _coordinate_dpb() if case == "uniform" else _random_dpb(3)
    mv, refslot = _motion(case)
    ty, tc = convert.dpb_from_jax(np.asarray(jy), np.asarray(jc), MB_W, MB_H)
    tmv, trs = (torch.from_numpy(v)[None] for v in (mv, refslot))
    # the TPU kernel has no cross-parity chroma offset: frames' zeros
    cvoff = torch.zeros((1, N_SLOTS), dtype=torch.int32)
    got_y = mc_luma_plain(ty[None], tmv, trs, MB_W, MB_H)[0]
    got_c = mc_chroma_plain(tc[None], tmv, trs, cvoff, MB_W, MB_H)[0]
    assert got_y.dtype == got_c.dtype == torch.uint8
    abi = {"mv": jnp.asarray(mv), "refslot": jnp.asarray(refslot)}
    lists = [lst for lst in (0, 1) if (refslot[..., lst] >= 0).any()]
    assert lists == ([0] if case == "one list" else [0, 1])
    for lst in lists:
        cand, m12, info = mk.mc_prepare_luma(abi, MB_W, MB_H, SLOTS, lst)
        assert int(np.asarray(info)[:, 0].max()) <= mk.CAP   # the envelope
        want_y = mk.unpack_u32_plane(mk.mc_luma_pallas(
            jy, cand, m12, info, SLOTS, MB_W, MB_H, interpret=True), W)
        ce, co, xfyf, info = mk.mc_prepare_chroma(abi, MB_W, MB_H, SLOTS, lst)
        want_c = mk.unpack_u32_plane(mk.mc_chroma_pallas(
            jc, ce, co, xfyf, info, SLOTS, MB_W, MB_H, interpret=True),
            W // 2)
        used = refslot[..., lst] >= 0
        for got, want, mask, name in (
                (got_y[lst], want_y, _cells(used, 4), "y"),
                (got_c[lst, 0], want_c[0], _cells(used, 2), "cb"),
                (got_c[lst, 1], want_c[1], _cells(used, 2), "cr")):
            got, want = got.numpy(), np.asarray(want)
            assert want.dtype == np.uint8
            bad = (got != want) & mask
            assert not bad.any(), (case, lst, name, np.argwhere(bad)[:4],
                                   got[bad][:4], want[bad][:4])
        # samples of a list a cell does not use are 0
        assert not got_y[lst].numpy()[~_cells(used, 4)].any()
    # the wrappers on CPU tensors are these plain versions, with no launch
    before = dict(LAUNCHES)
    assert torch.equal(mc_luma(ty[None], tmv, trs, MB_W, MB_H), got_y[None])
    assert torch.equal(mc_chroma(tc[None], tmv, trs, cvoff, MB_W, MB_H),
                       got_c[None])
    assert LAUNCHES == before
