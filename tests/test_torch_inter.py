"""Port inter prediction (arrow_h264_tpu_torch.ops.inter) vs the JAX
package's ops.inter: half-pel planes, the reference store (through
convert.py), the gather MC with random MVs (+-512 quarter samples,
uni/bi, explicit weights, the cross-parity chroma offsets of field
pictures) and the per-cell weight resolve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu.models import pipeline as jp
from arrow_h264_tpu.ops import inter as ji
from arrow_h264_tpu.ops.synthetic import synthetic_abi_p
from arrow_h264_tpu_torch import convert
from arrow_h264_tpu_torch.models import pipeline as tp
from arrow_h264_tpu_torch.ops import inter as ti
from arrow_h264_tpu_torch.ops.kernels import LAUNCHES
from arrow_h264_tpu_torch.ops.kernels.mc import mc_chroma, mc_luma
from tests.torch_ref import (
    QCIF, assert_same, decode_port, encode, to_jax, to_torch,
)

MB_W, MB_H = QCIF[0] // 16, QCIF[1] // 16
H, W = MB_H * 16, MB_W * 16
N_SLOTS = 3


def _pictures(seed, n=N_SLOTS):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 256, s, dtype=np.uint8)
                  for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
            for _ in range(n)]


def test_halfpel_planes():
    y = _pictures(1, 1)[0][0]
    want = ji.halfpel_planes(jnp.asarray(y))
    got = ti.halfpel_planes(torch.from_numpy(y))
    for g, w, name in zip(got, want, "Gbhj"):
        assert g.dtype == torch.uint8
        assert_same(g, w, name)
    assert_same(ti.pad_chroma(torch.from_numpy(y)), ji.pad_chroma(y), "pad")


def _dpbs(pics):
    """The same reference pictures stored by both packages: (JAX packed
    DPB, JAX dense planes, port DPB)."""
    jy, jc = jp.dpb_alloc(MB_W, MB_H, len(pics))
    ty, tc = tp.dpb_alloc(MB_W, MB_H, len(pics), "cpu")
    for s, (y, cb, cr) in enumerate(pics):
        jy, jc = jp.store_ref_fn(jy, jc, s, jnp.asarray(y), jnp.asarray(cb),
                                 jnp.asarray(cr))
        tp.store_ref_fn(ty, tc, s, *map(torch.from_numpy, (y, cb, cr)))
    dense_y = jnp.stack([jnp.stack(ji.halfpel_planes(jnp.asarray(y)))
                         for y, _, _ in pics])
    dense_cb = jnp.stack([ji.pad_chroma(jnp.asarray(cb)) for _, cb, _ in pics])
    dense_cr = jnp.stack([ji.pad_chroma(jnp.asarray(cr)) for _, _, cr in pics])
    return (jy, jc), (dense_y, dense_cb, dense_cr), (ty, tc)


def test_store_ref_and_convert():
    """Port store_ref_fn == the JAX packed DPB carried over by convert."""
    (jy, jc), _, (ty, tc) = _dpbs(_pictures(2))
    cy, cc = convert.dpb_from_jax(np.asarray(jy), np.asarray(jc), MB_W, MB_H)
    assert cy.dtype == cc.dtype == torch.uint8
    assert torch.equal(cy, ty) and torch.equal(cc, tc)


def _dpbs_converted(pics):
    """JAX packed and dense DPBs, and the port's DPB converted from the
    packed one."""
    (jy, jc), dense, _ = _dpbs(pics)
    return (jy, jc), dense, convert.dpb_from_jax(np.asarray(jy),
                                                 np.asarray(jc), MB_W, MB_H)


def _motion(case: str, seed: int):
    """mv/refslot/wp/logwd/cvoff for one MC case (host numpy).  cvoff:
    each slot's vertical chroma offset, -2, 0 or +2 in the "cvoff" case
    (slots of the other field parity), else 0 (frames)."""
    rng = np.random.default_rng(seed)
    abi = synthetic_abi_p(MB_W, MB_H, seed=seed, n_slots=N_SLOTS,
                          intra_frac=0.1,
                          bi_frac=0.0 if case == "uni" else 0.5)
    n = MB_W * MB_H
    mv = abi["mv"]
    if case in ("wild", "weighted"):
        wild = rng.random((n, 4, 4, 2)) < 0.5
        mv = np.where(wild[..., None], rng.integers(-512, 513, mv.shape), mv)
    wp = np.zeros((n, 4, 4, 2, 3, 2), np.int32)
    wp[..., 0] = 1
    logwd = np.zeros((n, 2), np.int32)
    if case == "weighted":
        wp[..., 0] = rng.integers(-128, 128, wp[..., 0].shape)
        wp[..., 1] = rng.integers(-128, 128, wp[..., 1].shape)
        logwd = rng.integers(0, 8, (n, 2)).astype(np.int32)
    cvoff = np.zeros(N_SLOTS, np.int32)
    if case == "cvoff":
        cvoff = np.array([-2, 2, 0], np.int32)[rng.permutation(N_SLOTS)]
    return {"mv": mv.astype(np.int32), "refslot": abi["refslot"],
            "wp": wp, "logwd": logwd, "cvoff": cvoff}


@pytest.mark.parametrize("case", ["uni", "bi", "wild", "weighted", "cvoff"])
def test_gather_mc(case):
    (jy, jc), (dy, dcb, dcr), (ty, tc) = _dpbs_converted(_pictures(3))
    m = _motion(case, {"uni": 4, "bi": 5, "wild": 6, "weighted": 7,
                       "cvoff": 8}[case])
    ja = {k: jnp.asarray(v) for k, v in m.items()}
    want_packed = ji.inter_predict_packed(ja, jy, jc, MB_W, MB_H)
    want_dense = ji.inter_predict(ja, dy, dcb, dcr, MB_W, MB_H)
    ta = {k: torch.from_numpy(v)[None] for k, v in m.items()}
    got = ti.inter_predict(ta, ty[None], tc[None], MB_W, MB_H)
    # cells with no list in use (intra MBs) are garbage in both packages
    used = (m["refslot"] >= 0).any(-1).reshape(MB_H, MB_W, 4, 4)
    used = used.transpose(0, 2, 1, 3).reshape(MB_H * 4, MB_W * 4)
    for g, wp_, wd, s, name in zip(got, want_packed, want_dense, (4, 2, 2),
                                   ("y", "cb", "cr")):
        mask = np.kron(used, np.ones((s, s), bool))
        g = g[0].numpy()
        assert_same(np.where(mask, g, 0), np.where(mask, wp_, 0), name)
        assert_same(np.where(mask, g, 0), np.where(mask, wd, 0), name)
    # the kernel wrappers on CPU tensors are the plain versions, no launch
    before = dict(LAUNCHES)
    assert torch.equal(mc_luma(ty[None], ta["mv"], ta["refslot"], MB_W, MB_H),
                       ti.mc_luma_plain(ty[None], ta["mv"], ta["refslot"],
                                        MB_W, MB_H))
    assert torch.equal(mc_chroma(tc[None], ta["mv"], ta["refslot"],
                                 ta["cvoff"], MB_W, MB_H),
                       ti.mc_chroma_plain(tc[None], ta["mv"], ta["refslot"],
                                          ta["cvoff"], MB_W, MB_H))
    assert LAUNCHES == before


@pytest.mark.parametrize("cfg", [3, 4])
def test_resolve_weights_real(h264ref, tmp_path, cfg):
    """Per-cell weights of real streams: implicit B (config 3) and
    explicit weighted P/B (config 4)."""
    cap = []
    decode_port(encode(tmp_path, cfg, n_frames=4, seed=17), capture=cap)
    keys = ("slice_id", "refidx", "wtab", "slogwd")
    weighted = False
    for abi, _, _, _ in cap:
        want = jp.resolve_weights(to_jax(abi, keys))
        got = tp.resolve_weights(to_torch({k: abi[k] for k in keys}))
        for k in ("wp", "logwd"):
            assert_same(got[k][0], want[k], k)
        weighted |= bool((np.asarray(want["wp"])[..., 0] != 1).any())
        # a frame with dense per-cell weights (the slice-row overflow
        # fallback) uploads them in place of the tables, unchanged
        dense = dict(abi, wp=np.asarray(want["wp"]),
                     logwd=np.asarray(want["logwd"]))
        up = tp.upload_abi(dense, "cpu")
        assert "wtab" not in up and "slogwd" not in up
        again = tp.resolve_weights({k: v[None] for k, v in up.items()})
        for k in ("wp", "logwd"):
            assert torch.equal(again[k], got[k])
    assert weighted
