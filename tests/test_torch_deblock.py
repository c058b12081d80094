"""Port deblocking (arrow_h264_tpu_torch.ops.deblock) vs the JAX
package's ops.deblock: deblock_tables and deblock_planes, exact equality
on synthetic I and P/B ABIs (bS from MVs and references) and on real
streams."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu.ops.synthetic import synthetic_abi, synthetic_abi_p
from arrow_h264_tpu_torch.ops import deblock as td
from arrow_h264_tpu_torch.ops.kernels import LAUNCHES
from arrow_h264_tpu_torch.ops.kernels.deblock_phase import deblock_phase
from tests.torch_ref import (
    DEBLOCK_KEYS, QCIF, assert_same, decode_port, encode, jax_deblock,
    stream_consts, to_jax, to_torch,
)

MB_W, MB_H = QCIF[0] // 16, QCIF[1] // 16


def _compare(abi, rng, cqp_off=(0, 0), mb_w=MB_W, mb_h=MB_H):
    H, W = mb_h * 16, mb_w * 16
    # smooth-ish planes so that the alpha/beta gates pass on many edges
    planes = [(128 + rng.integers(-6, 7, s).cumsum(1) // 4).clip(0, 255)
              .astype(np.int32)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    jplanes, jtables = jax_deblock(mb_w, mb_h)
    ja = to_jax(abi, DEBLOCK_KEYS)
    jcqp = jnp.asarray(cqp_off, jnp.int32)
    ta = to_torch(abi)
    want_t = jtables(ja, jcqp)
    got_t = td.deblock_tables(ta, mb_w, mb_h, cqp_off)
    assert set(got_t) == set(want_t) == set(td.TABLE_KEYS)
    for k in td.TABLE_KEYS:
        assert got_t[k].dtype == torch.int32
        assert_same(got_t[k][0], want_t[k], k)
    want = jplanes(ja, *map(jnp.asarray, planes), jcqp)
    t = [torch.from_numpy(p)[None] for p in planes]
    got = td.deblock_planes(ta, *t, mb_w, mb_h, cqp_off)
    for g, w, name in zip(got, want, ("y", "cb", "cr")):
        assert_same(g[0], w, name)
    changed = sum(int((g[0] != p).sum()) for g, p in zip(got, t))
    assert changed > 0                        # the filter did something
    before = dict(LAUNCHES)
    wrapped = deblock_phase(*t, got_t, mb_w, mb_h)
    assert LAUNCHES == before
    for g, w in zip(wrapped, got):
        assert g.dtype == torch.uint8 and torch.equal(g, w.to(torch.uint8))


@pytest.mark.parametrize("kind", ["i", "p", "b"])
def test_deblock_synthetic(kind):
    rng = np.random.default_rng(21)
    if kind == "i":
        abi = synthetic_abi(MB_W, MB_H, seed=21, qp=36)
    else:
        abi = synthetic_abi_p(MB_W, MB_H, seed=21, qp=36, n_slots=3,
                              bi_frac=0.5 if kind == "b" else 0.0)
        # small MV differences too, so that bS 0 and 1 both occur
        abi["mv"] = (abi["mv"] // 16).astype(np.int32)
    n = MB_W * MB_H
    abi["tr8"] = (rng.random(n) < 0.3).astype(np.int32)
    abi["alpha_off"][:] = 2
    abi["beta_off"][:] = -2
    _compare(abi, rng, cqp_off=(1, -2))


def test_deblock_slices_and_disable():
    """disable_deblocking_filter_idc 1 and 2 with several slices."""
    rng = np.random.default_rng(22)
    abi = synthetic_abi_p(MB_W, MB_H, seed=22, qp=40, bi_frac=0.3)
    n = MB_W * MB_H
    abi["slice_id"] = (np.arange(n) // 20).astype(np.int32)
    abi["disable_idc"] = np.where(abi["slice_id"] % 3 == 1, 1,
                                  np.where(abi["slice_id"] % 3 == 2, 2, 0)) \
        .astype(np.int32)
    _compare(abi, rng)


def test_deblock_batch():
    """Two streams in one port call (the stream axis) vs JAX per stream."""
    rng = np.random.default_rng(23)
    abis = [synthetic_abi_p(MB_W, MB_H, seed=s, qp=38, bi_frac=0.3)
            for s in (23, 24)]
    H, W = MB_H * 16, MB_W * 16
    planes = [rng.integers(100, 140, (2,) + s).astype(np.int32)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    ta = {k: torch.cat([to_torch(a)[k] for a in abis]) for k in DEBLOCK_KEYS}
    got = td.deblock_planes(ta, *map(torch.from_numpy, planes), MB_W, MB_H)
    jplanes, _ = jax_deblock(MB_W, MB_H)
    for b, abi in enumerate(abis):
        want = jplanes(to_jax(abi, DEBLOCK_KEYS),
                       *(jnp.asarray(p[b]) for p in planes),
                       jnp.zeros(2, jnp.int32))
        for g, w, name in zip(got, want, ("y", "cb", "cr")):
            assert_same(g[b], w, f"{name}[{b}]")


@pytest.mark.parametrize("cfg", [3, 4])
def test_deblock_real(h264ref, tmp_path, cfg):
    """ABIs of real QCIF P/B streams (CABAC, B-frames, 8x8 transform)."""
    cap = []
    decode_port(encode(tmp_path, cfg, n_frames=4, seed=13), capture=cap)
    rng = np.random.default_rng(cfg)
    for abi, pipe, _, _ in cap:
        _compare(abi, rng, stream_consts(pipe)[2])
