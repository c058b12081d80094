"""Port residual stage (arrow_h264_tpu_torch.ops.transforms) vs the JAX
package's ops.transforms: exact equality on synthetic and real ABIs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu.ops import transforms as jt
from arrow_h264_tpu.ops.synthetic import synthetic_abi, synthetic_abi_p
from arrow_h264_tpu_torch import convert
from arrow_h264_tpu_torch.ops import transforms as tt
from tests.torch_ref import (
    FLAT4, FLAT8, QCIF, assert_same, decode_port, encode, jax_residual,
    stream_consts, to_jax, to_torch,
)

MB_W, MB_H = QCIF[0] // 16, QCIF[1] // 16


def _compare(abi, ws4, ws8, cqp_off=(0, 0), bypass=False, omit=False,
             mb_w=MB_W, mb_h=MB_H):
    """residual_planes of both packages on one ABI.  omit: hand the port
    its all-zero coefficient classes left out, as its upload does."""
    ja = to_jax(abi)
    fn = jax_residual(mb_w, mb_h, tuple(sorted(ja)), tuple(cqp_off), bypass)
    want = fn(ja, jnp.asarray(ws4), jnp.asarray(ws8))
    ta = to_torch(abi)
    if omit:
        ta = {k: v for k, v in ta.items()
              if k not in tt.COEFF_KEYS or bool(v.any())}
    tws4, tws8 = convert.ws_from_jax(ws4, ws8)
    got = tt.residual_planes(ta, mb_w, mb_h, tws4, tws8, cqp_off,
                             bypass=bypass)
    for g, w, name in zip(got, want, ("y", "cb", "cr")):
        assert_same(g[0], w, f"res_{name}")


@pytest.mark.parametrize("kind", ["i", "p"])
def test_residual_synthetic(kind):
    abi = (synthetic_abi(MB_W, MB_H, seed=3) if kind == "i"
           else synthetic_abi_p(MB_W, MB_H, seed=3, bi_frac=0.3))
    ws4, ws8 = jt.make_ws_consts(FLAT4, FLAT8)
    _compare(abi, ws4, ws8, cqp_off=(2, -3))


def test_residual_synthetic_pcm_and_8x8():
    """PCM MBs and 8x8-transform MBs (synthetic_abi has neither)."""
    abi = synthetic_abi(MB_W, MB_H, seed=5, qp=37)
    rng = np.random.default_rng(5)
    n = MB_W * MB_H
    pick = rng.random(n)
    abi["kind"][pick < 0.2] = 3                         # I_PCM
    abi["pcm"][pick < 0.2] = rng.integers(0, 256, (int((pick < 0.2).sum()),
                                                   384))
    tr8 = (pick >= 0.2) & (pick < 0.5)
    abi["kind"][tr8] = 1                                # I8x8
    abi["tr8"][tr8] = 1
    abi["luma8"][tr8] = rng.integers(-20, 21, (int(tr8.sum()), 4, 8, 8))
    ws4, ws8 = jt.make_ws_consts(FLAT4, FLAT8)
    _compare(abi, ws4, ws8)


@pytest.mark.parametrize("cfg", [1, 4])
def test_residual_real(h264ref, tmp_path, cfg):
    """ABIs of real QCIF streams (config 4: 8x8 transform, P/B), with the
    zero classes both present and omitted."""
    cap = []
    decode_port(encode(tmp_path, cfg, n_frames=3), capture=cap)
    for abi, pipe, _, _ in cap:
        ws4, ws8, cqp = stream_consts(pipe)
        _compare(abi, ws4, ws8, cqp)
        _compare(abi, ws4, ws8, cqp, omit=True)


def test_residual_lossless(h264ref, tmp_path):
    """qpprime_y_zero_transform_bypass: raw levels + intra DPCM cumsum."""
    cap = []
    decode_port(encode(tmp_path, "lossless", n_frames=2), capture=cap)
    assert cap and all(p.sps.qpprime_y_zero_transform_bypass_flag
                       for _, p, _, _ in cap)
    for abi, pipe, _, _ in cap:
        ws4, ws8, cqp = stream_consts(pipe)
        _compare(abi, ws4, ws8, cqp, bypass=True, omit=True)


def test_tile_cumsum():
    rng = np.random.default_rng(1)
    p = rng.integers(-50, 50, (32, 48)).astype(np.int32)
    for t in (4, 8, 16):
        for axis in (0, 1):
            want = jt._tile_cumsum(jnp.asarray(p), t, axis)
            got = tt._tile_cumsum(torch.from_numpy(p)[None], t, axis)
            assert_same(got[0], want, f"t={t} axis={axis}")


@pytest.mark.parametrize("lists", ["flat", "custom"])
def test_make_ws_consts(lists):
    if lists == "flat":
        l4, l8 = FLAT4, FLAT8
    else:
        rng = np.random.default_rng(9)
        l4 = rng.integers(4, 80, (6, 16)).tolist()
        l8 = rng.integers(4, 80, (2, 64)).tolist()
    jws4, jws8 = jt.make_ws_consts(l4, l8)
    tws4, tws8 = tt.make_ws_consts(l4, l8)
    assert tws4.dtype == tws8.dtype == torch.int32
    assert_same(tws4, jws4, "ws4")
    assert_same(tws8, jws8, "ws8")
    cws4, cws8 = convert.ws_from_jax(jws4, jws8)
    assert torch.equal(cws4, tws4) and torch.equal(cws8, tws8)
