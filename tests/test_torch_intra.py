"""Port intra reconstruction (arrow_h264_tpu_torch.ops.intra, the plain
version of the intra kernel) vs the JAX package's ops.intra (XLA path):
exact equality on synthetic and real ABIs, the same residual and init
planes going into both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu.ops.abi import KIND_P
from arrow_h264_tpu.ops.synthetic import synthetic_abi, synthetic_abi_p
from arrow_h264_tpu_torch.ops import intra as ti
from arrow_h264_tpu_torch.ops.kernels import LAUNCHES
from arrow_h264_tpu_torch.ops.kernels.intra_phase import intra_phase
from arrow_h264_tpu_torch.ops.synthetic import random_intra_abi
from tests.torch_ref import (
    INTRA_KEYS, QCIF, assert_same, decode_port, encode, jax_intra, to_jax,
    to_torch,
)

MB_W, MB_H = QCIF[0] // 16, QCIF[1] // 16


def _planes(rng, mb_w, mb_h, lo, hi):
    H, W = mb_h * 16, mb_w * 16
    return [rng.integers(lo, hi, s).astype(np.int32)
            for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]


def _compare(abis, res, init, mb_w=MB_W, mb_h=MB_H):
    """abis: one ABI or a list of B; res/init: planes with the same
    leading [B] axis (or none for one ABI).  The port runs the B streams
    in one call, the JAX reference one by one."""
    if not isinstance(abis, list):
        abis, res, init = [abis], [p[None] for p in res], \
            [p[None] for p in init]
    t = [torch.from_numpy(p) for p in res + init]
    ta = {k: torch.cat([to_torch(a)[k] for a in abis]) for k in INTRA_KEYS}
    got = ti.intra_reconstruct(ta, *t[:3], mb_w, mb_h, *t[3:])
    for b, abi in enumerate(abis):
        want = jax_intra(mb_w, mb_h)(to_jax(abi, INTRA_KEYS),
                                     *(jnp.asarray(p[b]) for p in res + init))
        for g, w, name in zip(got, want, ("y", "cb", "cr")):
            # the JAX chroma planes keep the work buffer's spare rows below
            # the picture (its deblock crops them); compare the picture
            assert_same(g[b], np.asarray(w)[:g.shape[1]], f"{name}[{b}]")
    # the kernel wrapper on CPU tensors is the plain version, no launch
    before = dict(LAUNCHES)
    wrapped = intra_phase(ta, *t, mb_w, mb_h)
    assert LAUNCHES == before
    for g, w in zip(wrapped, got):
        assert g.dtype == torch.uint8 and torch.equal(g, w.to(torch.uint8))


def _inter_init(abi, rng, mb_w, mb_h):
    """Random reconstructed samples in the inter MBs, 0 elsewhere."""
    inter = (abi["kind"] >= KIND_P).reshape(mb_h, mb_w)
    out = []
    for p, s in zip(_planes(rng, mb_w, mb_h, 0, 256), (16, 8, 8)):
        m = np.kron(inter, np.ones((s, s), bool))
        out.append(np.where(m, p, 0).astype(np.int32))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_intra_synthetic(seed):
    rng = np.random.default_rng(seed)
    abi = synthetic_abi(MB_W, MB_H, seed=seed)
    zeros = [np.zeros_like(p) for p in _planes(rng, MB_W, MB_H, 0, 1)]
    _compare(abi, _planes(rng, MB_W, MB_H, -40, 41), zeros)


def test_intra_synthetic_inter_neighbours():
    """Sparse intra MBs among inter MBs (P frame): intra reads the init
    planes' inter samples as neighbours; PCM MBs take raw samples."""
    rng = np.random.default_rng(4)
    abi = synthetic_abi_p(MB_W, MB_H, seed=4, intra_frac=0.3)
    pcm = (abi["kind"] < KIND_P) & (rng.random(MB_W * MB_H) < 0.3)
    abi["kind"][pcm] = 3
    res = _planes(rng, MB_W, MB_H, -40, 41)
    pcm_y = np.kron(pcm.reshape(MB_H, MB_W), np.ones((16, 16), bool))
    res[0] = np.where(pcm_y, rng.integers(0, 256, res[0].shape), res[0]) \
        .astype(np.int32)
    _compare(abi, res, _inter_init(abi, rng, MB_W, MB_H))


def test_intra_random_batch():
    """Three streams of random ABIs in one port call (the stream axis)."""
    mb_w, mb_h, B = 5, 4, 3
    H, W = mb_h * 16, mb_w * 16
    rng = np.random.default_rng(99)
    abis = [random_intra_abi(mb_w, mb_h, 50 + i) for i in range(B)]
    shapes = ((B, H, W), (B, H // 2, W // 2), (B, H // 2, W // 2))
    res = [rng.integers(-300, 300, s).astype(np.int32) for s in shapes]
    for i, a in enumerate(abis):        # PCM residuals are raw samples
        pcm = np.kron((a["kind"] == 3).reshape(mb_h, mb_w),
                      np.ones((16, 16), bool))
        res[0][i] = np.where(pcm, res[0][i] % 256, res[0][i])
        for c in res[1:]:
            c[i] = np.where(pcm[::2, ::2], c[i] % 256, c[i])
    init = [rng.integers(0, 256, s).astype(np.int32) for s in shapes]
    _compare(abis, res, init, mb_w, mb_h)


@pytest.mark.parametrize("cfg", [1, 4])
def test_intra_real(h264ref, tmp_path, cfg):
    """ABIs of real QCIF streams: I4x4/I16x16 (config 1), I8x8 with
    reference filtering and intra MBs in P/B pictures (config 4)."""
    cap = []
    decode_port(encode(tmp_path, cfg, n_frames=3, seed=11), capture=cap)
    rng = np.random.default_rng(cfg)
    kinds = set()
    for abi, _, _, _ in cap:
        kinds |= set(np.unique(abi["kind"]).tolist())
        _compare(abi, _planes(rng, MB_W, MB_H, -30, 31),
                 _inter_init(abi, rng, MB_W, MB_H))
    assert ({0, 2} <= kinds) if cfg == 1 else ({1, KIND_P} <= kinds), kinds


def test_build_schedule():
    """Knight-move phases: every MB once, phase = 2*mb_y + mb_x."""
    for mb_w, mb_h in ((11, 9), (120, 68), (1, 5), (7, 1)):
        idx, act = ti.build_schedule(mb_w, mb_h)
        assert idx.shape[0] == mb_w + 2 * (mb_h - 1)
        seen = []
        for p in range(idx.shape[0]):
            for m in idx[p][act[p]].tolist():
                assert 2 * (m // mb_w) + m % mb_w == p
                seen.append(m)
        assert sorted(seen) == list(range(mb_w * mb_h))
