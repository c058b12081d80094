"""The raster-order kernels K5/K6 of the port against the JAX package's
raster-order Pallas kernels (interpret mode on the CPU), and the port's
raster decode path as a whole.

K5: `arrow_h264_tpu_torch.ops.kernels.intra_raster` vs
`arrow_h264_tpu.ops.pallas.intra_kernel.intra_reconstruct_pallas`.
K6: `arrow_h264_tpu_torch.ops.kernels.deblock_raster` vs
`arrow_h264_tpu.ops.pallas.deblock_kernel.deblock_pallas`.
On the CPU the wrappers run their plain versions (ops/intra.py,
ops/deblock.py); the CUDA kernels themselves are held against those on
the card (tests/test_torch_kernels_gpu.py, chip_smoke.py).  Every
comparison is exact (atol 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu.ops.pallas.deblock_kernel import deblock_pallas
from arrow_h264_tpu.ops.pallas.intra_kernel import intra_reconstruct_pallas
from arrow_h264_tpu.ops.synthetic import synthetic_abi, synthetic_abi_p
from arrow_h264_tpu_torch.ops.kernels import LAUNCHES
from arrow_h264_tpu_torch.ops.kernels.deblock_raster import deblock_raster
from arrow_h264_tpu_torch.ops.kernels.intra_raster import intra_raster
from arrow_h264_tpu_torch.ops.synthetic import random_intra_abi
from tests.torch_ref import (
    DEBLOCK_KEYS, assert_same, decode_jax, decode_port, encode, jax_deblock,
    to_jax,
)
from tools import streams

# 4x4 blocks (raster index y4*4 + x4) whose top-right block comes later in
# the spec's block order (luma4x4BlkIdx 3 and 11) but earlier in the
# wavefront's sub-step order 2*y4 + x4: a real stream never marks their
# top-right available (spec 6.4.11.4), and on such a bit the two orders
# read different samples.  The random ABIs keep that rule.
_TR_LATER = [5, 13]


@pytest.mark.parametrize("mb_w,mb_h", [(5, 4), (3, 7)])
def test_intra_raster_matches_jax_pallas(mb_w, mb_h):
    """Random ABIs of every kind (PCM with raw samples as residual) over
    random init planes, as tests/test_intra_phase.py makes them."""
    H, W = mb_h * 16, mb_w * 16
    rng = np.random.default_rng(40 + mb_w)
    abi = random_intra_abi(mb_w, mb_h, 50 + mb_w)
    abi["i4_avail"][:, _TR_LATER, 3] = 0
    shapes = ((H, W), (H // 2, W // 2), (H // 2, W // 2))
    res = [rng.integers(-300, 300, s).astype(np.int32) for s in shapes]
    pcm = np.kron((abi["kind"] == 3).reshape(mb_h, mb_w),
                  np.ones((16, 16), bool))
    res[0] = np.where(pcm, res[0] % 256, res[0])
    for c in (1, 2):
        res[c] = np.where(pcm[::2, ::2], res[c] % 256, res[c])
    init = [rng.integers(0, 256, s).astype(np.int32) for s in shapes]

    want = intra_reconstruct_pallas(
        {k: jnp.asarray(v) for k, v in abi.items()},
        *map(jnp.asarray, res), *map(jnp.asarray, init), mb_w, mb_h)
    before = dict(LAUNCHES)
    got = intra_raster({k: torch.from_numpy(v)[None] for k, v in abi.items()},
                       *(torch.from_numpy(p)[None] for p in res + init),
                       mb_w, mb_h)
    assert LAUNCHES == before                 # CPU tensors: plain version
    for g, w, name in zip(got, want, ("y", "cb", "cr")):
        assert g.dtype == torch.uint8
        assert_same(g[0], w, name)


@pytest.mark.parametrize("inter", [False, True])
def test_deblock_raster_matches_jax_pallas(inter):
    """synthetic_abi (I) and synthetic_abi_p (P/B: bS from MVs and
    references) tables over textured planes."""
    mb_w, mb_h = 5, 4
    H, W = mb_h * 16, mb_w * 16
    abi = synthetic_abi_p(mb_w, mb_h, seed=61, qp=36, bi_frac=0.3) \
        if inter else synthetic_abi(mb_w, mb_h, seed=61, qp=36)
    if inter:                     # small MV steps too: bS 0 and 1 occur
        abi["mv"] = (abi["mv"] // 16).astype(np.int32)
    rng = np.random.default_rng(62)
    planes = [(128 + rng.integers(-6, 7, s).cumsum(1) // 4).clip(0, 255)
              .astype(np.int32)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    _, jtables = jax_deblock(mb_w, mb_h)
    tables = jtables(to_jax(abi, DEBLOCK_KEYS), jnp.zeros(2, jnp.int32))
    want = deblock_pallas(*map(jnp.asarray, planes), tables, mb_w, mb_h)
    t = [torch.from_numpy(p.astype(np.uint8))[None] for p in planes]
    got = deblock_raster(*t, {k: torch.from_numpy(np.array(v))[None]
                              for k, v in tables.items()}, mb_w, mb_h)
    changed = 0
    for g, w, p, name in zip(got, want, t, ("y", "cb", "cr")):
        assert g.dtype == torch.uint8
        assert_same(g[0], w, name)
        changed += int((g != p).sum())
    assert changed > 0                        # the filter did something


@pytest.mark.parametrize("cfg", [1, 4])
def test_decoder_raster_matches_jax_and_golden(h264ref, tmp_path, cfg):
    """Decoder(device="cpu", order="raster"): config 1 (Baseline intra) and
    4 (High: CABAC, 8x8 transform, B-frames, weighted prediction)."""
    path = encode(tmp_path, cfg, n_frames=5, seed=70 + cfg)
    golden, _, _ = streams.golden_decode(path)
    ours = decode_port(path, order="raster")
    assert ours.shape == golden.shape
    for f in range(len(golden)):
        assert np.array_equal(ours[f], golden[f]), \
            f"frame {f}: {int((ours[f] != golden[f]).sum())} byte diffs"
    assert np.array_equal(ours, decode_jax(path))
