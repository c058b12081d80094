"""The work order of the persistent wavefront kernels
(arrow_h264_tpu_torch.ops.kernels.wavefront) against the knight-phase
schedule of the JAX package's Pallas kernels (ops/pallas/deblock_phase.py):
the same phases, in the same order, and every MB after the neighbours it
reads."""

import numpy as np
import pytest
import torch

from arrow_h264_tpu.ops.pallas.deblock_phase import n_phases
from arrow_h264_tpu_torch.ops.kernels.wavefront import (
    wavefront_args, wavefront_order,
)

SIZES = [(1, 1), (1, 6), (6, 1), (7, 5), (120, 68)]


@pytest.mark.parametrize("mb_w,mb_h", SIZES)
def test_order_is_a_schedule(mb_w, mb_h):
    order = wavefront_order(mb_w, mb_h)
    n = mb_w * mb_h
    assert order.dtype == np.int32 and order.shape == (n,)
    assert sorted(order.tolist()) == list(range(n))
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    for m in range(n):
        my, mx = divmod(m, mb_w)
        # left, top-left, top, top-right: what intra and deblock read
        for dx, dy in ((-1, 0), (-1, -1), (0, -1), (1, -1)):
            x, y = mx + dx, my + dy
            if 0 <= x < mb_w and y >= 0:
                assert pos[y * mb_w + x] < pos[m], (m, x, y)


@pytest.mark.parametrize("mb_w,mb_h", SIZES)
def test_order_follows_the_jax_phases(mb_w, mb_h):
    order = wavefront_order(mb_w, mb_h)
    my, mx = np.divmod(order, mb_w)
    phase = 2 * my + mx
    # the JAX schedule's phases that hold an MB: all n_phases of them,
    # except the odd (empty) ones of a one-MB-wide frame
    jax_phases = {p for p in range(n_phases(mb_w, mb_h))
                  if any(0 <= p - 2 * y < mb_w for y in range(mb_h))}
    assert set(phase.tolist()) == jax_phases
    assert len(jax_phases) == (n_phases(mb_w, mb_h) if mb_w > 1 else mb_h)
    assert np.all(np.diff(phase) >= 0)
    # within a phase, rows ascend
    same = np.diff(phase) == 0
    assert np.all(np.diff(my)[same] > 0)


def test_wavefront_args_caches_the_order():
    o1, s1 = wavefront_args(3, 7, 5, torch.device("cpu"))
    o2, s2 = wavefront_args(2, 7, 5, torch.device("cpu"))
    assert o1 is o2
    assert torch.equal(o1, torch.from_numpy(wavefront_order(7, 5)))
    assert s1.dtype == torch.int32 and s1.shape == (3 * 35 + 1,)
    assert s2.shape == (2 * 35 + 1,)
    o3, s3 = wavefront_args(3, 7, 5, torch.device("cpu"), parts=2)
    assert o3 is o1 and s3.shape == (2 * 3 * 35 + 1,)


def test_probe_variants_apply(tmp_path):
    """Every source edit of tools/wavefront_probe.py still finds its text
    in the kernels' sources, so the probe builds each variant."""
    from tools import wavefront_probe
    for name in wavefront_probe.VARIANTS:
        srcs = wavefront_probe.variant_sources(name, tmp_path / name)
        assert [s.name for s in srcs] == list(wavefront_probe.SOURCES)
        assert all(s.exists() for s in srcs)
