"""Device intra-mode weight tables, derived by probing the numpy oracle.

Every directional intra mode (spec 8.3.1.2 / 8.3.2.2 / 8.3.3 modes 0-1) is a
per-position non-negative integer weighted average of the reference samples:

    pred[p] = (sum_i W[p, i] * v_i + 2^(s_p - 1)) >> s_p,   sum_i W[p, i] = 2^s_p

where v = [topleft, top(2N), left(N)].  We recover W and s numerically from
oracle.intra.intra_nxn_pred using unit-vector probes (exact because weights
are non-negative integers and rounding constants are < 2^s).  This guarantees
the device kernels agree with the oracle without re-transcribing formulas.

DC and plane modes are availability/clip-dependent and are implemented
directly in ops.intra and the intra kernels (csrc/intra_mb.cuh).
"""

from __future__ import annotations

import numpy as np

from ..oracle.intra import intra_nxn_pred

# directional modes sharing the linear form (DC=2 excluded)
LINEAR_MODES = (0, 1, 3, 4, 5, 6, 7, 8)


def _probe_mode(mode: int, n: int):
    """Returns (W [n*n, 1+3n] int32, shift [n*n] int32)."""
    dim = 1 + 2 * n + n  # tl, top(2n), left(n)
    g = np.zeros((n * n, dim), np.int64)
    base = 64
    for i in range(dim):
        tl = base if i == 0 else 0
        top = np.zeros(2 * n, np.int64)
        left = np.zeros(n, np.int64)
        if 1 <= i <= 2 * n:
            top[i - 1] = base
        elif i > 2 * n:
            left[i - 1 - 2 * n] = base
        pred = intra_nxn_pred(mode, n, top, left, tl, True, True, True)
        g[:, i] = pred.ravel()
    total = g.sum(axis=1)
    assert np.all(total == base), (mode, n, total)
    ming = np.where(g > 0, g, base + 1).min(axis=1)
    shift = 6 - np.log2(ming).astype(np.int64)
    # sanity: min g is a power of two
    assert np.all((1 << (6 - shift)) == ming), (mode, n)
    w = g >> (6 - shift)[:, None]
    # verify reconstruction on a random probe
    rng = np.random.default_rng(0)
    tl = int(rng.integers(0, 256))
    top = rng.integers(0, 256, 2 * n)
    left = rng.integers(0, 256, n)
    want = intra_nxn_pred(mode, n, top, left, tl, True, True, True).ravel()
    v = np.concatenate([[tl], top, left])
    got = (w @ v + (1 << np.maximum(shift - 1, 0)) * (shift > 0)) >> shift
    assert np.array_equal(got, want), (mode, n)
    return w.astype(np.int32), shift.astype(np.int32)


def build_tables(n: int):
    """Stack mode tables: W [9, n*n, 1+3n], shift [9, n*n], rnd [9, n*n].

    Mode 2 (DC) slot is zeros (handled separately on device).
    """
    dim = 1 + 3 * n
    W = np.zeros((9, n * n, dim), np.int32)
    S = np.zeros((9, n * n), np.int32)
    for m in LINEAR_MODES:
        W[m], S[m] = _probe_mode(m, n)
    R = np.where(S > 0, 1 << np.maximum(S - 1, 0), 0).astype(np.int32)
    return W, S, R


W4, S4, R4 = build_tables(4)
W8, S8, R8 = build_tables(8)
