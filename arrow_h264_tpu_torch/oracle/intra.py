"""Spec-literal Intra_4x4 / Intra_8x8 prediction (numpy, spec 8.3.1.2 /
8.3.2.2): the probe that ops/intra_tables.py derives its weight tables
from.  The Intra_16x16, chroma and 8x8 reference-filter parts of the JAX
package's numpy oracle are not copied: the port reconstructs with
ops/intra.py and its kernels.

Reference parity: JM-lineage `intra4x4_pred.c` / `intra8x8_pred.c` /
`intra16x16_pred.c` / `intra_chroma_pred.c` (SURVEY.md §2; implemented from
spec 8.3.1-8.3.4).

Conventions: `top` is p[0..2N-1, -1] (includes top-right extension),
`left` is p[-1, 0..N-1], `topleft` is p[-1,-1].  Availability flags gate
which samples are meaningful.  All arrays int (any int dtype), outputs int32.
"""

from __future__ import annotations

import numpy as np

# Intra_4x4 / Intra_8x8 prediction modes (spec Tables 8-2, 8-3)
I_VERT, I_HOR, I_DC, I_DDL, I_DDR, I_VR, I_HD, I_VL, I_HU = range(9)
# Intra_16x16 modes (Table 8-4)
I16_VERT, I16_HOR, I16_DC, I16_PLANE = range(4)
# Chroma modes (Table 8-5)
C_DC, C_HOR, C_VERT, C_PLANE = range(4)


def intra_nxn_pred(mode: int, n: int, top: np.ndarray, left: np.ndarray,
                   topleft: int, avail_top: bool, avail_left: bool,
                   avail_topleft: bool) -> np.ndarray:
    """Generic Intra_4x4 / Intra_8x8 mode prediction (spec 8.3.1.2 / 8.3.2.2).

    `top` must already include the top-right extension (length 2n) with the
    unavailable-top-right substitution applied by the caller; for 8x8 the
    caller must also have applied reference-sample filtering (8.3.2.2.1).
    """
    t = top.astype(np.int64)
    l = left.astype(np.int64)
    tl = int(topleft)
    x = np.arange(n)[None, :].repeat(n, 0)   # pred[y, x]
    y = np.arange(n)[:, None].repeat(n, 1)

    if mode == I_VERT:
        return np.broadcast_to(t[:n][None, :], (n, n)).astype(np.int32).copy()
    if mode == I_HOR:
        return np.broadcast_to(l[:, None], (n, n)).astype(np.int32).copy()
    if mode == I_DC:
        if avail_top and avail_left:
            v = (int(t[:n].sum()) + int(l.sum()) + n) >> int(np.log2(n) + 1)
        elif avail_left:
            v = (int(l.sum()) + n // 2) >> int(np.log2(n))
        elif avail_top:
            v = (int(t[:n].sum()) + n // 2) >> int(np.log2(n))
        else:
            v = 128
        return np.full((n, n), v, np.int32)
    if mode == I_DDL:
        idx = x + y
        a = t[np.minimum(idx, 2 * n - 2)]
        b = t[np.minimum(idx + 1, 2 * n - 1)]
        c = t[np.minimum(idx + 2, 2 * n - 1)]
        pred = (a + 2 * b + c + 2) >> 2
        pred[n - 1, n - 1] = (t[2 * n - 2] + 3 * t[2 * n - 1] + 2) >> 2
        return pred.astype(np.int32)
    # pt(i) == p[i, -1] and pl(i) == p[-1, i] with i == -1 -> p[-1, -1];
    # several modes (DDR/VR/HD) legitimately index -1, so use extended arrays.
    te = np.concatenate([[tl], t])  # te[i + 1] = p[i, -1]
    le = np.concatenate([[tl], l])  # le[i + 1] = p[-1, i]

    def pt(i: int) -> int:
        return int(te[i + 1])

    def pl(i: int) -> int:
        return int(le[i + 1])

    if mode == I_DDR:
        pred = np.zeros((n, n), np.int64)
        for yy in range(n):
            for xx in range(n):
                if xx > yy:
                    pred[yy, xx] = (pt(xx - yy - 2) + 2 * pt(xx - yy - 1) + pt(xx - yy) + 2) >> 2
                elif xx < yy:
                    pred[yy, xx] = (pl(yy - xx - 2) + 2 * pl(yy - xx - 1) + pl(yy - xx) + 2) >> 2
                else:
                    pred[yy, xx] = (pt(0) + 2 * tl + pl(0) + 2) >> 2
        return pred.astype(np.int32)
    if mode == I_VR:
        pred = np.zeros((n, n), np.int64)
        for yy in range(n):
            for xx in range(n):
                zvr = 2 * xx - yy
                if zvr >= 0 and zvr % 2 == 0:
                    pred[yy, xx] = (pt(xx - (yy >> 1) - 1) + pt(xx - (yy >> 1)) + 1) >> 1
                elif zvr >= 0:
                    pred[yy, xx] = (pt(xx - (yy >> 1) - 2) + 2 * pt(xx - (yy >> 1) - 1)
                                    + pt(xx - (yy >> 1)) + 2) >> 2
                elif zvr == -1:
                    pred[yy, xx] = (pl(0) + 2 * tl + pt(0) + 2) >> 2
                else:
                    pred[yy, xx] = (pl(yy - 2 * xx - 1) + 2 * pl(yy - 2 * xx - 2)
                                    + pl(yy - 2 * xx - 3) + 2) >> 2
        return pred.astype(np.int32)
    if mode == I_HD:
        pred = np.zeros((n, n), np.int64)
        for yy in range(n):
            for xx in range(n):
                zhd = 2 * yy - xx
                if zhd >= 0 and zhd % 2 == 0:
                    pred[yy, xx] = (pl(yy - (xx >> 1) - 1) + pl(yy - (xx >> 1)) + 1) >> 1
                elif zhd >= 0:
                    pred[yy, xx] = (pl(yy - (xx >> 1) - 2) + 2 * pl(yy - (xx >> 1) - 1)
                                    + pl(yy - (xx >> 1)) + 2) >> 2
                elif zhd == -1:
                    pred[yy, xx] = (pl(0) + 2 * tl + pt(0) + 2) >> 2
                else:
                    pred[yy, xx] = (pt(xx - 2 * yy - 1) + 2 * pt(xx - 2 * yy - 2)
                                    + pt(xx - 2 * yy - 3) + 2) >> 2
        return pred.astype(np.int32)
    if mode == I_VL:
        pred = np.zeros((n, n), np.int64)
        for yy in range(n):
            for xx in range(n):
                i = xx + (yy >> 1)
                if yy % 2 == 0:
                    pred[yy, xx] = (t[i] + t[i + 1] + 1) >> 1
                else:
                    pred[yy, xx] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return pred.astype(np.int32)
    if mode == I_HU:
        pred = np.zeros((n, n), np.int64)
        zmax = 2 * (n - 1) - 1  # 5 for 4x4, 13 for 8x8
        for yy in range(n):
            for xx in range(n):
                zhu = xx + 2 * yy
                i = yy + (xx >> 1)
                if zhu < zmax and zhu % 2 == 0:
                    pred[yy, xx] = (l[i] + l[i + 1] + 1) >> 1
                elif zhu < zmax:
                    pred[yy, xx] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
                elif zhu == zmax:
                    pred[yy, xx] = (l[n - 2] + 3 * l[n - 1] + 2) >> 2
                else:
                    pred[yy, xx] = l[n - 1]
        return pred.astype(np.int32)
    raise ValueError(f"bad intra mode {mode}")
