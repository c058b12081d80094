"""Spec constant tables (ITU-T H.264).

Reference parity: JM-lineage `quant.c` / `loopFilter.c` tables (SURVEY.md §2;
constants transcribed from the spec clauses noted below and validated end-to-
end against the libavcodec conformance oracle).

All tables are plain Python lists/numpy arrays; device code imports and
embeds them as constants.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Inverse scan orders (spec 8.5.6 / 8.5.7, Tables 8-13 / 8-14, frame scan).
# zigzag[k] = raster position of the k-th coefficient in scan order.
# ---------------------------------------------------------------------------
ZIGZAG_4x4 = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]

ZIGZAG_8x8 = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
]

# Field scan orders (Tables 8-13 / 8-14, field columns) — coded FIELD
# pictures scan residual coefficients column-biased; same raster-position
# convention as the frame tables above.
FIELD_SCAN_4x4 = [0, 4, 1, 8, 12, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15]

FIELD_SCAN_8x8 = [
    0, 8, 16, 1, 9, 24, 32, 17, 2, 25, 40, 48, 56, 33, 10, 3,
    18, 41, 49, 57, 26, 11, 4, 19, 34, 42, 50, 58, 27, 12, 5, 20,
    35, 43, 51, 59, 28, 13, 6, 21, 36, 44, 52, 60, 29, 14, 22, 37,
    45, 53, 61, 30, 7, 15, 38, 46, 54, 62, 23, 31, 39, 47, 55, 63,
]

# 4x4 luma block index -> (x4, y4) block coords inside the MB (spec 6.4.3,
# inverse 4x4 luma block scanning order).
BLK4_X = [0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3]
BLK4_Y = [0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3]
# raster (x4 + 4*y4) -> luma4x4BlkIdx
RASTER_TO_BLK4 = [0] * 16
for _i in range(16):
    RASTER_TO_BLK4[BLK4_X[_i] + 4 * BLK4_Y[_i]] = _i

# 8x8 block index -> (x8, y8)
BLK8_X = [0, 1, 0, 1]
BLK8_Y = [0, 0, 1, 1]

# ---------------------------------------------------------------------------
# Dequantisation normAdjust matrices (spec 8.5.9).
# ---------------------------------------------------------------------------
_V4 = [  # normAdjust4x4(m, class): class 0 pos {(0,0),(0,2),(2,0),(2,2)},
    # class 1 pos {(1,1),(1,3),(3,1),(3,3)}, class 2 otherwise
    (10, 16, 13),
    (11, 18, 14),
    (13, 20, 16),
    (14, 23, 18),
    (16, 25, 20),
    (18, 29, 23),
]

_V8 = [  # normAdjust8x8(m, class), classes per spec 8.5.9
    (20, 18, 32, 19, 25, 24),
    (22, 19, 35, 21, 28, 26),
    (26, 23, 42, 24, 33, 31),
    (28, 25, 45, 26, 35, 33),
    (32, 28, 51, 30, 40, 38),
    (36, 32, 58, 34, 46, 43),
]


def _norm_adjust_4x4() -> np.ndarray:
    """[6, 4, 4] int32."""
    out = np.zeros((6, 4, 4), np.int32)
    for m in range(6):
        for i in range(4):
            for j in range(4):
                if i % 2 == 0 and j % 2 == 0:
                    c = 0
                elif i % 2 == 1 and j % 2 == 1:
                    c = 1
                else:
                    c = 2
                out[m, i, j] = _V4[m][c]
    return out


def _norm_adjust_8x8() -> np.ndarray:
    """[6, 8, 8] int32."""
    out = np.zeros((6, 8, 8), np.int32)
    for m in range(6):
        for i in range(8):
            for j in range(8):
                if i % 4 == 0 and j % 4 == 0:
                    c = 0
                elif i % 2 == 1 and j % 2 == 1:
                    c = 1
                elif i % 4 == 2 and j % 4 == 2:
                    c = 2
                elif (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
                    c = 3
                elif (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
                    c = 4
                else:
                    c = 5
                out[m, i, j] = _V8[m][c]
    return out


NORM_ADJUST_4x4 = _norm_adjust_4x4()   # indexed [qp % 6, i(row), j(col)]
NORM_ADJUST_8x8 = _norm_adjust_8x8()


def level_scale_4x4(weight_scale_zz: list[int]) -> np.ndarray:
    """LevelScale4x4[m, i, j] = weightScale(i,j) * normAdjust4x4(m,i,j).

    `weight_scale_zz` is the 16-entry scaling list in zig-zag order
    (spec 8.5.9: weightScale is the list mapped back to raster).
    """
    ws = np.zeros((4, 4), np.int32)
    for k, pos in enumerate(ZIGZAG_4x4):
        ws[pos // 4, pos % 4] = weight_scale_zz[k]
    return ws[None] * NORM_ADJUST_4x4


def level_scale_8x8(weight_scale_zz: list[int]) -> np.ndarray:
    ws = np.zeros((8, 8), np.int32)
    for k, pos in enumerate(ZIGZAG_8x8):
        ws[pos // 8, pos % 8] = weight_scale_zz[k]
    return ws[None] * NORM_ADJUST_8x8


# ---------------------------------------------------------------------------
# Chroma QP mapping (spec Table 8-15): qPi -> QPc.
# ---------------------------------------------------------------------------
_CHROMA_QP_TAIL = [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36,
                   36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39]
CHROMA_QP_TABLE = np.array(list(range(30)) + _CHROMA_QP_TAIL, np.int32)  # [52]


def chroma_qp(qp_y: int, offset: int) -> int:
    qpi = min(max(qp_y + offset, 0), 51)
    return int(CHROMA_QP_TABLE[qpi])


# ---------------------------------------------------------------------------
# Deblocking thresholds (spec Tables 8-16, 8-17), 8-bit.
# ---------------------------------------------------------------------------
ALPHA_TABLE = np.array(
    [0] * 16 + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28,
                32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144,
                162, 182, 203, 226, 255, 255], np.int32)  # [52]

BETA_TABLE = np.array(
    [0] * 16 + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8,
                9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15,
                16, 16, 17, 17, 18, 18], np.int32)  # [52]

# tc0 indexed [bS-1][indexA] for bS in 1..3
TC0_TABLE = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 6, 6,
     7, 8, 9, 10, 11, 13],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6, 7, 8, 8,
     10, 11, 12, 13, 15, 17],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11,
     13, 14, 16, 18, 20, 23, 25],
], np.int32)  # [3, 52]


def clip3(lo, hi, v):
    return max(lo, min(hi, v))


def clip1(v):
    return max(0, min(255, v))
