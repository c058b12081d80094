"""Macroblock record types and mb_type tables (spec 7.4.5, Tables 7-11..7-18).

Reference parity: JM-lineage `macroblock.c` mb_type handling (SURVEY.md §2;
implemented from the spec tables).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# macroblock categories
MB_I4x4 = 0
MB_I8x8 = 1
MB_I16x16 = 2
MB_IPCM = 3
MB_P = 4        # generic inter P (partitions in part_* fields)
MB_PSKIP = 5
MB_B = 6
MB_BSKIP = 7
MB_BDIRECT16 = 8

# Inter partition shapes (luma): (num_parts, part_w16, part_h16 in MB units)
# P mb_type 0..3 (Table 7-13): 16x16, 16x8, 8x16, 8x8 (+8x8ref0 -> 4)
P_SHAPES = {0: (1, 16, 16), 1: (2, 16, 8), 2: (2, 8, 16), 3: (4, 8, 8), 4: (4, 8, 8)}

# B mb_type 0..22 (Table 7-14): (name, shape, pred modes per part)
# pred mode: 0=L0, 1=L1, 2=Bi, 3=Direct
B_MODES = {
    0: ("B_Direct_16x16", (1, 16, 16), (3,)),
    1: ("B_L0_16x16", (1, 16, 16), (0,)),
    2: ("B_L1_16x16", (1, 16, 16), (1,)),
    3: ("B_Bi_16x16", (1, 16, 16), (2,)),
    4: ("B_L0_L0_16x8", (2, 16, 8), (0, 0)),
    5: ("B_L0_L0_8x16", (2, 8, 16), (0, 0)),
    6: ("B_L1_L1_16x8", (2, 16, 8), (1, 1)),
    7: ("B_L1_L1_8x16", (2, 8, 16), (1, 1)),
    8: ("B_L0_L1_16x8", (2, 16, 8), (0, 1)),
    9: ("B_L0_L1_8x16", (2, 8, 16), (0, 1)),
    10: ("B_L1_L0_16x8", (2, 16, 8), (1, 0)),
    11: ("B_L1_L0_8x16", (2, 8, 16), (1, 0)),
    12: ("B_L0_Bi_16x8", (2, 16, 8), (0, 2)),
    13: ("B_L0_Bi_8x16", (2, 8, 16), (0, 2)),
    14: ("B_L1_Bi_16x8", (2, 16, 8), (1, 2)),
    15: ("B_L1_Bi_8x16", (2, 8, 16), (1, 2)),
    16: ("B_Bi_L0_16x8", (2, 16, 8), (2, 0)),
    17: ("B_Bi_L0_8x16", (2, 8, 16), (2, 0)),
    18: ("B_Bi_L1_16x8", (2, 16, 8), (2, 1)),
    19: ("B_Bi_L1_8x16", (2, 8, 16), (2, 1)),
    20: ("B_Bi_Bi_16x8", (2, 16, 8), (2, 2)),
    21: ("B_Bi_Bi_8x16", (2, 8, 16), (2, 2)),
    22: ("B_8x8", (4, 8, 8), None),
}

# P sub_mb_type 0..3 (Table 7-17): (num_sub_parts, w, h)
P_SUB_SHAPES = {0: (1, 8, 8), 1: (2, 8, 4), 2: (2, 4, 8), 3: (4, 4, 4)}

# B sub_mb_type 0..12 (Table 7-18): (name, num_sub_parts, w, h, pred)
B_SUB_MODES = {
    0: ("B_Direct_8x8", 4, 4, 4, 3),
    1: ("B_L0_8x8", 1, 8, 8, 0),
    2: ("B_L1_8x8", 1, 8, 8, 1),
    3: ("B_Bi_8x8", 1, 8, 8, 2),
    4: ("B_L0_8x4", 2, 8, 4, 0),
    5: ("B_L0_4x8", 2, 4, 8, 0),
    6: ("B_L1_8x4", 2, 8, 4, 1),
    7: ("B_L1_4x8", 2, 4, 8, 1),
    8: ("B_Bi_8x4", 2, 8, 4, 2),
    9: ("B_Bi_4x8", 2, 4, 8, 2),
    10: ("B_L0_4x4", 4, 4, 4, 0),
    11: ("B_L1_4x4", 4, 4, 4, 1),
    12: ("B_Bi_4x4", 4, 4, 4, 2),
}

# Table 9-4: coded_block_pattern me(v) mapping for ChromaArrayType == 1.
# CBP_ME[codeNum] = (intra_cbp, inter_cbp)
CBP_ME = [
    (47, 0), (31, 16), (15, 1), (0, 2), (23, 4), (27, 8), (29, 32), (30, 3),
    (7, 5), (11, 10), (13, 12), (14, 15), (39, 47), (43, 7), (45, 11), (46, 13),
    (16, 14), (3, 6), (5, 9), (10, 31), (12, 35), (19, 37), (21, 42), (26, 44),
    (28, 33), (35, 34), (37, 36), (42, 40), (44, 39), (1, 43), (2, 45), (4, 46),
    (8, 17), (17, 18), (18, 20), (20, 24), (24, 19), (6, 21), (9, 26), (22, 28),
    (25, 23), (32, 27), (33, 29), (34, 30), (36, 22), (40, 25), (38, 38), (41, 41),
]
CBP_ME_INTRA_INV = {cbp: i for i, (cbp, _) in enumerate(CBP_ME)}
CBP_ME_INTER_INV = {cbp: i for i, (_, cbp) in enumerate(CBP_ME)}


def i16_fields(mb_type_m1: int) -> tuple[int, int, int]:
    """I_16x16 mb_type (1..24) - 1 -> (pred_mode, cbp_chroma, cbp_luma)."""
    k = mb_type_m1
    return k % 4, (k // 4) % 3, 15 * (k // 12)


def i16_mb_type(pred_mode: int, cbp_chroma: int, cbp_luma: int) -> int:
    """Inverse of i16_fields; returns the I-slice mb_type value (1..24)."""
    return 1 + pred_mode + 4 * cbp_chroma + 12 * (1 if cbp_luma else 0)


@dataclass
class MBRecord:
    """Everything the reconstruction stage needs for one macroblock."""

    category: int = MB_I4x4
    qp: int = 26                     # absolute luma QP after delta chaining
    transform_8x8: bool = False
    cbp_luma: int = 0                # 4 bits, one per 8x8
    cbp_chroma: int = 0              # 0/1/2
    # intra
    i4_modes: list = field(default_factory=lambda: [2] * 16)   # per 4x4 blk idx
    i8_modes: list = field(default_factory=lambda: [2] * 4)
    i16_mode: int = 0
    chroma_mode: int = 0
    # residual levels in scan order
    luma_levels: np.ndarray | None = None    # [16,16] int32 (4x4) or [4,64] (8x8)
    luma_dc: np.ndarray | None = None        # [16] int32 (I_16x16)
    chroma_dc: np.ndarray | None = None      # [2,4] int32
    chroma_ac: np.ndarray | None = None      # [2,4,16] int32 (AC in 1..15)
    pcm_samples: np.ndarray | None = None    # [384] uint8 for I_PCM
    # per-4x4-block total_coeff (for deblock nz); [4,4] by (y4, x4)
    tc_luma: np.ndarray | None = None
    # inter
    mvs: np.ndarray | None = None            # [2,4,4,2] (list,y4,x4,(mvx,mvy))
    refidx: np.ndarray | None = None         # [2,4,4] int8, -1 unused
    # bookkeeping
    slice_id: int = 0
    mb_x: int = 0
    mb_y: int = 0

    @property
    def is_intra(self) -> bool:
        return self.category in (MB_I4x4, MB_I8x8, MB_I16x16, MB_IPCM)

    @property
    def is_intra_nxn(self) -> bool:
        return self.category in (MB_I4x4, MB_I8x8)
