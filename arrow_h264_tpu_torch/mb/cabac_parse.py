"""CABAC slice-data / macroblock-layer parser (spec 7.3.4, 9.3).

Reference parity: JM-lineage `cabac.c` / `read_comp_cabac.c` (SURVEY.md §2;
implemented from spec 9.3.2-9.3.3; context init tables in
entropy.cabac_init_tables).

Shares all semantic derivations (MV prediction, direct modes, neighbor
availability) with the CAVLC parser via PictureParse; only the entropy
layer differs.  Produces identical MBRecords.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.bits import BitReader
from ..bitstream.slicehdr import SliceHeader
from ..entropy.cabac import CabacDecoder
from .types import (
    B_MODES, B_SUB_MODES, MB_B, MB_BDIRECT16, MB_BSKIP, MB_I4x4, MB_I8x8,
    MB_I16x16, MB_IPCM, MB_P, MB_PSKIP, MBRecord, P_SHAPES, P_SUB_SHAPES,
    i16_fields,
)

# significance-map context increments for 8x8 blocks, frame scan
# (spec Table 9-43, validated against libavcodec/libx264 binaries)
SIG8x8 = [0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5, 4, 4, 4, 4, 3, 3,
          6, 7, 7, 7, 8, 9, 10, 9, 8, 7, 7, 6, 11, 12, 13, 11, 6, 7, 8, 9,
          14, 10, 9, 8, 6, 11, 12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11,
          14, 10, 12]
LAST8x8 = [0] + [1] * 15 + [2] * 16 + [3] * 8 + [4] * 8 + [5] * 4 + \
    [6] * 4 + [7] * 4 + [8] * 3

# 8x8 significance increments for FIELD-coded pictures (Table 9-43 field
# column, validated against libavcodec on CABAC field streams);
# last_significant shares LAST8x8 between frame and field.
SIG8x8_FIELD = [0, 1, 1, 2, 2, 3, 3, 4, 5, 6, 7, 7, 7, 8, 4, 5,
                6, 9, 10, 10, 8, 11, 12, 11, 9, 9, 10, 10, 8, 11, 12, 11,
                9, 9, 10, 10, 8, 11, 12, 11, 9, 9, 10, 10, 8, 13, 13, 9,
                9, 10, 10, 8, 13, 13, 9, 9, 10, 10, 14, 14, 14, 14, 14]

# ctxBlockCat offsets (spec Table 9-40)
SIG_CAT_OFF = {0: 0, 1: 15, 2: 29, 3: 44, 4: 47}
ABS_CAT_OFF = {0: 0, 1: 10, 2: 20, 3: 30, 4: 39}
CBF_CAT_OFF = {0: 0, 1: 4, 2: 8, 3: 12, 4: 16}


class CabacSliceParser:
    def __init__(self, pic, r: BitReader, hdr: SliceHeader, reflists,
                 cur_poc: int):
        self.pic = pic
        self.hdr = hdr
        self.l0, self.l1 = reflists
        self.cur_poc = cur_poc
        self.cur_slice = len(pic.headers)
        pic.headers.append(hdr)
        pic.slice_reflists.append(reflists)
        self.qp = hdr.qp(pic.pps)
        self.dec = CabacDecoder(r)
        self.dec.init_contexts(self.qp, hdr.is_i, hdr.cabac_init_idc)
        self.prev_qp_delta = 0
        # CBF state maps (coded_block_flag values for neighbor ctx, 9.3.3.1.1.9)
        if not hasattr(pic, "cbf_luma"):
            h4, w4 = pic.mb_h * 4, pic.mb_w * 4
            pic.cbf_luma = np.zeros((h4, w4), np.int8)
            pic.cbf_luma_dc = np.zeros((pic.mb_h, pic.mb_w), np.int8)
            pic.cbf_cdc = np.zeros((2, pic.mb_h, pic.mb_w), np.int8)
            pic.cbf_cac = np.zeros((2, pic.mb_h * 2, pic.mb_w * 2), np.int8)
            pic.mvd_grid = np.zeros((2, h4, w4, 2), np.int32)

    # -- neighbor helpers ---------------------------------------------------

    def _nb_mb(self, mb_x: int, mb_y: int):
        """Neighbor MBRecord if available in this slice, else None."""
        pic = self.pic
        if mb_x < 0 or mb_y < 0 or mb_x >= pic.mb_w or mb_y >= pic.mb_h:
            return None
        if pic.slice_map[mb_y, mb_x] != self.cur_slice:
            return None
        return pic.mbs[mb_y * pic.mb_w + mb_x]

    def _skip_inc(self, mb_x: int, mb_y: int) -> int:
        inc = 0
        for nb in (self._nb_mb(mb_x - 1, mb_y), self._nb_mb(mb_x, mb_y - 1)):
            if nb is not None and nb.category not in (MB_PSKIP, MB_BSKIP):
                inc += 1
        return inc

    def _imbtype_inc(self, mb_x: int, mb_y: int) -> int:
        inc = 0
        for nb in (self._nb_mb(mb_x - 1, mb_y), self._nb_mb(mb_x, mb_y - 1)):
            if nb is not None and nb.category not in (MB_I4x4, MB_I8x8):
                inc += 1
        return inc

    def _bmbtype_inc(self, mb_x: int, mb_y: int) -> int:
        inc = 0
        for nb in (self._nb_mb(mb_x - 1, mb_y), self._nb_mb(mb_x, mb_y - 1)):
            if nb is not None and nb.category not in (MB_BSKIP, MB_BDIRECT16):
                inc += 1
        return inc

    def _tr8_inc(self, mb_x: int, mb_y: int) -> int:
        inc = 0
        for nb in (self._nb_mb(mb_x - 1, mb_y), self._nb_mb(mb_x, mb_y - 1)):
            if nb is not None and nb.transform_8x8:
                inc += 1
        return inc

    def _chroma_mode_inc(self, mb_x: int, mb_y: int) -> int:
        inc = 0
        for nb in (self._nb_mb(mb_x - 1, mb_y), self._nb_mb(mb_x, mb_y - 1)):
            if nb is not None and nb.is_intra and nb.category != MB_IPCM \
                    and nb.chroma_mode != 0:
                inc += 1
        return inc

    # -- small syntax elements ----------------------------------------------

    def mb_qp_delta(self) -> int:
        d = self.dec
        if not d.decision(60 + (1 if self.prev_qp_delta else 0)):
            self.prev_qp_delta = 0
            return 0
        k = 1 + d.unary(lambda i: 62 if i == 0 else 63)
        delta = (k + 1) >> 1 if k & 1 else -(k >> 1)
        self.prev_qp_delta = delta
        return delta

    def intra_chroma_mode(self, mb_x: int, mb_y: int) -> int:
        d = self.dec
        if not d.decision(64 + self._chroma_mode_inc(mb_x, mb_y)):
            return 0
        return 1 + d.unary(lambda i: 67, c_max=2)

    def intra4x4_mode(self, pred: int) -> int:
        d = self.dec
        if d.decision(68):
            return pred
        rem = d.decision(69) | (d.decision(69) << 1) | (d.decision(69) << 2)
        return rem if rem < pred else rem + 1

    def cbp(self, mb_x: int, mb_y: int) -> tuple[int, int]:
        """coded_block_pattern (9.3.3.1.1.4): 4 luma bins + 2 chroma bins."""
        d = self.dec
        nb_a = self._nb_mb(mb_x - 1, mb_y)
        nb_b = self._nb_mb(mb_x, mb_y - 1)

        def l_bit(nb, b8) -> int:
            # neighbor's cbp bit; UNAVAILABLE acts as bit SET (condTerm 0)
            if nb is None:
                return 1
            if nb.category == MB_IPCM:
                return 1
            if nb.category in (MB_PSKIP, MB_BSKIP):
                return 0
            return (nb.cbp_luma >> b8) & 1

        cbp_l = 0
        for b8 in range(4):
            x8, y8 = b8 & 1, b8 >> 1
            if x8 == 0:
                a = l_bit(nb_a, y8 * 2 + 1)
            else:
                a = (cbp_l >> (y8 * 2)) & 1
            if y8 == 0:
                b = l_bit(nb_b, 2 + x8)
            else:
                b = (cbp_l >> x8) & 1
            ctx = 73 + (1 - a) + 2 * (1 - b)
            if d.decision(ctx):
                cbp_l |= 1 << b8
        # chroma

        def c_val(nb) -> int:
            if nb is None:
                return 0
            if nb.category == MB_IPCM:
                return 2
            if nb.category in (MB_PSKIP, MB_BSKIP):
                return 0
            return nb.cbp_chroma

        ca, cb_ = c_val(nb_a), c_val(nb_b)
        inc0 = (1 if ca else 0) + 2 * (1 if cb_ else 0)
        cbp_c = 0
        if d.decision(77 + inc0):
            inc1 = (1 if ca == 2 else 0) + 2 * (1 if cb_ == 2 else 0)
            cbp_c = 2 if d.decision(81 + inc1) else 1
        return cbp_l, cbp_c

    def ref_idx(self, lst: int, px: int, py: int, cur_key: int,
                n_ref: int) -> int:
        if n_ref <= 1:
            return 0
        d = self.dec

        def cond(nx, ny) -> int:
            av, ref, _ = self.pic._mv_neighbor(lst, nx, ny, self.cur_slice,
                                               cur_key)
            if not av or ref <= 0:
                return 0
            # direct-predicted partitions contribute 0 (9.3.3.1.1.6)
            if self.pic.direct_grid[ny >> 2, nx >> 2]:
                return 0
            return 1

        inc = cond(px - 1, py) + 2 * cond(px, py - 1)
        if not d.decision(54 + inc):
            return 0
        return 1 + d.unary(lambda i: 58 if i == 0 else 59)

    def mvd(self, lst: int, comp: int, px: int, py: int, cur_key: int) -> int:
        d = self.dec
        base = 40 if comp == 0 else 47
        pic = self.pic

        def absmvd(nx, ny) -> int:
            if nx < 0 or ny < 0 or nx >= pic.mb_w * 16 or ny >= pic.mb_h * 16:
                return 0
            bx, by = nx >> 2, ny >> 2
            if not (pic.order_grid[by, bx] < cur_key):
                return 0
            if pic.slice_map[by // 4, bx // 4] != self.cur_slice:
                return 0
            return abs(int(pic.mvd_grid[lst, by, bx, comp]))

        e = absmvd(px - 1, py) + absmvd(px, py - 1)
        inc = 0 if e < 3 else (2 if e > 32 else 1)
        if not d.decision(base + inc):
            return 0
        # UEG3 prefix: TU with cMax 9, bins 1.. ctx base+3..base+6
        k = 1 + d.unary(lambda i: base + 3 + min(i, 3), c_max=8)
        if k == 9:
            k += d.expgolomb_bypass(3)
        return -k if d.bypass() else k

    # -- residual blocks (9.3.3.1.3) ----------------------------------------

    def coded_block_flag(self, cat: int, cond_a: int, cond_b: int) -> int:
        return self.dec.decision(85 + CBF_CAT_OFF[cat] + cond_a + 2 * cond_b)

    def residual_block(self, cat: int, n_coeff: int) -> np.ndarray:
        """Decode significance map + levels; returns scan-order levels."""
        d = self.dec
        levels = np.zeros(n_coeff, np.int32)
        fld = bool(self.hdr.field_pic_flag)
        if cat == 5:
            # field-coded blocks use the 436/451 ctx ranges (Table 9-40)
            sig_base, last_base = (436, 451) if fld else (402, 417)
            abs_base = 426
        else:
            sig_base = (277 if fld else 105) + SIG_CAT_OFF[cat]
            last_base = (338 if fld else 166) + SIG_CAT_OFF[cat]
            abs_base = 227 + ABS_CAT_OFF[cat]
        sig = []
        last = n_coeff - 1
        for i in range(n_coeff - 1):
            if cat == 5:
                s_inc = SIG8x8_FIELD[i] if fld else SIG8x8[i]
                l_inc = LAST8x8[i]
            elif cat == 3:
                s_inc = l_inc = min(i, 2)
            else:
                s_inc = l_inc = i
            if d.decision(sig_base + s_inc):
                sig.append(i)
                if d.decision(last_base + l_inc):
                    last = i
                    break
        if last == n_coeff - 1:
            sig.append(n_coeff - 1)
        # levels, highest-frequency (last) first
        num_eq1 = 0
        num_gt1 = 0
        for pos in reversed(sig):
            inc0 = 0 if num_gt1 else min(4, 1 + num_eq1)
            if not d.decision(abs_base + inc0):
                mag = 1
            else:
                inc1 = 5 + min(4 - (1 if cat == 3 else 0), num_gt1)
                k = 1 + d.unary(lambda i, _c=inc1: abs_base + _c, c_max=13)
                if k == 14:
                    k += d.expgolomb_bypass(0)
                mag = 1 + k
            if mag == 1:
                num_eq1 += 1
            else:
                num_gt1 += 1
            levels[pos] = -mag if d.bypass() else mag
        return levels

    # -- per-block CBF neighbor conditions ----------------------------------

    def _cbf_cond(self, nb, cur_intra: bool, exists_val) -> int:
        """condTermFlagN per 9.3.3.1.1.9."""
        if nb is None:
            return 1 if cur_intra else 0
        if nb.category == MB_IPCM:
            return 1
        if nb.category in (MB_PSKIP, MB_BSKIP):
            return 0
        return int(exists_val)

    def cbf_luma4(self, mb, bx: int, by: int) -> int:
        """CBF ctx inc for the luma 4x4/8x8 block at global coords (bx, by)."""
        pic = self.pic
        cur_intra = mb.is_intra

        def cond(nx, ny) -> int:
            if nx < 0 or ny < 0 or nx >= pic.mb_w * 4 or ny >= pic.mb_h * 4:
                nb = None
            else:
                nb = self._nb_mb(nx // 4, ny // 4)
            val = pic.cbf_luma[ny, nx] if nb is not None else 0
            return self._cbf_cond(nb, cur_intra, val)

        return cond(bx - 1, by) + 2 * cond(bx, by - 1)

    def cbf_luma_dc(self, mb) -> int:
        pic = self.pic

        def cond(mx, my) -> int:
            nb = self._nb_mb(mx, my)
            val = 0
            if nb is not None and nb.category == MB_I16x16:
                val = pic.cbf_luma_dc[my, mx]
            elif nb is not None:
                return self._cbf_cond(nb, True, 0)
            return self._cbf_cond(nb, True, val)

        return cond(mb.mb_x - 1, mb.mb_y) + 2 * cond(mb.mb_x, mb.mb_y - 1)

    def cbf_chroma_dc(self, mb, pl: int) -> int:
        pic = self.pic
        cur_intra = mb.is_intra

        def cond(mx, my) -> int:
            nb = self._nb_mb(mx, my)
            val = pic.cbf_cdc[pl, my, mx] if nb is not None else 0
            return self._cbf_cond(nb, cur_intra, val)

        return cond(mb.mb_x - 1, mb.mb_y) + 2 * cond(mb.mb_x, mb.mb_y - 1)

    def cbf_chroma_ac(self, mb, pl: int, cx: int, cy: int) -> int:
        pic = self.pic
        cur_intra = mb.is_intra

        def cond(nx, ny) -> int:
            if nx < 0 or ny < 0 or nx >= pic.mb_w * 2 or ny >= pic.mb_h * 2:
                nb = None
            else:
                nb = self._nb_mb(nx // 2, ny // 2)
            val = pic.cbf_cac[pl, ny, nx] if nb is not None else 0
            return self._cbf_cond(nb, cur_intra, val)

        return cond(cx - 1, cy) + 2 * cond(cx, cy - 1)

    # -- residual for a whole MB --------------------------------------------

    def parse_residual(self, mb, mb_x: int, mb_y: int) -> None:
        pic = self.pic
        from ..common.tables import BLK4_X, BLK4_Y
        if mb.category == MB_I16x16:
            inc = self.cbf_luma_dc(mb)
            cbf = self.coded_block_flag(0, inc & 1, (inc >> 1) & 1)
            pic.cbf_luma_dc[mb_y, mb_x] = cbf
            mb.luma_dc = np.zeros(16, np.int32)
            if cbf:
                mb.luma_dc = self.residual_block(0, 16)
            mb.luma_levels = np.zeros((16, 16), np.int32)
            for blk in range(16):
                x4, y4 = BLK4_X[blk], BLK4_Y[blk]
                i8 = (y4 // 2) * 2 + (x4 // 2)
                if not (mb.cbp_luma >> i8) & 1:
                    continue
                bx, by = mb_x * 4 + x4, mb_y * 4 + y4
                inc = self.cbf_luma4(mb, bx, by)
                cbf = self.coded_block_flag(1, inc & 1, (inc >> 1) & 1)
                pic.cbf_luma[by, bx] = cbf
                if cbf:
                    mb.luma_levels[blk, 1:] = self.residual_block(1, 15)
                tc = int(np.count_nonzero(mb.luma_levels[blk]))
                pic.tc_luma[by, bx] = tc
                mb.tc_luma[y4, x4] = tc
        elif mb.transform_8x8:
            mb.luma_levels = np.zeros((4, 64), np.int32)
            for i8 in range(4):
                if not (mb.cbp_luma >> i8) & 1:
                    continue
                x8, y8 = i8 % 2, i8 // 2
                # CBF inferred from cbp for 4:2:0 (no cat-5 cbf); cells get it
                mb.luma_levels[i8] = self.residual_block(5, 64)
                bx, by = mb_x * 4 + 2 * x8, mb_y * 4 + 2 * y8
                nz = int(np.count_nonzero(mb.luma_levels[i8]))
                pic.cbf_luma[by:by + 2, bx:bx + 2] = 1
                pic.tc_luma[by:by + 2, bx:bx + 2] = 1 if nz else 0
                mb.tc_luma[2 * y8:2 * y8 + 2, 2 * x8:2 * x8 + 2] = 1 if nz else 0
        else:
            mb.luma_levels = np.zeros((16, 16), np.int32)
            for blk in range(16):
                x4, y4 = BLK4_X[blk], BLK4_Y[blk]
                i8 = (y4 // 2) * 2 + (x4 // 2)
                if not (mb.cbp_luma >> i8) & 1:
                    continue
                bx, by = mb_x * 4 + x4, mb_y * 4 + y4
                inc = self.cbf_luma4(mb, bx, by)
                cbf = self.coded_block_flag(2, inc & 1, (inc >> 1) & 1)
                pic.cbf_luma[by, bx] = cbf
                if cbf:
                    mb.luma_levels[blk] = self.residual_block(2, 16)
                tc = int(np.count_nonzero(mb.luma_levels[blk]))
                pic.tc_luma[by, bx] = tc
                mb.tc_luma[y4, x4] = tc
        # chroma
        if mb.cbp_chroma:
            mb.chroma_dc = np.zeros((2, 4), np.int32)
            mb.chroma_ac = np.zeros((2, 4, 16), np.int32)
            for pl in range(2):
                inc = self.cbf_chroma_dc(mb, pl)
                cbf = self.coded_block_flag(3, inc & 1, (inc >> 1) & 1)
                pic.cbf_cdc[pl, mb_y, mb_x] = cbf
                if cbf:
                    mb.chroma_dc[pl] = self.residual_block(3, 4)
            if mb.cbp_chroma == 2:
                for pl in range(2):
                    tc_map = pic.tc_cb if pl == 0 else pic.tc_cr
                    for blk in range(4):
                        x2, y2 = blk % 2, blk // 2
                        cx, cy = mb_x * 2 + x2, mb_y * 2 + y2
                        inc = self.cbf_chroma_ac(mb, pl, cx, cy)
                        cbf = self.coded_block_flag(4, inc & 1, (inc >> 1) & 1)
                        pic.cbf_cac[pl, cy, cx] = cbf
                        if cbf:
                            mb.chroma_ac[pl, blk, 1:] = \
                                self.residual_block(4, 15)
                        tc_map[cy, cx] = int(
                            np.count_nonzero(mb.chroma_ac[pl, blk]))

    # -- macroblock types ---------------------------------------------------

    def mb_type_i_suffix(self, base: list[int]) -> int:
        """I mb_type after the is-intra prefix bin.  base = ctx list
        [cbp_luma, cbp_c1, cbp_c2, pm1, pm2]."""
        d = self.dec
        if d.terminate():
            return 25  # I_PCM
        t = 1
        if d.decision(base[0]):
            t += 12
        if d.decision(base[1]):
            t += 8 if d.decision(base[2]) else 4
        t += 2 * d.decision(base[3])
        t += d.decision(base[4])
        return t

    def mb_type_i(self, mb_x: int, mb_y: int) -> int:
        d = self.dec
        if not d.decision(3 + self._imbtype_inc(mb_x, mb_y)):
            return 0
        return self.mb_type_i_suffix([6, 7, 8, 9, 10])

    def mb_type_p(self) -> int:
        """Returns P mb_type 0..4 range or 5+i for intra (matching CAVLC)."""
        d = self.dec
        if d.decision(14):
            return 5 + self.mb_type_i_suffix_p()
        if d.decision(15):
            return 1 if d.decision(17) else 2
        return 3 if d.decision(16) else 0

    def mb_type_i_suffix_p(self) -> int:
        d = self.dec
        if not d.decision(17):
            return 0
        return self.mb_type_i_suffix([18, 19, 19, 20, 20])

    def mb_type_b(self, mb_x: int, mb_y: int) -> int:
        """Returns 0..22 or 23+i for intra (matching CAVLC numbering)."""
        d = self.dec
        if not d.decision(27 + self._bmbtype_inc(mb_x, mb_y)):
            return 0
        if not d.decision(30):
            return 1 + d.decision(32)
        bits = d.decision(31) << 3
        bits |= d.decision(32) << 2
        bits |= d.decision(32) << 1
        bits |= d.decision(32)
        if bits < 8:
            return bits + 3
        if bits == 13:
            return 23 + self.mb_type_i_suffix_b()
        if bits == 14:
            return 11
        if bits == 15:
            return 22
        bits = (bits << 1) | d.decision(32)
        return bits - 4

    def mb_type_i_suffix_b(self) -> int:
        d = self.dec
        if not d.decision(32):
            return 0
        return self.mb_type_i_suffix([33, 34, 34, 35, 35])

    def sub_mb_type_p(self) -> int:
        d = self.dec
        if d.decision(21):
            return 0
        if not d.decision(22):
            return 1
        return 2 if d.decision(23) else 3

    def sub_mb_type_b(self) -> int:
        d = self.dec
        if not d.decision(36):
            return 0
        if not d.decision(37):
            return 1 + d.decision(39)
        t = 3
        if d.decision(38):
            if d.decision(39):
                return 11 + d.decision(39)
            t += 4
        t += 2 * d.decision(39)
        t += d.decision(39)
        return t

    # -- macroblock parsing -------------------------------------------------

    def parse_i_mb(self, mb_type: int, mb_x: int, mb_y: int,
                   prev_qp: int) -> int:
        """Parse one I macroblock (CABAC).  Returns new prev_qp."""
        pic = self.pic
        pps = pic.pps
        cs = self.cur_slice
        mb = MBRecord(mb_x=mb_x, mb_y=mb_y, slice_id=cs)
        mb.tc_luma = np.zeros((4, 4), np.int32)
        pic.order_grid[mb_y * 4:mb_y * 4 + 4, mb_x * 4:mb_x * 4 + 4] = -1

        if mb_type == 25:  # I_PCM
            mb.category = MB_IPCM
            self.dec.flush()
            r = self.dec.r
            r.align()
            mb.pcm_samples = np.array([r.u(8) for _ in range(384)], np.uint8)
            self.dec.reinit()
            mb.qp = prev_qp
            mb.tc_luma[:] = 16
            pic.tc_luma[mb_y * 4:mb_y * 4 + 4, mb_x * 4:mb_x * 4 + 4] = 16
            pic.tc_cb[mb_y * 2:mb_y * 2 + 2, mb_x * 2:mb_x * 2 + 2] = 16
            pic.tc_cr[mb_y * 2:mb_y * 2 + 2, mb_x * 2:mb_x * 2 + 2] = 16
            pic.cbf_luma[mb_y * 4:mb_y * 4 + 4, mb_x * 4:mb_x * 4 + 4] = 1
            pic.cbf_luma_dc[mb_y, mb_x] = 1
            pic.cbf_cdc[:, mb_y, mb_x] = 1
            pic.cbf_cac[:, mb_y * 2:mb_y * 2 + 2, mb_x * 2:mb_x * 2 + 2] = 1
            pic.mbs[mb_y * pic.mb_w + mb_x] = mb
            pic.slice_map[mb_y, mb_x] = cs
            self.prev_qp_delta = 0
            return prev_qp

        if mb_type == 0:  # I_NxN
            if pps.transform_8x8_mode_flag:
                mb.transform_8x8 = bool(
                    self.dec.decision(399 + self._tr8_inc(mb_x, mb_y)))
            mb.category = MB_I8x8 if mb.transform_8x8 else MB_I4x4
            pic.mbs[mb_y * pic.mb_w + mb_x] = mb
            pic.slice_map[mb_y, mb_x] = cs
            cur_modes = {}
            if mb.transform_8x8:
                from ..common.tables import BLK8_X, BLK8_Y
                for blk in range(4):
                    bx = mb_x * 4 + BLK8_X[blk] * 2
                    by = mb_y * 4 + BLK8_Y[blk] * 2
                    pred = pic.pred_intra4x4_mode(bx, by, cs, cur_modes)
                    mode = self.intra4x4_mode(pred)
                    mb.i8_modes[blk] = mode
                    for dy in range(2):
                        for dx in range(2):
                            cur_modes[(bx + dx, by + dy)] = mode
                            pic.mode_map[by + dy, bx + dx] = mode
            else:
                from ..common.tables import BLK4_X, BLK4_Y
                for blk in range(16):
                    bx = mb_x * 4 + BLK4_X[blk]
                    by = mb_y * 4 + BLK4_Y[blk]
                    pred = pic.pred_intra4x4_mode(bx, by, cs, cur_modes)
                    mode = self.intra4x4_mode(pred)
                    mb.i4_modes[blk] = mode
                    cur_modes[(bx, by)] = mode
                    pic.mode_map[by, bx] = mode
            mb.chroma_mode = self.intra_chroma_mode(mb_x, mb_y)
            mb.cbp_luma, mb.cbp_chroma = self.cbp(mb_x, mb_y)
        else:  # I_16x16
            mb.category = MB_I16x16
            mb.i16_mode, mb.cbp_chroma, mb.cbp_luma = i16_fields(mb_type - 1)
            pic.mbs[mb_y * pic.mb_w + mb_x] = mb
            pic.slice_map[mb_y, mb_x] = cs
            mb.chroma_mode = self.intra_chroma_mode(mb_x, mb_y)

        if mb.cbp_luma or mb.cbp_chroma or mb.category == MB_I16x16:
            prev_qp = (prev_qp + self.mb_qp_delta() + 52) % 52
        else:
            self.prev_qp_delta = 0
        mb.qp = prev_qp
        self.parse_residual(mb, mb_x, mb_y)
        return prev_qp

    def _write_refs_early(self, lst, px, py, w, h, ref):
        """Write a partition's ref to the grid before its mvd parse (the
        ref_idx ctx of later partitions needs it)."""
        bx0, by0 = px >> 2, py >> 2
        self.pic.ref_grid[lst, by0:by0 + (h >> 2), bx0:bx0 + (w >> 2)] = ref

    def _store_mvd(self, lst, px, py, w, h, mvd):
        bx0, by0 = px >> 2, py >> 2
        self.pic.mvd_grid[lst, by0:by0 + (h >> 2), bx0:bx0 + (w >> 2)] = mvd

    def parse_p_mb(self, mb_type: int, mb_x: int, mb_y: int,
                   prev_qp: int) -> int:
        pic = self.pic
        cs = self.cur_slice
        hdr = self.hdr
        mb = MBRecord(mb_x=mb_x, mb_y=mb_y, slice_id=cs)
        mb.category = MB_P
        mb.tc_luma = np.zeros((4, 4), np.int32)
        mb.mvs = np.zeros((2, 4, 4, 2), np.int32)
        mb.refidx = np.full((2, 4, 4), -1, np.int8)
        pic.mbs[mb_y * pic.mb_w + mb_x] = mb
        pic.slice_map[mb_y, mb_x] = cs
        x0, y0 = mb_x * 16, mb_y * 16
        n_ref = hdr.num_ref_idx_l0_active
        sub_types = None

        if mb_type in (3, 4):
            sub_types = [self.sub_mb_type_p() for _ in range(4)]
            for i8 in range(4):
                sx0, sy0 = x0 + (i8 % 2) * 8, y0 + (i8 // 2) * 8
                ns, sw, sh = P_SUB_SHAPES[sub_types[i8]]
                for s in range(ns):
                    px, py = pic._sub_part_xy(sx0, sy0, sw, sh, s)
                    pic._assign_key(px, py, sw, sh, i8 * 8 + s)
            refs = []
            for i8 in range(4):
                sx0, sy0 = x0 + (i8 % 2) * 8, y0 + (i8 // 2) * 8
                ref = self.ref_idx(0, sx0, sy0, i8 * 8, n_ref)
                refs.append(ref)
                ns, sw, sh = P_SUB_SHAPES[sub_types[i8]]
                for s in range(ns):
                    px, py = pic._sub_part_xy(sx0, sy0, sw, sh, s)
                    self._write_refs_early(0, px, py, sw, sh, ref)
            for i8 in range(4):
                sx0, sy0 = x0 + (i8 % 2) * 8, y0 + (i8 // 2) * 8
                ns, sw, sh = P_SUB_SHAPES[sub_types[i8]]
                for s in range(ns):
                    px, py = pic._sub_part_xy(sx0, sy0, sw, sh, s)
                    key = i8 * 8 + s
                    mvd = (self.mvd(0, 0, px, py, key),
                           self.mvd(0, 1, px, py, key))
                    self._store_mvd(0, px, py, sw, sh, mvd)
                    mvp = pic.predict_mv(0, refs[i8], px, py, sw, sh, cs,
                                         cur_key=key)
                    mv = (mvp[0] + mvd[0], mvp[1] + mvd[1])
                    pic._set_part(mb, 0, px, py, sw, sh, refs[i8], mv)
        else:
            n_parts, pw, ph = P_SHAPES[mb_type]
            coords = []
            for p in range(n_parts):
                if mb_type == 0:
                    px, py, kind = x0, y0, 0
                elif mb_type == 1:
                    px, py, kind = x0, y0 + p * 8, 1 + p
                else:
                    px, py, kind = x0 + p * 8, y0, 3 + p
                coords.append((px, py, kind))
                pic._assign_key(px, py, pw, ph, p * 8)
            refs = []
            for p, (px, py, kind) in enumerate(coords):
                ref = self.ref_idx(0, px, py, p * 8, n_ref)
                refs.append(ref)
                self._write_refs_early(0, px, py, pw, ph, ref)
            for p, (px, py, kind) in enumerate(coords):
                mvd = (self.mvd(0, 0, px, py, p * 8),
                       self.mvd(0, 1, px, py, p * 8))
                self._store_mvd(0, px, py, pw, ph, mvd)
                mvp = pic.predict_mv(0, refs[p], px, py, pw, ph, cs,
                                     part_kind=kind, cur_key=p * 8)
                mv = (mvp[0] + mvd[0], mvp[1] + mvd[1])
                pic._set_part(mb, 0, px, py, pw, ph, refs[p], mv)
        pic._finish_mb_keys(mb_x, mb_y)

        mb.cbp_luma, mb.cbp_chroma = self.cbp(mb_x, mb_y)
        if mb.cbp_luma and pic.pps.transform_8x8_mode_flag:
            no_small = mb_type not in (3, 4) or all(st == 0 for st in sub_types)
            if no_small:
                mb.transform_8x8 = bool(
                    self.dec.decision(399 + self._tr8_inc(mb_x, mb_y)))
        if mb.cbp_luma or mb.cbp_chroma:
            prev_qp = (prev_qp + self.mb_qp_delta() + 52) % 52
        else:
            self.prev_qp_delta = 0
        mb.qp = prev_qp
        self.parse_residual(mb, mb_x, mb_y)
        return prev_qp

    def parse_b_mb(self, mb_type: int, mb_x: int, mb_y: int,
                   prev_qp: int) -> int:
        pic = self.pic
        cs = self.cur_slice
        hdr = self.hdr
        mb = MBRecord(mb_x=mb_x, mb_y=mb_y, slice_id=cs)
        mb.category = MB_BDIRECT16 if mb_type == 0 else MB_B
        mb.tc_luma = np.zeros((4, 4), np.int32)
        mb.mvs = np.zeros((2, 4, 4, 2), np.int32)
        mb.refidx = np.full((2, 4, 4), -1, np.int8)
        pic.mbs[mb_y * pic.mb_w + mb_x] = mb
        pic.slice_map[mb_y, mb_x] = cs
        x0, y0 = mb_x * 16, mb_y * 16
        n_ref = (hdr.num_ref_idx_l0_active, hdr.num_ref_idx_l1_active)
        sub_types = None

        if mb_type == 0:
            pic.fill_direct(mb, mb_x, mb_y, cs, hdr, self.l0, self.l1,
                            self.cur_poc)
            pic._finish_mb_keys(mb_x, mb_y)
        elif mb_type == 22:
            sub_types = [self.sub_mb_type_b() for _ in range(4)]
            for i8 in range(4):
                st = sub_types[i8]
                _, ns, sw, sh, pred = B_SUB_MODES[st]
                sx0, sy0 = x0 + (i8 % 2) * 8, y0 + (i8 // 2) * 8
                if pred == 3:
                    pic._assign_key(sx0, sy0, 8, 8, i8 * 8)
                else:
                    for s in range(ns):
                        px, py = pic._sub_part_xy(sx0, sy0, sw, sh, s)
                        pic._assign_key(px, py, sw, sh, i8 * 8 + s)
            for i8 in range(4):
                if B_SUB_MODES[sub_types[i8]][4] == 3:
                    cells = [(2 * (i8 // 2) + dy, 2 * (i8 % 2) + dx)
                             for dy in range(2) for dx in range(2)]
                    pic.fill_direct(mb, mb_x, mb_y, cs, hdr, self.l0, self.l1,
                                    self.cur_poc, blocks=cells)
            refs = [[0] * 4, [0] * 4]
            for lst in range(2):
                for i8 in range(4):
                    st = sub_types[i8]
                    _, ns, sw, sh, pred = B_SUB_MODES[st]
                    if pred == 3 or (pred != 2 and pred != lst):
                        continue
                    sx0, sy0 = x0 + (i8 % 2) * 8, y0 + (i8 // 2) * 8
                    ref = self.ref_idx(lst, sx0, sy0, i8 * 8, n_ref[lst])
                    refs[lst][i8] = ref
                    for s in range(ns):
                        px, py = pic._sub_part_xy(sx0, sy0, sw, sh, s)
                        self._write_refs_early(lst, px, py, sw, sh, ref)
            for lst in range(2):
                for i8 in range(4):
                    st = sub_types[i8]
                    _, ns, sw, sh, pred = B_SUB_MODES[st]
                    if pred == 3 or (pred != 2 and pred != lst):
                        continue
                    sx0, sy0 = x0 + (i8 % 2) * 8, y0 + (i8 // 2) * 8
                    for s in range(ns):
                        px, py = pic._sub_part_xy(sx0, sy0, sw, sh, s)
                        key = i8 * 8 + s
                        mvd = (self.mvd(lst, 0, px, py, key),
                               self.mvd(lst, 1, px, py, key))
                        self._store_mvd(lst, px, py, sw, sh, mvd)
                        mvp = pic.predict_mv(lst, refs[lst][i8], px, py,
                                             sw, sh, cs, cur_key=key)
                        mv = (mvp[0] + mvd[0], mvp[1] + mvd[1])
                        pic._set_part(mb, lst, px, py, sw, sh,
                                      refs[lst][i8], mv)
            pic._finish_mb_keys(mb_x, mb_y)
        else:
            _, (n_parts, pw, ph), preds = B_MODES[mb_type]
            coords = []
            for p in range(n_parts):
                if n_parts == 1:
                    px, py, kind = x0, y0, 0
                elif ph == 8:
                    px, py, kind = x0, y0 + p * 8, 1 + p
                else:
                    px, py, kind = x0 + p * 8, y0, 3 + p
                coords.append((px, py, kind))
                pic._assign_key(px, py, pw, ph, p * 8)
            refs = [[0] * n_parts, [0] * n_parts]
            for lst in range(2):
                for p, (px, py, kind) in enumerate(coords):
                    if not (preds[p] == 2 or preds[p] == lst):
                        continue
                    ref = self.ref_idx(lst, px, py, p * 8, n_ref[lst])
                    refs[lst][p] = ref
                    self._write_refs_early(lst, px, py, pw, ph, ref)
            for lst in range(2):
                for p, (px, py, kind) in enumerate(coords):
                    if not (preds[p] == 2 or preds[p] == lst):
                        continue
                    mvd = (self.mvd(lst, 0, px, py, p * 8),
                           self.mvd(lst, 1, px, py, p * 8))
                    self._store_mvd(lst, px, py, pw, ph, mvd)
                    mvp = pic.predict_mv(lst, refs[lst][p], px, py, pw, ph,
                                         cs, part_kind=kind, cur_key=p * 8)
                    mv = (mvp[0] + mvd[0], mvp[1] + mvd[1])
                    pic._set_part(mb, lst, px, py, pw, ph, refs[lst][p], mv)
            pic._finish_mb_keys(mb_x, mb_y)

        mb.cbp_luma, mb.cbp_chroma = self.cbp(mb_x, mb_y)
        if mb.cbp_luma and pic.pps.transform_8x8_mode_flag:
            if mb_type == 0:
                ok = bool(pic.sps.direct_8x8_inference_flag)
            elif sub_types is not None:
                ok = all((B_SUB_MODES[st][4] == 3 and
                          pic.sps.direct_8x8_inference_flag)
                         or (B_SUB_MODES[st][2] == 8 and B_SUB_MODES[st][3] == 8)
                         for st in sub_types)
            else:
                ok = True
            if ok:
                mb.transform_8x8 = bool(
                    self.dec.decision(399 + self._tr8_inc(mb_x, mb_y)))
        if mb.cbp_luma or mb.cbp_chroma:
            prev_qp = (prev_qp + self.mb_qp_delta() + 52) % 52
        else:
            self.prev_qp_delta = 0
        mb.qp = prev_qp
        self.parse_residual(mb, mb_x, mb_y)
        return prev_qp

    def parse_skip(self, mb_x: int, mb_y: int, prev_qp: int):
        pic = self.pic
        self.prev_qp_delta = 0
        if self.hdr.is_p:
            pic.parse_p_skip(mb_x, mb_y, self.cur_slice, prev_qp)
        else:
            pic.parse_b_skip(mb_x, mb_y, self.cur_slice, prev_qp,
                             self.hdr, self.l0, self.l1, self.cur_poc)

    # -- slice loop ---------------------------------------------------------

    def parse(self) -> None:
        pic = self.pic
        hdr = self.hdr
        prev_qp = self.qp
        addr = hdr.first_mb_in_slice
        n = pic.mb_w * pic.mb_h
        nxt = pic.mb_iter(hdr)
        while True:
            if addr >= n:
                raise ValueError("CABAC slice overruns picture")
            mb_x, mb_y = addr % pic.mb_w, addr // pic.mb_w
            if hdr.is_p or hdr.is_b:
                ctx_base = 11 if hdr.is_p else 24
                skip = self.dec.decision(ctx_base + self._skip_inc(mb_x, mb_y))
                if skip:
                    self.parse_skip(mb_x, mb_y, prev_qp)
                else:
                    if hdr.is_p:
                        t = self.mb_type_p()
                        if t >= 5:
                            prev_qp = self.parse_i_mb(t - 5, mb_x, mb_y, prev_qp)
                        else:
                            prev_qp = self.parse_p_mb(t, mb_x, mb_y, prev_qp)
                    else:
                        t = self.mb_type_b(mb_x, mb_y)
                        if t >= 23:
                            prev_qp = self.parse_i_mb(t - 23, mb_x, mb_y, prev_qp)
                        else:
                            prev_qp = self.parse_b_mb(t, mb_x, mb_y, prev_qp)
            else:
                t = self.mb_type_i(mb_x, mb_y)
                prev_qp = self.parse_i_mb(t, mb_x, mb_y, prev_qp)
            addr = nxt(addr)
            if self.dec.terminate():
                break


def parse_slice_cabac(pic, r: BitReader, hdr: SliceHeader, reflists,
                      cur_poc: int) -> None:
    CabacSliceParser(pic, r, hdr, reflists, cur_poc).parse()
