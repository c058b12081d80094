"""CAVLC slice-data / macroblock-layer parser (spec 7.3.4, 7.3.5, 9.2).

Reference parity: JM-lineage `mb_read.c` / `read_comp_cavlc.c` (SURVEY.md §2;
implemented from the spec clauses).

This is the host entropy layer: it turns slice RBSPs into per-MB records
(the "MB tensor" source).  It never looks at pixels, so parsing is fully
decoupled from reconstruction — the property the TPU pipeline relies on.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.bits import BitReader
from ..bitstream.params import PPS, SPS
from ..bitstream.slicehdr import SliceHeader
from ..entropy.cavlc import decode_residual_block
from .types import (
    CBP_ME, MB_I4x4, MB_I8x8, MB_I16x16, MB_IPCM, MBRecord, i16_fields,
)


class PictureParse:
    """Parse state for one coded picture (all its slices)."""

    def __init__(self, sps: SPS, pps: PPS):
        self.sps = sps
        self.pps = pps
        self.mb_w = sps.pic_width_in_mbs
        self.mb_h = sps.pic_height_in_map_units
        n = self.mb_w * self.mb_h
        self.mbs: list[MBRecord | None] = [None] * n
        # per-4x4-block AC total_coeff maps (for nC derivation, spec 9.2.1)
        self.tc_luma = np.zeros((self.mb_h * 4, self.mb_w * 4), np.int32)
        self.tc_cb = np.zeros((self.mb_h * 2, self.mb_w * 2), np.int32)
        self.tc_cr = np.zeros((self.mb_h * 2, self.mb_w * 2), np.int32)
        # per-4x4-block intra pred mode map (spec 8.3.1.1); -1 = n/a
        self.mode_map = np.full((self.mb_h * 4, self.mb_w * 4), -1, np.int32)
        self.slice_map = np.full((self.mb_h, self.mb_w), -1, np.int32)
        self.headers: list[SliceHeader] = []
        # motion grids at 4x4 granularity (spec 8.4.1); list-major
        self.mv_grid = np.zeros((2, self.mb_h * 4, self.mb_w * 4, 2), np.int32)
        self.ref_grid = np.full((2, self.mb_h * 4, self.mb_w * 4), -1, np.int8)
        # partition decode-order keys (spec 6.4.11.7 availability): cells of
        # finished MBs = -1; current MB's partitions = mbPartIdx*8 +
        # subMbPartIdx; undecoded = BIG.  A neighbor cell is available for
        # the partition with key k iff order[cell] < k.
        self.ORDER_UNDECODED = 1 << 30
        self.order_grid = np.full((self.mb_h * 4, self.mb_w * 4),
                                  self.ORDER_UNDECODED, np.int32)
        # cells whose motion came from a DIRECT derivation (B skip/direct):
        # excluded from the CABAC ref_idx context (spec 9.3.3.1.1.6)
        self.direct_grid = np.zeros((self.mb_h * 4, self.mb_w * 4), bool)
        # per-slice reference lists (DPBPicture lists), set by the decode loop
        self.slice_reflists: list[tuple] = []

    # -- neighbor helpers ---------------------------------------------------

    def _mb_at(self, mb_x: int, mb_y: int) -> MBRecord | None:
        if mb_x < 0 or mb_y < 0 or mb_x >= self.mb_w or mb_y >= self.mb_h:
            return None
        return self.mbs[mb_y * self.mb_w + mb_x]

    def _mb_available(self, mb_x: int, mb_y: int, cur_slice: int) -> bool:
        if mb_x < 0 or mb_y < 0 or mb_x >= self.mb_w or mb_y >= self.mb_h:
            return False
        return self.slice_map[mb_y, mb_x] == cur_slice

    def _nc_from(self, tc_map: np.ndarray, bx: int, by: int, cur_slice: int,
                 blk_per_mb: int) -> int | None:
        """total_coeff of the block at block coords (bx, by), None if n/a."""
        if bx < 0 or by < 0:
            return None
        mb_x, mb_y = bx // blk_per_mb, by // blk_per_mb
        if not self._mb_available(mb_x, mb_y, cur_slice):
            return None
        mb = self._mb_at(mb_x, mb_y)
        if mb is not None and mb.category == MB_IPCM:
            return 16
        return int(tc_map[by, bx])

    def luma_nc(self, bx: int, by: int, cur_slice: int) -> int:
        na = self._nc_from(self.tc_luma, bx - 1, by, cur_slice, 4)
        nb = self._nc_from(self.tc_luma, bx, by - 1, cur_slice, 4)
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    def chroma_nc(self, plane: int, bx: int, by: int, cur_slice: int) -> int:
        tc_map = self.tc_cb if plane == 0 else self.tc_cr
        na = self._nc_from(tc_map, bx - 1, by, cur_slice, 2)
        nb = self._nc_from(tc_map, bx, by - 1, cur_slice, 2)
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    def pred_intra4x4_mode(self, bx: int, by: int, cur_slice: int,
                           cur_modes_in_mb: dict[tuple[int, int], int]) -> int:
        """predIntra4x4PredMode (spec 8.3.1.1); also used for 8x8 (8.3.2.1)."""

        def neighbor_mode(nbx: int, nby: int) -> int | None:
            if nbx < 0 or nby < 0:
                return None
            if (nbx, nby) in cur_modes_in_mb:
                return cur_modes_in_mb[(nbx, nby)]
            mb_x, mb_y = nbx // 4, nby // 4
            if not self._mb_available(mb_x, mb_y, cur_slice):
                return None
            mb = self._mb_at(mb_x, mb_y)
            if mb is None:
                return None
            if not mb.is_intra_nxn:
                if self.pps.constrained_intra_pred_flag and not mb.is_intra:
                    return None   # triggers dcPredModePredictedFlag
                return 2          # non-I_NxN neighbor contributes DC
            return int(self.mode_map[nby, nbx])

        ma = neighbor_mode(bx - 1, by)
        mb_ = neighbor_mode(bx, by - 1)
        if ma is None or mb_ is None:
            return 2
        return min(ma, mb_)

    # -- residual parse -----------------------------------------------------

    def _parse_residual_luma_4x4(self, r: BitReader, mb: MBRecord,
                                 mb_x: int, mb_y: int, cur_slice: int,
                                 ac_only: bool) -> np.ndarray:
        """16 4x4 luma blocks (levels in scan order).  Returns [16,16] int32."""
        from ..common.tables import BLK4_X, BLK4_Y
        out = np.zeros((16, 16), np.int32)
        for blk in range(16):
            x4, y4 = BLK4_X[blk], BLK4_Y[blk]
            i8 = (y4 // 2) * 2 + (x4 // 2)
            if not (mb.cbp_luma >> i8) & 1:
                continue
            bx, by = mb_x * 4 + x4, mb_y * 4 + y4
            nc = self.luma_nc(bx, by, cur_slice)
            if ac_only:
                levels = decode_residual_block(r, nc, 15)
                out[blk, 1:] = levels
                tc = int(np.count_nonzero(out[blk]))
            else:
                levels = decode_residual_block(r, nc, 16)
                out[blk] = levels
                tc = int(np.count_nonzero(levels))
            self.tc_luma[by, bx] = tc
            mb.tc_luma[y4, x4] = tc
        return out

    def _parse_residual_luma_8x8(self, r: BitReader, mb: MBRecord,
                                 mb_x: int, mb_y: int, cur_slice: int) -> np.ndarray:
        """CAVLC 8x8: four interleaved 4x4 reads per 8x8 (spec 7.4.5.3.3).

        Returns [4, 64] scan-order levels per 8x8 block.
        """
        out = np.zeros((4, 64), np.int32)
        for i8 in range(4):
            if not (mb.cbp_luma >> i8) & 1:
                continue
            x8, y8 = i8 % 2, i8 // 2
            for sub in range(4):
                x4 = x8 * 2 + sub % 2
                y4 = y8 * 2 + sub // 2
                bx, by = mb_x * 4 + x4, mb_y * 4 + y4
                nc = self.luma_nc(bx, by, cur_slice)
                levels = decode_residual_block(r, nc, 16)
                out[i8, sub::4] = levels
                tc = int(np.count_nonzero(levels))
                self.tc_luma[by, bx] = tc
                mb.tc_luma[y4, x4] = tc
        return out

    def _parse_residual_chroma(self, r: BitReader, mb: MBRecord,
                               mb_x: int, mb_y: int, cur_slice: int) -> None:
        if mb.cbp_chroma == 0:
            return
        mb.chroma_dc = np.zeros((2, 4), np.int32)
        for pl in range(2):
            mb.chroma_dc[pl] = decode_residual_block(r, -1, 4)
        mb.chroma_ac = np.zeros((2, 4, 16), np.int32)
        if mb.cbp_chroma == 2:
            for pl in range(2):
                tc_map = self.tc_cb if pl == 0 else self.tc_cr
                for blk in range(4):
                    x2, y2 = blk % 2, blk // 2
                    bx, by = mb_x * 2 + x2, mb_y * 2 + y2
                    nc = self.chroma_nc(pl, bx, by, cur_slice)
                    levels = decode_residual_block(r, nc, 15)
                    mb.chroma_ac[pl, blk, 1:] = levels
                    tc_map[by, bx] = int(np.count_nonzero(levels))

    # -- macroblock layer ---------------------------------------------------

    def parse_i_mb(self, r: BitReader, mb_type: int, mb_x: int, mb_y: int,
                   cur_slice: int, prev_qp: int) -> tuple[MBRecord, int]:
        """Parse one I-macroblock (CAVLC).  Returns (record, new_prev_qp)."""
        sps, pps = self.sps, self.pps
        mb = MBRecord(mb_x=mb_x, mb_y=mb_y, slice_id=cur_slice)
        mb.tc_luma = np.zeros((4, 4), np.int32)
        # intra MB: motion grid cells become "intra" markers (ref -1)
        self.order_grid[mb_y * 4:mb_y * 4 + 4, mb_x * 4:mb_x * 4 + 4] = -1

        if mb_type == 25:  # I_PCM
            mb.category = MB_IPCM
            r.align()
            n = 256 + 128  # 4:2:0, 8-bit
            mb.pcm_samples = np.array([r.u(8) for _ in range(n)], np.uint8)
            mb.qp = prev_qp  # QPY unchanged for the chain (deblock uses 0)
            mb.tc_luma[:] = 16
            self.tc_luma[mb_y * 4:mb_y * 4 + 4, mb_x * 4:mb_x * 4 + 4] = 16
            self.tc_cb[mb_y * 2:mb_y * 2 + 2, mb_x * 2:mb_x * 2 + 2] = 16
            self.tc_cr[mb_y * 2:mb_y * 2 + 2, mb_x * 2:mb_x * 2 + 2] = 16
            self.mbs[mb_y * self.mb_w + mb_x] = mb
            self.slice_map[mb_y, mb_x] = cur_slice
            return mb, prev_qp

        if mb_type == 0:  # I_NxN
            if pps.transform_8x8_mode_flag:
                mb.transform_8x8 = bool(r.u1())
            mb.category = MB_I8x8 if mb.transform_8x8 else MB_I4x4
            # register MB before mode parse so availability checks see it
            self.mbs[mb_y * self.mb_w + mb_x] = mb
            self.slice_map[mb_y, mb_x] = cur_slice
            cur_modes: dict[tuple[int, int], int] = {}
            if mb.transform_8x8:
                from ..common.tables import BLK8_X, BLK8_Y
                for blk in range(4):
                    bx = mb_x * 4 + BLK8_X[blk] * 2
                    by = mb_y * 4 + BLK8_Y[blk] * 2
                    pred = self.pred_intra4x4_mode(bx, by, cur_slice, cur_modes)
                    if r.u1():
                        mode = pred
                    else:
                        rem = r.u(3)
                        mode = rem if rem < pred else rem + 1
                    mb.i8_modes[blk] = mode
                    for dy in range(2):
                        for dx in range(2):
                            cur_modes[(bx + dx, by + dy)] = mode
                            self.mode_map[by + dy, bx + dx] = mode
            else:
                from ..common.tables import BLK4_X, BLK4_Y
                for blk in range(16):
                    bx = mb_x * 4 + BLK4_X[blk]
                    by = mb_y * 4 + BLK4_Y[blk]
                    pred = self.pred_intra4x4_mode(bx, by, cur_slice, cur_modes)
                    if r.u1():
                        mode = pred
                    else:
                        rem = r.u(3)
                        mode = rem if rem < pred else rem + 1
                    mb.i4_modes[blk] = mode
                    cur_modes[(bx, by)] = mode
                    self.mode_map[by, bx] = mode
            mb.chroma_mode = r.ue()
            # coded_block_pattern me(v), Table 9-4 intra column
            code = r.ue()
            if code >= len(CBP_ME):
                raise ValueError(f"bad cbp code {code}")
            cbp = CBP_ME[code][0]
            mb.cbp_luma = cbp & 15
            mb.cbp_chroma = cbp >> 4
        else:  # I_16x16
            mb.category = MB_I16x16
            mb.i16_mode, mb.cbp_chroma, mb.cbp_luma = i16_fields(mb_type - 1)
            self.mbs[mb_y * self.mb_w + mb_x] = mb
            self.slice_map[mb_y, mb_x] = cur_slice
            mb.chroma_mode = r.ue()

        if mb.cbp_luma or mb.cbp_chroma or mb.category == MB_I16x16:
            delta = r.se()
            if delta < -26 or delta > 25:
                raise ValueError(f"mb_qp_delta out of range: {delta}")
            prev_qp = (prev_qp + delta + 52) % 52
        mb.qp = prev_qp

        # residuals
        if mb.category == MB_I16x16:
            bx, by = mb_x * 4, mb_y * 4
            nc = self.luma_nc(bx, by, cur_slice)
            mb.luma_dc = np.array(decode_residual_block(r, nc, 16), np.int32)
            mb.luma_levels = self._parse_residual_luma_4x4(
                r, mb, mb_x, mb_y, cur_slice, ac_only=True)
        elif mb.transform_8x8:
            mb.luma_levels = self._parse_residual_luma_8x8(r, mb, mb_x, mb_y, cur_slice)
        else:
            mb.luma_levels = self._parse_residual_luma_4x4(
                r, mb, mb_x, mb_y, cur_slice, ac_only=False)
        self._parse_residual_chroma(r, mb, mb_x, mb_y, cur_slice)
        return mb, prev_qp

    # -- motion vector prediction (spec 8.4.1.3) ----------------------------

    def _mv_neighbor(self, lst: int, px: int, py: int, cur_slice: int,
                     cur_key: int = 0):
        """Returns (available, ref, mv) for the 4x4 block covering (px, py).

        Availability follows partition decode order (spec 6.4.11.7): a cell
        in the CURRENT MB is available iff its partition key < cur_key.
        """
        if px < 0 or py < 0 or px >= self.mb_w * 16 or py >= self.mb_h * 16:
            return False, -1, (0, 0)
        bx, by = px >> 2, py >> 2
        if not (self.order_grid[by, bx] < cur_key):
            return False, -1, (0, 0)
        if self.slice_map[by // 4, bx // 4] != cur_slice:
            return False, -1, (0, 0)
        ref = int(self.ref_grid[lst, by, bx])
        mv = (int(self.mv_grid[lst, by, bx, 0]), int(self.mv_grid[lst, by, bx, 1]))
        if ref < 0:
            return True, -1, (0, 0)   # intra or list-unused neighbor
        return True, ref, mv

    def predict_mv(self, lst: int, ref_idx: int, x0: int, y0: int,
                   w: int, h: int, cur_slice: int, part_kind: int = 0,
                   cur_key: int = 0):
        """Luma MV predictor (spec 8.4.1.3).  x0/y0/w/h in pixels, absolute.

        part_kind: 0 = general, 1 = 16x8 upper, 2 = 16x8 lower,
                   3 = 8x16 left, 4 = 8x16 right.
        """
        av_a, ref_a, mv_a = self._mv_neighbor(lst, x0 - 1, y0, cur_slice, cur_key)
        av_b, ref_b, mv_b = self._mv_neighbor(lst, x0, y0 - 1, cur_slice, cur_key)
        av_c, ref_c, mv_c = self._mv_neighbor(lst, x0 + w, y0 - 1, cur_slice, cur_key)
        if not av_c:
            av_c, ref_c, mv_c = self._mv_neighbor(lst, x0 - 1, y0 - 1,
                                                  cur_slice, cur_key)
        if part_kind == 1 and ref_b == ref_idx:
            return mv_b
        if part_kind == 2 and ref_a == ref_idx:
            return mv_a
        if part_kind == 3 and ref_a == ref_idx:
            return mv_a
        if part_kind == 4 and ref_c == ref_idx:
            return mv_c
        if not av_b and not av_c and av_a:
            return mv_a
        matches = [(ref_a == ref_idx, mv_a), (ref_b == ref_idx, mv_b),
                   (ref_c == ref_idx, mv_c)]
        hits = [mv for m, mv in matches if m]
        if len(hits) == 1:
            return hits[0]
        med = tuple(sorted((mv_a[i], mv_b[i], mv_c[i]))[1] for i in range(2))
        return med

    def skip_mv(self, x0: int, y0: int, cur_slice: int):
        """P_Skip motion vector (spec 8.4.1.1)."""
        av_a, ref_a, mv_a = self._mv_neighbor(0, x0 - 1, y0, cur_slice)
        av_b, ref_b, mv_b = self._mv_neighbor(0, x0, y0 - 1, cur_slice)
        if (not av_a) or (not av_b) or \
                (ref_a == 0 and mv_a == (0, 0)) or \
                (ref_b == 0 and mv_b == (0, 0)):
            return (0, 0)
        return self.predict_mv(0, 0, x0, y0, 16, 16, cur_slice)

    def _assign_key(self, x0: int, y0: int, w: int, h: int, key: int) -> None:
        bx0, by0 = x0 >> 2, y0 >> 2
        self.order_grid[by0:by0 + (h >> 2), bx0:bx0 + (w >> 2)] = key

    def _finish_mb_keys(self, mb_x: int, mb_y: int) -> None:
        self.order_grid[mb_y * 4:mb_y * 4 + 4, mb_x * 4:mb_x * 4 + 4] = -1

    @staticmethod
    def _sub_part_xy(sx0: int, sy0: int, sw: int, sh: int, s: int):
        if sw == 8 and sh == 8:
            return sx0, sy0
        if sw == 8:
            return sx0, sy0 + s * 4
        if sh == 8:
            return sx0 + s * 4, sy0
        return sx0 + (s % 2) * 4, sy0 + (s // 2) * 4

    def _set_part(self, mb: MBRecord, lst: int, x0: int, y0: int,
                  w: int, h: int, ref: int, mv) -> None:
        """Write a partition's motion into the grids and the MB record."""
        bx0, by0 = x0 >> 2, y0 >> 2
        self.mv_grid[lst, by0:by0 + (h >> 2), bx0:bx0 + (w >> 2)] = mv
        self.ref_grid[lst, by0:by0 + (h >> 2), bx0:bx0 + (w >> 2)] = ref
        ly0, lx0 = by0 - mb.mb_y * 4, bx0 - mb.mb_x * 4
        mb.mvs[lst, ly0:ly0 + (h >> 2), lx0:lx0 + (w >> 2)] = mv
        mb.refidx[lst, ly0:ly0 + (h >> 2), lx0:lx0 + (w >> 2)] = ref

    # -- inter macroblocks (P), spec 7.3.5.1 / 7.4.5.1 ----------------------

    def parse_p_skip(self, mb_x: int, mb_y: int, cur_slice: int,
                     prev_qp: int) -> MBRecord:
        from .types import MB_PSKIP
        mb = MBRecord(mb_x=mb_x, mb_y=mb_y, slice_id=cur_slice)
        mb.category = MB_PSKIP
        mb.tc_luma = np.zeros((4, 4), np.int32)
        mb.mvs = np.zeros((2, 4, 4, 2), np.int32)
        mb.refidx = np.full((2, 4, 4), -1, np.int8)
        mb.qp = prev_qp
        self.mbs[mb_y * self.mb_w + mb_x] = mb
        self.slice_map[mb_y, mb_x] = cur_slice
        mv = self.skip_mv(mb_x * 16, mb_y * 16, cur_slice)
        self._set_part(mb, 0, mb_x * 16, mb_y * 16, 16, 16, 0, mv)
        self._finish_mb_keys(mb_x, mb_y)
        return mb

    def parse_p_mb(self, r: BitReader, mb_type: int, mb_x: int, mb_y: int,
                   cur_slice: int, prev_qp: int, hdr: SliceHeader):
        """Parse one P macroblock (CAVLC, mb_type 0..4)."""
        from .types import MB_P, P_SHAPES, P_SUB_SHAPES
        pps = self.pps
        mb = MBRecord(mb_x=mb_x, mb_y=mb_y, slice_id=cur_slice)
        mb.category = MB_P
        mb.tc_luma = np.zeros((4, 4), np.int32)
        mb.mvs = np.zeros((2, 4, 4, 2), np.int32)
        mb.refidx = np.full((2, 4, 4), -1, np.int8)
        self.mbs[mb_y * self.mb_w + mb_x] = mb
        self.slice_map[mb_y, mb_x] = cur_slice
        x0, y0 = mb_x * 16, mb_y * 16
        n_ref = hdr.num_ref_idx_l0_active
        n_parts, pw, ph = P_SHAPES[mb_type]

        if mb_type == 3 or mb_type == 4:
            sub_types = [r.ue() for _ in range(4)]
            for st in sub_types:
                if st > 3:
                    raise ValueError(f"bad P sub_mb_type {st}")
            for i8 in range(4):
                sx0, sy0 = x0 + (i8 % 2) * 8, y0 + (i8 // 2) * 8
                ns, sw, sh = P_SUB_SHAPES[sub_types[i8]]
                for s in range(ns):
                    px, py = self._sub_part_xy(sx0, sy0, sw, sh, s)
                    self._assign_key(px, py, sw, sh, i8 * 8 + s)
            refs = []
            for i8 in range(4):
                if mb_type == 4 or n_ref == 1:
                    refs.append(0)
                else:
                    refs.append(r.te(n_ref - 1))
            # all mvds after all refs, in sub-partition order
            for i8 in range(4):
                sx0, sy0 = x0 + (i8 % 2) * 8, y0 + (i8 // 2) * 8
                ns, sw, sh = P_SUB_SHAPES[sub_types[i8]]
                for s in range(ns):
                    px, py = self._sub_part_xy(sx0, sy0, sw, sh, s)
                    mvd = (r.se(), r.se())
                    mvp = self.predict_mv(0, refs[i8], px, py, sw, sh,
                                          cur_slice, cur_key=i8 * 8 + s)
                    mv = (mvp[0] + mvd[0], mvp[1] + mvd[1])
                    self._set_part(mb, 0, px, py, sw, sh, refs[i8], mv)
        else:
            refs = []
            for p in range(n_parts):
                refs.append(r.te(n_ref - 1) if n_ref > 1 else 0)
            for p in range(n_parts):
                if mb_type == 0:
                    px, py = x0, y0
                elif mb_type == 1:
                    px, py = x0, y0 + p * 8
                else:
                    px, py = x0 + p * 8, y0
                self._assign_key(px, py, pw, ph, p * 8)
            for p in range(n_parts):
                if mb_type == 0:
                    px, py, kind = x0, y0, 0
                elif mb_type == 1:     # 16x8
                    px, py, kind = x0, y0 + p * 8, 1 + p
                else:                  # 8x16
                    px, py, kind = x0 + p * 8, y0, 3 + p
                mvd = (r.se(), r.se())
                mvp = self.predict_mv(0, refs[p], px, py, pw, ph, cur_slice,
                                      part_kind=kind, cur_key=p * 8)
                mv = (mvp[0] + mvd[0], mvp[1] + mvd[1])
                self._set_part(mb, 0, px, py, pw, ph, refs[p], mv)
        self._finish_mb_keys(mb_x, mb_y)

        # coded_block_pattern (Table 9-4, inter column)
        code = r.ue()
        if code >= len(CBP_ME):
            raise ValueError(f"bad cbp code {code}")
        cbp = CBP_ME[code][1]
        mb.cbp_luma = cbp & 15
        mb.cbp_chroma = cbp >> 4
        if mb.cbp_luma and pps.transform_8x8_mode_flag:
            no_small = mb_type not in (3, 4) or all(
                st == 0 for st in sub_types)
            if no_small:
                mb.transform_8x8 = bool(r.u1())
        if mb.cbp_luma or mb.cbp_chroma:
            delta = r.se()
            if delta < -26 or delta > 25:
                raise ValueError(f"mb_qp_delta out of range: {delta}")
            prev_qp = (prev_qp + delta + 52) % 52
        mb.qp = prev_qp
        if mb.transform_8x8:
            mb.luma_levels = self._parse_residual_luma_8x8(r, mb, mb_x, mb_y,
                                                           cur_slice)
        else:
            mb.luma_levels = self._parse_residual_luma_4x4(
                r, mb, mb_x, mb_y, cur_slice, ac_only=False)
        self._parse_residual_chroma(r, mb, mb_x, mb_y, cur_slice)
        return mb, prev_qp

    # -- B direct modes (spec 8.4.1.2) --------------------------------------

    @staticmethod
    def _min_positive(a: int, b: int) -> int:
        if a >= 0 and b >= 0:
            return min(a, b)
        return max(a, b)

    def _direct_spatial_ctx(self, mb_x: int, mb_y: int, cur_slice: int):
        """Per-MB spatial-direct refs + mvps (spec 8.4.1.2.2)."""
        x0, y0 = mb_x * 16, mb_y * 16
        refs = []
        for lst in range(2):
            av_a, ref_a, _ = self._mv_neighbor(lst, x0 - 1, y0, cur_slice)
            av_b, ref_b, _ = self._mv_neighbor(lst, x0, y0 - 1, cur_slice)
            av_c, ref_c, _ = self._mv_neighbor(lst, x0 + 16, y0 - 1, cur_slice)
            if not av_c:
                av_c, ref_c, _ = self._mv_neighbor(lst, x0 - 1, y0 - 1, cur_slice)
            refs.append(self._min_positive(self._min_positive(ref_a, ref_b), ref_c))
        ref0, ref1 = refs
        zero_pred = ref0 < 0 and ref1 < 0
        if zero_pred:
            ref0 = ref1 = 0
        mvp0 = self.predict_mv(0, ref0, x0, y0, 16, 16, cur_slice) if ref0 >= 0 else (0, 0)
        mvp1 = self.predict_mv(1, ref1, x0, y0, 16, 16, cur_slice) if ref1 >= 0 else (0, 0)
        return ref0, ref1, mvp0, mvp1, zero_pred

    def _col_block(self, l1, mb_x: int, mb_y: int, y4: int, x4: int):
        """Colocated 4x4 info (mv, raw refidx, ref uid, colpic) per 8.4.1.2.1.

        Applies direct_8x8_inference corner sampling when enabled.
        """
        col = l1[0]
        if self.sps.direct_8x8_inference_flag:
            y4 = 3 * (y4 // 2)
            x4 = 3 * (x4 // 2)
        by, bx = mb_y * 4 + y4, mb_x * 4 + x4
        if col.col_mv is None:
            return (0, 0), -1, -1, col
        return (tuple(int(v) for v in col.col_mv[by, bx]),
                int(col.col_refidx[by, bx]), int(col.col_ref_uid[by, bx]), col)

    def fill_direct(self, mb, mb_x: int, mb_y: int, cur_slice: int,
                    hdr, l0, l1, cur_poc: int, blocks=None) -> None:
        """Derive direct MVs for the given 4x4 cells (default: whole MB)."""
        cells = blocks if blocks is not None else \
            [(y4, x4) for y4 in range(4) for x4 in range(4)]
        for (y4, x4) in cells:
            self.direct_grid[mb_y * 4 + y4, mb_x * 4 + x4] = True
        if hdr.direct_spatial_mv_pred_flag:
            ref0, ref1, mvp0, mvp1, zero_pred = \
                self._direct_spatial_ctx(mb_x, mb_y, cur_slice)
            for (y4, x4) in cells:
                mv_col, refidx_col, _, col = self._col_block(l1, mb_x, mb_y, y4, x4)
                col_zero = (not col.long_term) and refidx_col == 0 and \
                    abs(mv_col[0]) <= 1 and abs(mv_col[1]) <= 1
                for lst, ref, mvp in ((0, ref0, mvp0), (1, ref1, mvp1)):
                    if ref < 0:
                        mv = (0, 0)
                    elif zero_pred or (ref == 0 and col_zero):
                        mv = (0, 0)
                    else:
                        mv = mvp
                    self._set_part(mb, lst, mb_x * 16 + 4 * x4,
                                   mb_y * 16 + 4 * y4, 4, 4, ref, mv)
        else:
            # temporal direct (8.4.1.2.3)
            uid_to_idx = {}
            for i, p in enumerate(l0):
                uid_to_idx.setdefault(p.uid, i)
            col_pic = l1[0]
            for (y4, x4) in cells:
                mv_col, refidx_col, ref_uid, _ = \
                    self._col_block(l1, mb_x, mb_y, y4, x4)
                if refidx_col < 0:
                    ref0 = 0
                    mv_col = (0, 0)
                else:
                    ref0 = uid_to_idx.get(ref_uid, 0)
                refpic = l0[ref0]
                px, py = mb_x * 16 + 4 * x4, mb_y * 16 + 4 * y4
                if refpic.long_term or col_pic.poc == refpic.poc:
                    mv0 = mv_col
                    mv1 = (0, 0)
                else:
                    tb = max(-128, min(127, cur_poc - refpic.poc))
                    td = max(-128, min(127, col_pic.poc - refpic.poc))
                    tx = (16384 + (abs(td) >> 1)) // td
                    dsf = max(-1024, min(1023, (tb * tx + 32) >> 6))
                    mv0 = ((dsf * mv_col[0] + 128) >> 8,
                           (dsf * mv_col[1] + 128) >> 8)
                    mv1 = (mv0[0] - mv_col[0], mv0[1] - mv_col[1])
                self._set_part(mb, 0, px, py, 4, 4, ref0, mv0)
                self._set_part(mb, 1, px, py, 4, 4, 0, mv1)

    # -- B macroblocks (spec 7.3.5.1, Tables 7-14/7-18) ---------------------

    def parse_b_skip(self, mb_x: int, mb_y: int, cur_slice: int, prev_qp: int,
                     hdr, l0, l1, cur_poc: int):
        from .types import MB_BSKIP
        mb = MBRecord(mb_x=mb_x, mb_y=mb_y, slice_id=cur_slice)
        mb.category = MB_BSKIP
        mb.tc_luma = np.zeros((4, 4), np.int32)
        mb.mvs = np.zeros((2, 4, 4, 2), np.int32)
        mb.refidx = np.full((2, 4, 4), -1, np.int8)
        mb.qp = prev_qp
        self.mbs[mb_y * self.mb_w + mb_x] = mb
        self.slice_map[mb_y, mb_x] = cur_slice
        self.fill_direct(mb, mb_x, mb_y, cur_slice, hdr, l0, l1, cur_poc)
        self._finish_mb_keys(mb_x, mb_y)
        return mb

    def parse_b_mb(self, r: BitReader, mb_type: int, mb_x: int, mb_y: int,
                   cur_slice: int, prev_qp: int, hdr, l0, l1, cur_poc: int):
        from .types import B_MODES, B_SUB_MODES, MB_B, MB_BDIRECT16
        pps = self.pps
        mb = MBRecord(mb_x=mb_x, mb_y=mb_y, slice_id=cur_slice)
        mb.category = MB_BDIRECT16 if mb_type == 0 else MB_B
        mb.tc_luma = np.zeros((4, 4), np.int32)
        mb.mvs = np.zeros((2, 4, 4, 2), np.int32)
        mb.refidx = np.full((2, 4, 4), -1, np.int8)
        self.mbs[mb_y * self.mb_w + mb_x] = mb
        self.slice_map[mb_y, mb_x] = cur_slice
        x0, y0 = mb_x * 16, mb_y * 16
        n_ref = (hdr.num_ref_idx_l0_active, hdr.num_ref_idx_l1_active)
        sub_types = None

        if mb_type == 0:
            self.fill_direct(mb, mb_x, mb_y, cur_slice, hdr, l0, l1, cur_poc)
        elif mb_type == 22:  # B_8x8
            sub_types = [r.ue() for _ in range(4)]
            for st in sub_types:
                if st > 12:
                    raise ValueError(f"bad B sub_mb_type {st}")
            # refs: all l0 then all l1 (per 8x8, non-direct, list used)
            refs = [[0] * 4, [0] * 4]
            for lst in range(2):
                for i8 in range(4):
                    st = sub_types[i8]
                    pred = B_SUB_MODES[st][4]
                    uses = pred != 3 and (pred == 2 or pred == lst)
                    if uses and n_ref[lst] > 1:
                        refs[lst][i8] = r.te(n_ref[lst] - 1)
            # partition decode-order keys for all sub-partitions
            for i8 in range(4):
                st = sub_types[i8]
                _, ns, sw, sh, pred = B_SUB_MODES[st]
                sx0, sy0 = x0 + (i8 % 2) * 8, y0 + (i8 // 2) * 8
                if pred == 3:
                    self._assign_key(sx0, sy0, 8, 8, i8 * 8)
                else:
                    for s in range(ns):
                        px, py = self._sub_part_xy(sx0, sy0, sw, sh, s)
                        self._assign_key(px, py, sw, sh, i8 * 8 + s)
            # direct subs derive now (before mvd parse of later partitions,
            # the grids must carry their MVs for prediction)
            for i8 in range(4):
                if B_SUB_MODES[sub_types[i8]][4] == 3:
                    cells = [(2 * (i8 // 2) + dy, 2 * (i8 % 2) + dx)
                             for dy in range(2) for dx in range(2)]
                    self.fill_direct(mb, mb_x, mb_y, cur_slice, hdr, l0, l1,
                                     cur_poc, blocks=cells)
            for lst in range(2):
                for i8 in range(4):
                    st = sub_types[i8]
                    _, ns, sw, sh, pred = B_SUB_MODES[st]
                    if pred == 3 or (pred != 2 and pred != lst):
                        continue
                    sx0, sy0 = x0 + (i8 % 2) * 8, y0 + (i8 // 2) * 8
                    for s in range(ns):
                        px, py = self._sub_part_xy(sx0, sy0, sw, sh, s)
                        mvd = (r.se(), r.se())
                        mvp = self.predict_mv(lst, refs[lst][i8], px, py,
                                              sw, sh, cur_slice,
                                              cur_key=i8 * 8 + s)
                        mv = (mvp[0] + mvd[0], mvp[1] + mvd[1])
                        self._set_part(mb, lst, px, py, sw, sh,
                                       refs[lst][i8], mv)
        else:
            _, (n_parts, pw, ph), preds = B_MODES[mb_type]
            for p in range(n_parts):
                if n_parts == 1:
                    px, py = x0, y0
                elif ph == 8:
                    px, py = x0, y0 + p * 8
                else:
                    px, py = x0 + p * 8, y0
                self._assign_key(px, py, pw, ph, p * 8)
            refs = [[0] * n_parts, [0] * n_parts]
            for lst in range(2):
                for p in range(n_parts):
                    uses = preds[p] == 2 or preds[p] == lst
                    if uses and n_ref[lst] > 1:
                        refs[lst][p] = r.te(n_ref[lst] - 1)
            for lst in range(2):
                for p in range(n_parts):
                    if not (preds[p] == 2 or preds[p] == lst):
                        continue
                    if n_parts == 1:
                        px, py, kind = x0, y0, 0
                    elif ph == 8:      # 16x8
                        px, py, kind = x0, y0 + p * 8, 1 + p
                    else:              # 8x16
                        px, py, kind = x0 + p * 8, y0, 3 + p
                    mvd = (r.se(), r.se())
                    mvp = self.predict_mv(lst, refs[lst][p], px, py, pw, ph,
                                          cur_slice, part_kind=kind,
                                          cur_key=p * 8)
                    mv = (mvp[0] + mvd[0], mvp[1] + mvd[1])
                    self._set_part(mb, lst, px, py, pw, ph, refs[lst][p], mv)

        # coded_block_pattern + residual (same as P)
        code = r.ue()
        if code >= len(CBP_ME):
            raise ValueError(f"bad cbp code {code}")
        cbp = CBP_ME[code][1]
        mb.cbp_luma = cbp & 15
        mb.cbp_chroma = cbp >> 4
        if mb.cbp_luma and pps.transform_8x8_mode_flag:
            if mb_type == 0:
                ok = bool(self.sps.direct_8x8_inference_flag)
            elif sub_types is not None:
                from .types import B_SUB_MODES as BSM
                ok = all((BSM[st][4] == 3 and self.sps.direct_8x8_inference_flag)
                         or (BSM[st][2] == 8 and BSM[st][3] == 8)
                         for st in sub_types)
            else:
                ok = True
            if ok:
                mb.transform_8x8 = bool(r.u1())
        if mb.cbp_luma or mb.cbp_chroma:
            delta = r.se()
            prev_qp = (prev_qp + delta + 52) % 52
        mb.qp = prev_qp
        self._finish_mb_keys(mb_x, mb_y)
        if mb.transform_8x8:
            mb.luma_levels = self._parse_residual_luma_8x8(r, mb, mb_x, mb_y,
                                                           cur_slice)
        else:
            mb.luma_levels = self._parse_residual_luma_4x4(
                r, mb, mb_x, mb_y, cur_slice, ac_only=False)
        self._parse_residual_chroma(r, mb, mb_x, mb_y, cur_slice)
        return mb, prev_qp

    def build_col_motion(self, reflists_by_slice=None):
        """Colocated motion arrays for this picture (used by future B pics).

        Returns (col_mv [H4, W4, 2], col_refidx [H4, W4], col_ref_uid).
        L0 motion preferred, else L1 (spec 8.4.1.2.1); intra -> refidx -1.
        """
        h4, w4 = self.mb_h * 4, self.mb_w * 4
        col_mv = np.zeros((h4, w4, 2), np.int32)
        col_ref = np.full((h4, w4), -1, np.int8)
        col_uid = np.full((h4, w4), -1, np.int32)
        for mb in self.mbs:
            if mb is None or mb.refidx is None:
                continue
            l0, l1 = self.slice_reflists[mb.slice_id]
            for y4 in range(4):
                for x4 in range(4):
                    by, bx = mb.mb_y * 4 + y4, mb.mb_x * 4 + x4
                    r0 = int(mb.refidx[0, y4, x4])
                    r1 = int(mb.refidx[1, y4, x4])
                    if r0 >= 0:
                        col_mv[by, bx] = mb.mvs[0, y4, x4]
                        col_ref[by, bx] = r0
                        col_uid[by, bx] = l0[r0].uid
                    elif r1 >= 0:
                        col_mv[by, bx] = mb.mvs[1, y4, x4]
                        col_ref[by, bx] = r1
                        col_uid[by, bx] = l1[r1].uid
        return col_mv, col_ref, col_uid

    # -- slice loop -----------------------------------------------------------

    def mb_iter(self, hdr: SliceHeader):
        """MB-address successor for this slice: raster +1 without FMO,
        NextMbAddress over the slice-group map with it (spec 8.2.2.8)."""
        if self.pps.num_slice_groups == 1:
            return lambda a: a + 1
        from ..bitstream.fmo import mb_slice_group_map, next_mb_address
        sgmap = mb_slice_group_map(
            self.sps, self.pps,
            getattr(hdr, "slice_group_change_cycle", 0))
        return lambda a: next_mb_address(sgmap, a)

    def parse_slice(self, r: BitReader, hdr: SliceHeader,
                    reflists: tuple = ((), ()), cur_poc: int = 0) -> None:
        """Parse slice_data (CAVLC I/P/B slices)."""
        if self.pps.entropy_coding_mode_flag:
            from .cabac_parse import parse_slice_cabac
            parse_slice_cabac(self, r, hdr, reflists, cur_poc)
            return
        cur_slice = len(self.headers)
        self.headers.append(hdr)
        self.slice_reflists.append(reflists)
        l0, l1 = reflists
        prev_qp = hdr.qp(self.pps)
        addr = hdr.first_mb_in_slice
        n = self.mb_w * self.mb_h
        nxt = self.mb_iter(hdr)
        while True:
            if addr >= n:
                raise ValueError("slice data overruns picture")
            if hdr.is_p or hdr.is_b:
                skip_run = r.ue()
                for _ in range(skip_run):
                    if addr >= n:
                        raise ValueError("mb_skip_run overruns picture")
                    mb_x, mb_y = addr % self.mb_w, addr // self.mb_w
                    if hdr.is_p:
                        self.parse_p_skip(mb_x, mb_y, cur_slice, prev_qp)
                    else:
                        self.parse_b_skip(mb_x, mb_y, cur_slice, prev_qp,
                                          hdr, l0, l1, cur_poc)
                    addr = nxt(addr)
                if not r.more_rbsp_data():
                    break
                if addr >= n:
                    raise ValueError("slice data overruns picture")
            mb_x, mb_y = addr % self.mb_w, addr // self.mb_w
            mb_type = r.ue()
            if hdr.is_p:
                if mb_type >= 5:
                    _, prev_qp = self.parse_i_mb(r, mb_type - 5, mb_x, mb_y,
                                                 cur_slice, prev_qp)
                else:
                    _, prev_qp = self.parse_p_mb(r, mb_type, mb_x, mb_y,
                                                 cur_slice, prev_qp, hdr)
            elif hdr.is_b:
                if mb_type >= 23:
                    _, prev_qp = self.parse_i_mb(r, mb_type - 23, mb_x, mb_y,
                                                 cur_slice, prev_qp)
                else:
                    _, prev_qp = self.parse_b_mb(r, mb_type, mb_x, mb_y,
                                                 cur_slice, prev_qp, hdr,
                                                 l0, l1, cur_poc)
            else:
                _, prev_qp = self.parse_i_mb(r, mb_type, mb_x, mb_y,
                                             cur_slice, prev_qp)
            addr = nxt(addr)
            if not r.more_rbsp_data():
                break

    def finished(self) -> bool:
        return all(m is not None for m in self.mbs)
