"""Slice-header parsing and serialization (spec 7.3.3, 7.4.3).

Reference parity: JM-lineage `header.c` (SURVEY.md §2; parity is against the
spec clauses).

Supports frame-coded I/P/B slices: POC types 0/2, ref-list modification,
prediction-weight tables, dec_ref_pic_marking (sliding window + MMCO),
CABAC init idc, and deblocking-filter control.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bits import BitReader, BitWriter
from .params import PPS, SPS

SLICE_P = 0
SLICE_B = 1
SLICE_I = 2
SLICE_SP = 3
SLICE_SI = 4

_TYPE_NAMES = {SLICE_P: "P", SLICE_B: "B", SLICE_I: "I", SLICE_SP: "SP", SLICE_SI: "SI"}


@dataclass
class RefPicListMod:
    idc: int          # 0/1: short-term, 2: long-term
    value: int        # abs_diff_pic_num_minus1 or long_term_pic_num


@dataclass
class MMCO:
    op: int
    val1: int = 0
    val2: int = 0


@dataclass
class PredWeight:
    luma_weight: int
    luma_offset: int
    chroma_weight: tuple  # (cb, cr)
    chroma_offset: tuple


@dataclass
class SliceHeader:
    first_mb_in_slice: int = 0
    slice_type: int = SLICE_I          # reduced to 0..4
    pic_parameter_set_id: int = 0
    frame_num: int = 0
    idr_pic_id: int = 0
    pic_order_cnt_lsb: int = 0
    delta_pic_order_cnt: tuple = (0, 0)
    redundant_pic_cnt: int = 0
    direct_spatial_mv_pred_flag: int = 1
    num_ref_idx_active_override_flag: int = 0
    num_ref_idx_l0_active: int = 1
    num_ref_idx_l1_active: int = 1
    ref_pic_list_mods_l0: list = field(default_factory=list)
    ref_pic_list_mods_l1: list = field(default_factory=list)
    luma_log2_weight_denom: int = 0
    chroma_log2_weight_denom: int = 0
    pred_weights_l0: list = field(default_factory=list)  # list[PredWeight | None]
    pred_weights_l1: list = field(default_factory=list)
    no_output_of_prior_pics_flag: int = 0
    long_term_reference_flag: int = 0
    adaptive_ref_pic_marking_mode_flag: int = 0
    mmcos: list = field(default_factory=list)
    cabac_init_idc: int = 0
    slice_qp_delta: int = 0
    disable_deblocking_filter_idc: int = 0
    slice_alpha_c0_offset_div2: int = 0
    slice_beta_offset_div2: int = 0
    slice_group_change_cycle: int = 0  # FMO map types 3..5 (spec 7.4.3)
    field_pic_flag: int = 0            # PAFF field picture (spec 7.4.3)
    bottom_field_flag: int = 0
    # filled by caller:
    is_idr: bool = False
    nal_ref_idc: int = 1

    @property
    def parity(self) -> int:
        """0 = frame picture, 1 = top field, 2 = bottom field."""
        if not self.field_pic_flag:
            return 0
        return 2 if self.bottom_field_flag else 1

    @property
    def type_name(self) -> str:
        return _TYPE_NAMES[self.slice_type]

    @property
    def is_p(self) -> bool:
        return self.slice_type == SLICE_P

    @property
    def is_b(self) -> bool:
        return self.slice_type == SLICE_B

    @property
    def is_i(self) -> bool:
        return self.slice_type == SLICE_I

    def qp(self, pps: PPS) -> int:
        return pps.pic_init_qp + self.slice_qp_delta


def _parse_ref_pic_list_mod(r: BitReader) -> list[RefPicListMod]:
    mods = []
    if r.u1():  # ref_pic_list_modification_flag
        while True:
            idc = r.ue()
            if idc == 3:
                break
            mods.append(RefPicListMod(idc, r.ue()))
            if len(mods) > 64:
                raise ValueError("runaway ref_pic_list_modification")
    return mods


def _write_ref_pic_list_mod(w: BitWriter, mods: list[RefPicListMod]) -> None:
    if not mods:
        w.u(0, 1)
        return
    w.u(1, 1)
    for m in mods:
        w.ue(m.idc)
        w.ue(m.value)
    w.ue(3)


def _parse_pred_weight_table(r: BitReader, h: SliceHeader, chroma: bool) -> None:
    h.luma_log2_weight_denom = r.ue()
    if chroma:
        h.chroma_log2_weight_denom = r.ue()
    for lst, count in ((h.pred_weights_l0, h.num_ref_idx_l0_active),
                       (h.pred_weights_l1, h.num_ref_idx_l1_active if h.is_b else 0)):
        for _ in range(count):
            lw, lo = 1 << h.luma_log2_weight_denom, 0
            explicit_l = r.u1()
            if explicit_l:
                lw, lo = r.se(), r.se()
            cw = [1 << h.chroma_log2_weight_denom] * 2
            co = [0, 0]
            if chroma:
                if r.u1():
                    for j in range(2):
                        cw[j], co[j] = r.se(), r.se()
            lst.append(PredWeight(lw, lo, tuple(cw), tuple(co)))


def _write_pred_weight_table(w: BitWriter, h: SliceHeader, chroma: bool) -> None:
    w.ue(h.luma_log2_weight_denom)
    if chroma:
        w.ue(h.chroma_log2_weight_denom)
    for lst, count in ((h.pred_weights_l0, h.num_ref_idx_l0_active),
                       (h.pred_weights_l1, h.num_ref_idx_l1_active if h.is_b else 0)):
        for i in range(count):
            pw = lst[i]
            default_l = pw.luma_weight == (1 << h.luma_log2_weight_denom) and pw.luma_offset == 0
            w.u(0 if default_l else 1, 1)
            if not default_l:
                w.se(pw.luma_weight)
                w.se(pw.luma_offset)
            if chroma:
                default_c = (pw.chroma_weight == (1 << h.chroma_log2_weight_denom,) * 2
                             and pw.chroma_offset == (0, 0))
                w.u(0 if default_c else 1, 1)
                if not default_c:
                    for j in range(2):
                        w.se(pw.chroma_weight[j])
                        w.se(pw.chroma_offset[j])


def _parse_dec_ref_pic_marking(r: BitReader, h: SliceHeader) -> None:
    if h.is_idr:
        h.no_output_of_prior_pics_flag = r.u1()
        h.long_term_reference_flag = r.u1()
        return
    h.adaptive_ref_pic_marking_mode_flag = r.u1()
    if h.adaptive_ref_pic_marking_mode_flag:
        while True:
            op = r.ue()
            if op == 0:
                break
            m = MMCO(op)
            if op in (1, 3):
                m.val1 = r.ue()  # difference_of_pic_nums_minus1
            if op == 2:
                m.val1 = r.ue()  # long_term_pic_num
            if op == 3:
                m.val2 = r.ue()  # long_term_frame_idx
            if op == 6:
                m.val1 = r.ue()  # long_term_frame_idx
            if op == 4:
                m.val1 = r.ue()  # max_long_term_frame_idx_plus1
            h.mmcos.append(m)
            if len(h.mmcos) > 64:
                raise ValueError("runaway MMCO list")


def _write_dec_ref_pic_marking(w: BitWriter, h: SliceHeader) -> None:
    if h.is_idr:
        w.u(h.no_output_of_prior_pics_flag, 1)
        w.u(h.long_term_reference_flag, 1)
        return
    w.u(h.adaptive_ref_pic_marking_mode_flag, 1)
    if h.adaptive_ref_pic_marking_mode_flag:
        for m in h.mmcos:
            w.ue(m.op)
            if m.op in (1, 3):
                w.ue(m.val1)
            if m.op == 2:
                w.ue(m.val1)
            if m.op == 3:
                w.ue(m.val2)
            if m.op == 6:
                w.ue(m.val1)
            if m.op == 4:
                w.ue(m.val1)
        w.ue(0)


def parse_slice_header(r: BitReader, sps: SPS, pps: PPS,
                       nal_unit_type: int, nal_ref_idc: int) -> SliceHeader:
    """Parse the slice header; `r` is positioned at the start of the RBSP.

    On return `r` is positioned at slice data (for CAVLC) or just before
    cabac_alignment_one_bit (for CABAC the caller aligns).
    """
    h = SliceHeader()
    h.is_idr = nal_unit_type == 5
    h.nal_ref_idc = nal_ref_idc
    h.first_mb_in_slice = r.ue()
    st = r.ue()
    if st > 9:
        raise ValueError(f"bad slice_type {st}")
    h.slice_type = st % 5
    if h.slice_type in (SLICE_SP, SLICE_SI):
        raise NotImplementedError("SP/SI slices not supported")
    h.pic_parameter_set_id = r.ue()
    if sps.chroma_format_idc == 3:
        raise NotImplementedError("4:4:4 not supported")
    h.frame_num = r.u(sps.log2_max_frame_num)
    if not sps.frame_mbs_only_flag:
        # PAFF field pictures are supported (all-field streams); coded
        # FRAMES inside an interlaced stream (incl. MBAFF MB pairs) are
        # not — their geometry is 2x the field pipelines' (README scope).
        h.field_pic_flag = r.u1()
        if h.field_pic_flag:
            h.bottom_field_flag = r.u1()
        else:
            raise NotImplementedError(
                "frame pictures in interlaced streams (MBAFF/mixed PAFF) "
                "not supported; all-field PAFF streams are")
    if h.is_idr:
        h.idr_pic_id = r.ue()
    if sps.pic_order_cnt_type == 0:
        h.pic_order_cnt_lsb = r.u(sps.log2_max_pic_order_cnt_lsb)
        if pps.bottom_field_pic_order_in_frame_present_flag and \
                not h.field_pic_flag:
            h.delta_pic_order_cnt = (r.se(), 0)
    elif sps.pic_order_cnt_type == 1 and not sps.delta_pic_order_always_zero_flag:
        d0 = r.se()
        d1 = r.se() if pps.bottom_field_pic_order_in_frame_present_flag \
            and not h.field_pic_flag else 0
        h.delta_pic_order_cnt = (d0, d1)
    if pps.redundant_pic_cnt_present_flag:
        h.redundant_pic_cnt = r.ue()
    if h.is_b:
        h.direct_spatial_mv_pred_flag = r.u1()
    h.num_ref_idx_l0_active = pps.num_ref_idx_l0_default_active
    h.num_ref_idx_l1_active = pps.num_ref_idx_l1_default_active
    if h.is_p or h.is_b:
        h.num_ref_idx_active_override_flag = r.u1()
        if h.num_ref_idx_active_override_flag:
            h.num_ref_idx_l0_active = r.ue() + 1
            if h.is_b:
                h.num_ref_idx_l1_active = r.ue() + 1
        h.ref_pic_list_mods_l0 = _parse_ref_pic_list_mod(r)
        if h.is_b:
            h.ref_pic_list_mods_l1 = _parse_ref_pic_list_mod(r)
    if (pps.weighted_pred_flag and h.is_p) or (pps.weighted_bipred_idc == 1 and h.is_b):
        _parse_pred_weight_table(r, h, chroma=sps.chroma_format_idc != 0)
    if nal_ref_idc:
        _parse_dec_ref_pic_marking(r, h)
    if pps.entropy_coding_mode_flag and not h.is_i:
        h.cabac_init_idc = r.ue()
    h.slice_qp_delta = r.se()
    if pps.deblocking_filter_control_present_flag:
        h.disable_deblocking_filter_idc = r.ue()
        if h.disable_deblocking_filter_idc != 1:
            h.slice_alpha_c0_offset_div2 = r.se()
            h.slice_beta_offset_div2 = r.se()
    if pps.num_slice_groups > 1 and pps.slice_group_map_type in (3, 4, 5):
        h.slice_group_change_cycle = r.u(change_cycle_bits(sps, pps))
    return h


def change_cycle_bits(sps: SPS, pps: PPS) -> int:
    """Bit width of slice_group_change_cycle (spec 7.4.3):
    Ceil(Log2(Ceil(PicSizeInMapUnits / SliceGroupChangeRate) + 1)) —
    the inner division is a CEILING, not floor (JM read_new_slice adds
    one when the remainder is non-zero before CeilLog2)."""
    n_units = sps.pic_width_in_mbs * sps.pic_height_in_map_units
    return max(1, (-(-n_units // pps.slice_group_change_rate)).bit_length())


def write_slice_header(w: BitWriter, h: SliceHeader, sps: SPS, pps: PPS) -> None:
    w.ue(h.first_mb_in_slice)
    w.ue(h.slice_type)
    w.ue(h.pic_parameter_set_id)
    w.u(h.frame_num, sps.log2_max_frame_num)
    if not sps.frame_mbs_only_flag:
        w.u(h.field_pic_flag, 1)
        if h.field_pic_flag:
            w.u(h.bottom_field_flag, 1)
    if h.is_idr:
        w.ue(h.idr_pic_id)
    if sps.pic_order_cnt_type == 0:
        w.u(h.pic_order_cnt_lsb, sps.log2_max_pic_order_cnt_lsb)
        if pps.bottom_field_pic_order_in_frame_present_flag and \
                not h.field_pic_flag:
            w.se(h.delta_pic_order_cnt[0])
    elif sps.pic_order_cnt_type == 1 and not sps.delta_pic_order_always_zero_flag:
        w.se(h.delta_pic_order_cnt[0])
        if pps.bottom_field_pic_order_in_frame_present_flag and \
                not h.field_pic_flag:
            w.se(h.delta_pic_order_cnt[1])
    if pps.redundant_pic_cnt_present_flag:
        w.ue(h.redundant_pic_cnt)
    if h.is_b:
        w.u(h.direct_spatial_mv_pred_flag, 1)
    if h.is_p or h.is_b:
        w.u(h.num_ref_idx_active_override_flag, 1)
        if h.num_ref_idx_active_override_flag:
            w.ue(h.num_ref_idx_l0_active - 1)
            if h.is_b:
                w.ue(h.num_ref_idx_l1_active - 1)
        _write_ref_pic_list_mod(w, h.ref_pic_list_mods_l0)
        if h.is_b:
            _write_ref_pic_list_mod(w, h.ref_pic_list_mods_l1)
    if (pps.weighted_pred_flag and h.is_p) or (pps.weighted_bipred_idc == 1 and h.is_b):
        _write_pred_weight_table(w, h, chroma=sps.chroma_format_idc != 0)
    if h.nal_ref_idc:
        _write_dec_ref_pic_marking(w, h)
    if pps.entropy_coding_mode_flag and not h.is_i:
        w.ue(h.cabac_init_idc)
    w.se(h.slice_qp_delta)
    if pps.deblocking_filter_control_present_flag:
        w.ue(h.disable_deblocking_filter_idc)
        if h.disable_deblocking_filter_idc != 1:
            w.se(h.slice_alpha_c0_offset_div2)
            w.se(h.slice_beta_offset_div2)
    if pps.num_slice_groups > 1 and pps.slice_group_map_type in (3, 4, 5):
        w.u(h.slice_group_change_cycle, change_cycle_bits(sps, pps))
