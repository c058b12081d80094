"""SPS / PPS parsing and serialization (spec 7.3.2.1, 7.3.2.2, 7.4.2).

Reference parity: JM-lineage `parset.c` (SURVEY.md §2; parity is against the
spec clauses).

Covers Baseline/Main/High profiles for frame coding (frame_mbs_only_flag=1,
4:2:0).  Scaling-list syntax (7.3.2.1.1.1) and the inference/fallback rules
(Table 7-2) are implemented for High profile.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bits import BitReader, BitWriter

PROFILE_BASELINE = 66
PROFILE_MAIN = 77
PROFILE_EXTENDED = 88
PROFILE_HIGH = 100

# Default scaling lists, spec Table 7-3 / 7-4 (values in zig-zag scan order).
DEFAULT_4x4_INTRA = [6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42]
DEFAULT_4x4_INTER = [10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34]
DEFAULT_8x8_INTRA = [
    6, 10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23,
    23, 23, 23, 23, 23, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27,
    27, 27, 27, 27, 29, 29, 29, 29, 29, 29, 29, 31, 31, 31, 31, 31,
    31, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38, 38, 40, 40, 42,
]
DEFAULT_8x8_INTER = [
    9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21,
    21, 21, 21, 21, 21, 22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24,
    24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27,
    27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33, 35,
]
FLAT_16 = [16] * 16
FLAT_64 = [16] * 64


def _parse_scaling_list(r: BitReader, size: int, default: list[int]):
    """Spec 7.3.2.1.1.1. Returns (list-in-zigzag-order, use_default_flag)."""
    last = 8
    next_ = 8
    out = [0] * size
    use_default = False
    for j in range(size):
        if next_ != 0:
            delta = r.se()
            next_ = (last + delta + 256) % 256
            if j == 0 and next_ == 0:
                use_default = True
        out[j] = last if next_ == 0 else next_
        last = out[j]
    if use_default:
        return list(default), True
    return out, False


def _write_scaling_list(w: BitWriter, scal: list[int], use_default: bool) -> None:
    if use_default:
        # delta_scale making nextScale==0 at j==0 signals "use default matrix":
        # 0 == (8 + delta) % 256  ->  delta = -8. No further deltas are coded.
        w.se(-8)
        return
    last = 8
    for v in scal:
        delta = v - last
        # map into [-128, 127] modulo 256
        if delta > 127:
            delta -= 256
        elif delta < -128:
            delta += 256
        w.se(delta)
        last = v


@dataclass
class SPS:
    profile_idc: int = PROFILE_BASELINE
    constraint_set_flags: int = 0
    level_idc: int = 30
    seq_parameter_set_id: int = 0
    chroma_format_idc: int = 1
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    qpprime_y_zero_transform_bypass_flag: int = 0
    seq_scaling_matrix_present_flag: int = 0
    # 6 x 16 + 2..6 x 64 entries, zig-zag order (4:2:0 -> 8 lists)
    scaling_lists_4x4: list = field(default_factory=lambda: [list(FLAT_16) for _ in range(6)])
    scaling_lists_8x8: list = field(default_factory=lambda: [list(FLAT_64) for _ in range(2)])
    seq_scaling_list_present: list = field(default_factory=lambda: [0] * 8)
    log2_max_frame_num: int = 4
    pic_order_cnt_type: int = 0
    log2_max_pic_order_cnt_lsb: int = 4
    delta_pic_order_always_zero_flag: int = 0
    offset_for_non_ref_pic: int = 0
    offset_for_top_to_bottom_field: int = 0
    offset_for_ref_frame: list = field(default_factory=list)
    max_num_ref_frames: int = 1
    gaps_in_frame_num_value_allowed_flag: int = 0
    pic_width_in_mbs: int = 11
    pic_height_in_map_units: int = 9
    frame_mbs_only_flag: int = 1
    mb_adaptive_frame_field_flag: int = 0
    direct_8x8_inference_flag: int = 1
    frame_cropping_flag: int = 0
    crop_left: int = 0
    crop_right: int = 0
    crop_top: int = 0
    crop_bottom: int = 0
    vui_parameters_present_flag: int = 0
    vui: "VUI | None" = None

    @property
    def width(self) -> int:
        return self.pic_width_in_mbs * 16

    @property
    def height(self) -> int:
        """Frame height in luma samples: map units are field-MB rows when
        frame_mbs_only_flag == 0 (all-field PAFF; fields decode at
        pic_height_in_map_units MBs and weave to this frame height)."""
        return (2 - self.frame_mbs_only_flag) * \
            self.pic_height_in_map_units * 16

    @property
    def max_frame_num(self) -> int:
        return 1 << self.log2_max_frame_num

    @property
    def max_poc_lsb(self) -> int:
        return 1 << self.log2_max_pic_order_cnt_lsb

    def flat_scaling(self) -> bool:
        return not self.seq_scaling_matrix_present_flag


def parse_sps(rbsp: bytes) -> SPS:
    r = BitReader(rbsp)
    s = SPS()
    s.profile_idc = r.u(8)
    s.constraint_set_flags = r.u(8)
    s.level_idc = r.u(8)
    s.seq_parameter_set_id = r.ue()
    if s.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        s.chroma_format_idc = r.ue()
        if s.chroma_format_idc == 3:
            r.u1()  # separate_colour_plane_flag
        s.bit_depth_luma = r.ue() + 8
        s.bit_depth_chroma = r.ue() + 8
        # FRExt lossless mode (QP'=0 transform bypass + DPCM intra, spec
        # 8.5.15 / 8.3.5) — decoded by the residual stage
        # (ops.transforms.residual_planes bypass=True)
        s.qpprime_y_zero_transform_bypass_flag = r.u1()
        s.seq_scaling_matrix_present_flag = r.u1()
        if s.seq_scaling_matrix_present_flag:
            n_lists = 8 if s.chroma_format_idc != 3 else 12
            _apply_sps_scaling(s, r, n_lists)
    s.log2_max_frame_num = r.ue() + 4
    s.pic_order_cnt_type = r.ue()
    if s.pic_order_cnt_type == 0:
        s.log2_max_pic_order_cnt_lsb = r.ue() + 4
    elif s.pic_order_cnt_type == 1:
        s.delta_pic_order_always_zero_flag = r.u1()
        s.offset_for_non_ref_pic = r.se()
        s.offset_for_top_to_bottom_field = r.se()
        n = r.ue()
        s.offset_for_ref_frame = [r.se() for _ in range(n)]
    s.max_num_ref_frames = r.ue()
    s.gaps_in_frame_num_value_allowed_flag = r.u1()
    s.pic_width_in_mbs = r.ue() + 1
    s.pic_height_in_map_units = r.ue() + 1
    s.frame_mbs_only_flag = r.u1()
    if not s.frame_mbs_only_flag:
        s.mb_adaptive_frame_field_flag = r.u1()
    s.direct_8x8_inference_flag = r.u1()
    s.frame_cropping_flag = r.u1()
    if s.frame_cropping_flag:
        s.crop_left = r.ue()
        s.crop_right = r.ue()
        s.crop_top = r.ue()
        s.crop_bottom = r.ue()
    s.vui_parameters_present_flag = r.u1()
    # VUI affects no decoded sample values, but its HRD lengths gate SEI
    # pic_timing field parsing (spec D.2.3), so parse it when present.
    if s.vui_parameters_present_flag:
        try:
            s.vui = parse_vui(r)
        except Exception:
            s.vui = None  # tolerate malformed VUI; decode is unaffected
    return s


@dataclass
class HRD:
    """hrd_parameters() (spec E.1.2)."""
    cpb_cnt: int = 1
    bit_rate_scale: int = 0
    cpb_size_scale: int = 0
    bit_rate_value: list = field(default_factory=list)
    cpb_size_value: list = field(default_factory=list)
    cbr_flag: list = field(default_factory=list)
    initial_cpb_removal_delay_length: int = 24
    cpb_removal_delay_length: int = 24
    dpb_output_delay_length: int = 24
    time_offset_length: int = 24


@dataclass
class VUI:
    """vui_parameters() (spec E.1.1) — display/timing metadata."""
    aspect_ratio_idc: int = 0
    sar_width: int = 0
    sar_height: int = 0
    overscan_appropriate_flag: int = -1
    video_format: int = 5
    video_full_range_flag: int = 0
    colour_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    chroma_sample_loc_type_top_field: int = 0
    chroma_sample_loc_type_bottom_field: int = 0
    timing_info_present_flag: int = 0
    num_units_in_tick: int = 0
    time_scale: int = 0
    fixed_frame_rate_flag: int = 0
    nal_hrd: HRD | None = None
    vcl_hrd: HRD | None = None
    low_delay_hrd_flag: int = 0
    pic_struct_present_flag: int = 0
    bitstream_restriction_flag: int = 0
    motion_vectors_over_pic_boundaries_flag: int = 1
    max_bytes_per_pic_denom: int = 2
    max_bits_per_mb_denom: int = 1
    log2_max_mv_length_horizontal: int = 15
    log2_max_mv_length_vertical: int = 15
    max_num_reorder_frames: int = -1
    max_dec_frame_buffering: int = -1

    @property
    def cpb_dpb_delays_present(self) -> bool:
        return self.nal_hrd is not None or self.vcl_hrd is not None

    @property
    def fps(self) -> float | None:
        if self.timing_info_present_flag and self.num_units_in_tick:
            return self.time_scale / (2.0 * self.num_units_in_tick)
        return None


def _parse_hrd(r: BitReader) -> HRD:
    h = HRD()
    h.cpb_cnt = r.ue() + 1
    h.bit_rate_scale = r.u(4)
    h.cpb_size_scale = r.u(4)
    for _ in range(h.cpb_cnt):
        h.bit_rate_value.append(r.ue() + 1)
        h.cpb_size_value.append(r.ue() + 1)
        h.cbr_flag.append(r.u1())
    h.initial_cpb_removal_delay_length = r.u(5) + 1
    h.cpb_removal_delay_length = r.u(5) + 1
    h.dpb_output_delay_length = r.u(5) + 1
    h.time_offset_length = r.u(5)
    return h


def parse_vui(r: BitReader) -> VUI:
    v = VUI()
    if r.u1():                           # aspect_ratio_info_present
        v.aspect_ratio_idc = r.u(8)
        if v.aspect_ratio_idc == 255:    # Extended_SAR
            v.sar_width = r.u(16)
            v.sar_height = r.u(16)
    if r.u1():                           # overscan_info_present
        v.overscan_appropriate_flag = r.u1()
    if r.u1():                           # video_signal_type_present
        v.video_format = r.u(3)
        v.video_full_range_flag = r.u1()
        if r.u1():                       # colour_description_present
            v.colour_primaries = r.u(8)
            v.transfer_characteristics = r.u(8)
            v.matrix_coefficients = r.u(8)
    if r.u1():                           # chroma_loc_info_present
        v.chroma_sample_loc_type_top_field = r.ue()
        v.chroma_sample_loc_type_bottom_field = r.ue()
    v.timing_info_present_flag = r.u1()
    if v.timing_info_present_flag:
        v.num_units_in_tick = r.u(32)
        v.time_scale = r.u(32)
        v.fixed_frame_rate_flag = r.u1()
    if r.u1():                           # nal_hrd_parameters_present
        v.nal_hrd = _parse_hrd(r)
    if r.u1():                           # vcl_hrd_parameters_present
        v.vcl_hrd = _parse_hrd(r)
    if v.cpb_dpb_delays_present:
        v.low_delay_hrd_flag = r.u1()
    v.pic_struct_present_flag = r.u1()
    v.bitstream_restriction_flag = r.u1()
    if v.bitstream_restriction_flag:
        v.motion_vectors_over_pic_boundaries_flag = r.u1()
        v.max_bytes_per_pic_denom = r.ue()
        v.max_bits_per_mb_denom = r.ue()
        v.log2_max_mv_length_horizontal = r.ue()
        v.log2_max_mv_length_vertical = r.ue()
        v.max_num_reorder_frames = r.ue()
        v.max_dec_frame_buffering = r.ue()
    return v


def _apply_sps_scaling(s: SPS, r: BitReader, n_lists: int) -> None:
    """Parse seq scaling lists with Table 7-2 fallback rule A."""
    s.seq_scaling_list_present = [0] * n_lists
    for i in range(n_lists):
        present = r.u1()
        s.seq_scaling_list_present[i] = present
        if i < 6:
            default = DEFAULT_4x4_INTRA if i < 3 else DEFAULT_4x4_INTER
            if present:
                lst, use_def = _parse_scaling_list(r, 16, default)
                s.scaling_lists_4x4[i] = lst
            else:
                # fallback A: i in (0,3) -> default; else copy previous
                if i in (0, 3):
                    s.scaling_lists_4x4[i] = list(default)
                else:
                    s.scaling_lists_4x4[i] = list(s.scaling_lists_4x4[i - 1])
        else:
            j = i - 6
            default = DEFAULT_8x8_INTRA if (j % 2 == 0) else DEFAULT_8x8_INTER
            while len(s.scaling_lists_8x8) <= j:
                s.scaling_lists_8x8.append(list(FLAT_64))
            if present:
                lst, use_def = _parse_scaling_list(r, 64, default)
                s.scaling_lists_8x8[j] = lst
            else:
                if j < 2:
                    s.scaling_lists_8x8[j] = list(default)
                else:
                    s.scaling_lists_8x8[j] = list(s.scaling_lists_8x8[j - 2])


def write_sps(s: SPS) -> bytes:
    w = BitWriter()
    w.u(s.profile_idc, 8)
    w.u(s.constraint_set_flags, 8)
    w.u(s.level_idc, 8)
    w.ue(s.seq_parameter_set_id)
    if s.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        w.ue(s.chroma_format_idc)
        w.ue(s.bit_depth_luma - 8)
        w.ue(s.bit_depth_chroma - 8)
        w.u(s.qpprime_y_zero_transform_bypass_flag, 1)
        w.u(s.seq_scaling_matrix_present_flag, 1)
        if s.seq_scaling_matrix_present_flag:
            for i in range(8):
                present = s.seq_scaling_list_present[i]
                w.u(present, 1)
                if present:
                    if i < 6:
                        _write_scaling_list(w, s.scaling_lists_4x4[i], False)
                    else:
                        _write_scaling_list(w, s.scaling_lists_8x8[i - 6], False)
    w.ue(s.log2_max_frame_num - 4)
    w.ue(s.pic_order_cnt_type)
    if s.pic_order_cnt_type == 0:
        w.ue(s.log2_max_pic_order_cnt_lsb - 4)
    elif s.pic_order_cnt_type == 1:
        w.u(s.delta_pic_order_always_zero_flag, 1)
        w.se(s.offset_for_non_ref_pic)
        w.se(s.offset_for_top_to_bottom_field)
        w.ue(len(s.offset_for_ref_frame))
        for v in s.offset_for_ref_frame:
            w.se(v)
    w.ue(s.max_num_ref_frames)
    w.u(s.gaps_in_frame_num_value_allowed_flag, 1)
    w.ue(s.pic_width_in_mbs - 1)
    w.ue(s.pic_height_in_map_units - 1)
    w.u(s.frame_mbs_only_flag, 1)
    if not s.frame_mbs_only_flag:
        w.u(s.mb_adaptive_frame_field_flag, 1)
    w.u(s.direct_8x8_inference_flag, 1)
    w.u(s.frame_cropping_flag, 1)
    if s.frame_cropping_flag:
        w.ue(s.crop_left)
        w.ue(s.crop_right)
        w.ue(s.crop_top)
        w.ue(s.crop_bottom)
    w.u(s.vui_parameters_present_flag, 1)
    w.rbsp_trailing_bits()
    return w.get_bytes()


@dataclass
class PPS:
    pic_parameter_set_id: int = 0
    seq_parameter_set_id: int = 0
    entropy_coding_mode_flag: int = 0
    bottom_field_pic_order_in_frame_present_flag: int = 0
    num_slice_groups: int = 1
    # FMO slice-group map (spec 7.3.2.2 / 8.2.2; JM-lineage fmo.c)
    slice_group_map_type: int = 0
    run_length: list = field(default_factory=list)          # type 0
    top_left: list = field(default_factory=list)            # type 2
    bottom_right: list = field(default_factory=list)        # type 2
    slice_group_change_direction_flag: int = 0              # types 3..5
    slice_group_change_rate: int = 1                        # types 3..5
    slice_group_id: list | None = None                      # type 6
    num_ref_idx_l0_default_active: int = 1
    num_ref_idx_l1_default_active: int = 1
    weighted_pred_flag: int = 0
    weighted_bipred_idc: int = 0
    pic_init_qp: int = 26
    pic_init_qs: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present_flag: int = 0
    constrained_intra_pred_flag: int = 0
    redundant_pic_cnt_present_flag: int = 0
    # High-profile extras
    transform_8x8_mode_flag: int = 0
    pic_scaling_matrix_present_flag: int = 0
    pic_scaling_list_present: list = field(default_factory=lambda: [0] * 8)
    scaling_lists_4x4: list | None = None  # overrides SPS when present
    scaling_lists_8x8: list | None = None
    second_chroma_qp_index_offset: int | None = None

    def chroma_qp_offset(self, plane: int) -> int:
        if plane == 1 and self.second_chroma_qp_index_offset is not None:
            return self.second_chroma_qp_index_offset
        return self.chroma_qp_index_offset


def parse_pps(rbsp: bytes, sps_map: dict[int, SPS]) -> PPS:
    r = BitReader(rbsp)
    p = PPS()
    p.pic_parameter_set_id = r.ue()
    p.seq_parameter_set_id = r.ue()
    p.entropy_coding_mode_flag = r.u1()
    p.bottom_field_pic_order_in_frame_present_flag = r.u1()
    p.num_slice_groups = r.ue() + 1
    if p.num_slice_groups > 1:
        # FMO (spec 7.3.2.2).  Decoded by the Python entropy path; the
        # map itself is derived per slice in bitstream.fmo.
        p.slice_group_map_type = r.ue()
        t = p.slice_group_map_type
        if t == 0:
            p.run_length = [r.ue() + 1 for _ in range(p.num_slice_groups)]
        elif t == 2:
            p.top_left, p.bottom_right = [], []
            for _ in range(p.num_slice_groups - 1):
                p.top_left.append(r.ue())
                p.bottom_right.append(r.ue())
        elif t in (3, 4, 5):
            p.slice_group_change_direction_flag = r.u1()
            p.slice_group_change_rate = r.ue() + 1
        elif t == 6:
            cnt = r.ue() + 1
            bits = max(1, (p.num_slice_groups - 1).bit_length())
            p.slice_group_id = [r.u(bits) for _ in range(cnt)]
        elif t != 1:
            raise ValueError(f"bad slice_group_map_type {t}")
    p.num_ref_idx_l0_default_active = r.ue() + 1
    p.num_ref_idx_l1_default_active = r.ue() + 1
    p.weighted_pred_flag = r.u1()
    p.weighted_bipred_idc = r.u(2)
    p.pic_init_qp = r.se() + 26
    p.pic_init_qs = r.se() + 26
    p.chroma_qp_index_offset = r.se()
    p.deblocking_filter_control_present_flag = r.u1()
    p.constrained_intra_pred_flag = r.u1()
    p.redundant_pic_cnt_present_flag = r.u1()
    if r.more_rbsp_data():
        p.transform_8x8_mode_flag = r.u1()
        p.pic_scaling_matrix_present_flag = r.u1()
        if p.pic_scaling_matrix_present_flag:
            sps = sps_map[p.seq_parameter_set_id]
            _apply_pps_scaling(p, r, sps)
        p.second_chroma_qp_index_offset = r.se()
    return p


def _apply_pps_scaling(p: PPS, r: BitReader, sps: SPS) -> None:
    """Parse pic scaling lists with Table 7-2 fallback rule A/B."""
    n_lists = 6 + (2 * p.transform_8x8_mode_flag if sps.chroma_format_idc != 3
                   else 6 * p.transform_8x8_mode_flag)
    sps_present = sps.seq_scaling_matrix_present_flag
    p.scaling_lists_4x4 = [list(x) for x in sps.scaling_lists_4x4]
    p.scaling_lists_8x8 = [list(x) for x in sps.scaling_lists_8x8]
    p.pic_scaling_list_present = [0] * n_lists
    for i in range(n_lists):
        present = r.u1()
        p.pic_scaling_list_present[i] = present
        if i < 6:
            default = DEFAULT_4x4_INTRA if i < 3 else DEFAULT_4x4_INTER
            if present:
                lst, _ = _parse_scaling_list(r, 16, default)
                p.scaling_lists_4x4[i] = lst
            else:
                if i in (0, 3):
                    # fallback B when SPS matrix present: use SPS list; else default
                    if sps_present:
                        p.scaling_lists_4x4[i] = list(sps.scaling_lists_4x4[i])
                    else:
                        p.scaling_lists_4x4[i] = list(default)
                else:
                    p.scaling_lists_4x4[i] = list(p.scaling_lists_4x4[i - 1])
        else:
            j = i - 6
            default = DEFAULT_8x8_INTRA if (j % 2 == 0) else DEFAULT_8x8_INTER
            while len(p.scaling_lists_8x8) <= j:
                p.scaling_lists_8x8.append(list(FLAT_64))
            if present:
                lst, _ = _parse_scaling_list(r, 64, default)
                p.scaling_lists_8x8[j] = lst
            else:
                if j < 2:
                    if sps_present:
                        p.scaling_lists_8x8[j] = list(sps.scaling_lists_8x8[j])
                    else:
                        p.scaling_lists_8x8[j] = list(default)
                else:
                    p.scaling_lists_8x8[j] = list(p.scaling_lists_8x8[j - 2])


def write_pps(p: PPS, high_tail: bool = False) -> bytes:
    w = BitWriter()
    w.ue(p.pic_parameter_set_id)
    w.ue(p.seq_parameter_set_id)
    w.u(p.entropy_coding_mode_flag, 1)
    w.u(p.bottom_field_pic_order_in_frame_present_flag, 1)
    w.ue(p.num_slice_groups - 1)
    if p.num_slice_groups > 1:
        w.ue(p.slice_group_map_type)
        t = p.slice_group_map_type
        if t == 0:
            for rl in p.run_length:
                w.ue(rl - 1)
        elif t == 2:
            for tl, br in zip(p.top_left, p.bottom_right):
                w.ue(tl)
                w.ue(br)
        elif t in (3, 4, 5):
            w.u(p.slice_group_change_direction_flag, 1)
            w.ue(p.slice_group_change_rate - 1)
        elif t == 6:
            w.ue(len(p.slice_group_id) - 1)
            bits = max(1, (p.num_slice_groups - 1).bit_length())
            for g in p.slice_group_id:
                w.u(g, bits)
    w.ue(p.num_ref_idx_l0_default_active - 1)
    w.ue(p.num_ref_idx_l1_default_active - 1)
    w.u(p.weighted_pred_flag, 1)
    w.u(p.weighted_bipred_idc, 2)
    w.se(p.pic_init_qp - 26)
    w.se(p.pic_init_qs - 26)
    w.se(p.chroma_qp_index_offset)
    w.u(p.deblocking_filter_control_present_flag, 1)
    w.u(p.constrained_intra_pred_flag, 1)
    w.u(p.redundant_pic_cnt_present_flag, 1)
    if high_tail or p.transform_8x8_mode_flag or p.pic_scaling_matrix_present_flag \
            or p.second_chroma_qp_index_offset is not None:
        w.u(p.transform_8x8_mode_flag, 1)
        w.u(p.pic_scaling_matrix_present_flag, 1)
        if p.pic_scaling_matrix_present_flag:
            n_lists = 6 + 2 * p.transform_8x8_mode_flag
            for i in range(n_lists):
                present = p.pic_scaling_list_present[i] if i < len(p.pic_scaling_list_present) else 0
                w.u(present, 1)
                if present:
                    if i < 6:
                        _write_scaling_list(w, p.scaling_lists_4x4[i], False)
                    else:
                        _write_scaling_list(w, p.scaling_lists_8x8[i - 6], False)
        w.se(p.second_chroma_qp_index_offset or 0)
    w.rbsp_trailing_bits()
    return w.get_bytes()
