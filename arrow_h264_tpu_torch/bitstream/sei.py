"""SEI message parsing (spec 7.3.2.3, Annex D).

Reference parity: JM-lineage `sei.c` (SURVEY.md §2; parity is against spec
clause D.1/D.2). SEI payloads never affect decoded sample values; we parse the
framing for every message and decode the payload fields of the messages a
player actually consumes (buffering period, pic timing, recovery point, user
data). Unknown payload types are preserved raw.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bits import BitReader

# payloadType values (spec Annex D, Table D-1)
SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_PAN_SCAN_RECT = 2
SEI_FILLER = 3
SEI_USER_DATA_REGISTERED = 4
SEI_USER_DATA_UNREGISTERED = 5
SEI_RECOVERY_POINT = 6
SEI_FILM_GRAIN = 19
SEI_FRAME_PACKING = 45
SEI_DISPLAY_ORIENTATION = 47


@dataclass
class SEIMessage:
    payload_type: int
    payload: bytes          # raw payload bytes
    fields: dict = field(default_factory=dict)  # decoded fields if known


def _parse_recovery_point(payload: bytes) -> dict:
    r = BitReader(payload)
    return {
        "recovery_frame_cnt": r.ue(),
        "exact_match_flag": r.u(1),
        "broken_link_flag": r.u(1),
        "changing_slice_group_idc": r.u(2),
    }


def _parse_buffering_period(payload: bytes, sps=None) -> dict:
    """spec D.2.2: CPB field widths come from the active SPS VUI HRD."""
    r = BitReader(payload)
    out = {"seq_parameter_set_id": r.ue()}
    vui = getattr(sps, "vui", None) if sps is not None else None
    if vui is not None:
        for name, hrd in (("nal", vui.nal_hrd), ("vcl", vui.vcl_hrd)):
            if hrd is None:
                continue
            n = hrd.initial_cpb_removal_delay_length
            out[name] = [
                {"initial_cpb_removal_delay": r.u(n),
                 "initial_cpb_removal_delay_offset": r.u(n)}
                for _ in range(hrd.cpb_cnt)]
    return out


# NumClockTS per pic_struct (spec Table D-1)
_NUM_CLOCK_TS = [1, 1, 1, 2, 2, 3, 3, 2, 3]


def _parse_pic_timing(payload: bytes, sps=None) -> dict:
    """spec D.2.3: pic_timing fields (delays + pic_struct + timestamps).

    Field presence/widths are gated by the active SPS VUI (JM-lineage
    sei.c row in SURVEY.md §2)."""
    vui = getattr(sps, "vui", None) if sps is not None else None
    if vui is None:
        return {}
    r = BitReader(payload)
    out: dict = {}
    if vui.cpb_dpb_delays_present:
        hrd = vui.nal_hrd if vui.nal_hrd is not None else vui.vcl_hrd
        out["cpb_removal_delay"] = r.u(hrd.cpb_removal_delay_length)
        out["dpb_output_delay"] = r.u(hrd.dpb_output_delay_length)
    if vui.pic_struct_present_flag:
        ps = r.u(4)
        out["pic_struct"] = ps
        nts = _NUM_CLOCK_TS[ps] if ps < len(_NUM_CLOCK_TS) else 0
        tss = []
        for _ in range(nts):
            if not r.u1():               # clock_timestamp_flag
                tss.append(None)
                continue
            ts = {
                "ct_type": r.u(2),
                "nuit_field_based_flag": r.u1(),
                "counting_type": r.u(5),
            }
            full = r.u1()
            ts["discontinuity_flag"] = r.u1()
            ts["cnt_dropped_flag"] = r.u1()
            ts["n_frames"] = r.u(8)
            if full:
                ts["seconds"] = r.u(6)
                ts["minutes"] = r.u(6)
                ts["hours"] = r.u(5)
            else:
                ts["seconds"] = ts["minutes"] = ts["hours"] = 0
                if r.u1():
                    ts["seconds"] = r.u(6)
                    if r.u1():
                        ts["minutes"] = r.u(6)
                        if r.u1():
                            ts["hours"] = r.u(5)
            tol = 24
            if vui.cpb_dpb_delays_present:
                hrd = vui.nal_hrd if vui.nal_hrd is not None else vui.vcl_hrd
                tol = hrd.time_offset_length
            # spec D.2.3: time_offset is SIGNED i(v) — sign-extend
            if tol:
                v = r.u(tol)
                ts["time_offset"] = v - (1 << tol) if v >= (1 << (tol - 1)) \
                    else v
            else:
                ts["time_offset"] = 0
            tss.append(ts)
        out["clock_timestamps"] = tss
    return out


def _parse_user_data_unregistered(payload: bytes) -> dict:
    return {"uuid": payload[:16], "data": payload[16:]}


def _parse_pan_scan_rect(payload: bytes) -> dict:
    """spec D.2.4: display-cropping rectangles for pan-scan output."""
    r = BitReader(payload)
    out: dict = {"pan_scan_rect_id": r.ue(),
                 "pan_scan_rect_cancel_flag": r.u(1)}
    if not out["pan_scan_rect_cancel_flag"]:
        cnt = r.ue() + 1
        out["rects"] = [{
            "left_offset": r.se(), "right_offset": r.se(),
            "top_offset": r.se(), "bottom_offset": r.se(),
        } for _ in range(cnt)]
        out["pan_scan_rect_repetition_period"] = r.ue()
    return out


def _parse_film_grain(payload: bytes) -> dict:
    """spec D.2.21: film grain characteristics (synthesis model; never
    affects decoded samples — exposed for display-side grain synth)."""
    r = BitReader(payload)
    out: dict = {"cancel_flag": r.u(1)}
    if out["cancel_flag"]:
        return out
    out["model_id"] = r.u(2)
    out["separate_colour_description_present_flag"] = r.u(1)
    if out["separate_colour_description_present_flag"]:
        out["bit_depth_luma"] = r.u(3) + 8
        out["bit_depth_chroma"] = r.u(3) + 8
        out["full_range_flag"] = r.u(1)
        out["colour_primaries"] = r.u(8)
        out["transfer_characteristics"] = r.u(8)
        out["matrix_coefficients"] = r.u(8)
    out["blending_mode_id"] = r.u(2)
    out["log2_scale_factor"] = r.u(4)
    present = [r.u(1) for _ in range(3)]
    out["comp_model_present_flag"] = present
    comps: list = [None, None, None]
    for c in range(3):
        if not present[c]:
            continue
        n_int = r.u(8) + 1
        n_val = r.u(3) + 1
        comps[c] = [{
            "intensity_interval_lower_bound": r.u(8),
            "intensity_interval_upper_bound": r.u(8),
            "comp_model_values": [r.se() for _ in range(n_val)],
        } for _ in range(n_int)]
    out["comp_models"] = comps
    out["repetition_period"] = r.ue()
    return out


def _parse_frame_packing(payload: bytes) -> dict:
    """spec D.2.25: stereo frame packing arrangement."""
    r = BitReader(payload)
    out: dict = {"frame_packing_arrangement_id": r.ue(),
                 "cancel_flag": r.u(1)}
    if not out["cancel_flag"]:
        out["arrangement_type"] = r.u(7)
        out["quincunx_sampling_flag"] = r.u(1)
        out["content_interpretation_type"] = r.u(6)
        out["spatial_flipping_flag"] = r.u(1)
        out["frame0_flipped_flag"] = r.u(1)
        out["field_views_flag"] = r.u(1)
        out["current_frame_is_frame0_flag"] = r.u(1)
        out["frame0_self_contained_flag"] = r.u(1)
        out["frame1_self_contained_flag"] = r.u(1)
        if not out["quincunx_sampling_flag"] and \
                out["arrangement_type"] != 5:
            out["frame0_grid_position_x"] = r.u(4)
            out["frame0_grid_position_y"] = r.u(4)
            out["frame1_grid_position_x"] = r.u(4)
            out["frame1_grid_position_y"] = r.u(4)
        r.u(8)                              # reserved byte
        out["repetition_period"] = r.ue()
    out["extension_flag"] = r.u(1)
    return out


def _parse_display_orientation(payload: bytes) -> dict:
    """spec D.2.27: flip/rotation hint for display."""
    r = BitReader(payload)
    out: dict = {"cancel_flag": r.u(1)}
    if not out["cancel_flag"]:
        out["hor_flip"] = r.u(1)
        out["ver_flip"] = r.u(1)
        out["anticlockwise_rotation"] = r.u(16)
        out["repetition_period"] = r.ue()
        out["extension_flag"] = r.u(1)
    return out


_PARSERS = {
    SEI_RECOVERY_POINT: lambda p, sps=None: _parse_recovery_point(p),
    SEI_BUFFERING_PERIOD: _parse_buffering_period,
    SEI_PIC_TIMING: _parse_pic_timing,
    SEI_USER_DATA_UNREGISTERED:
        lambda p, sps=None: _parse_user_data_unregistered(p),
    SEI_PAN_SCAN_RECT: lambda p, sps=None: _parse_pan_scan_rect(p),
    SEI_FILM_GRAIN: lambda p, sps=None: _parse_film_grain(p),
    SEI_FRAME_PACKING: lambda p, sps=None: _parse_frame_packing(p),
    SEI_DISPLAY_ORIENTATION:
        lambda p, sps=None: _parse_display_orientation(p),
}


def parse_sei_rbsp(rbsp: bytes, sps=None) -> list[SEIMessage]:
    """Parse all sei_message() in one SEI RBSP (spec 7.3.2.3/7.3.2.3.1).

    `sps`: the active SPS (for VUI-gated payload field widths)."""
    msgs: list[SEIMessage] = []
    i = 0
    n = len(rbsp)
    while i < n:
        if rbsp[i] == 0x80 and all(b == 0 for b in rbsp[i + 1:]):
            break  # rbsp_trailing_bits
        ptype = 0
        while i < n and rbsp[i] == 0xFF:
            ptype += 255
            i += 1
        if i >= n:
            break
        ptype += rbsp[i]
        i += 1
        psize = 0
        while i < n and rbsp[i] == 0xFF:
            psize += 255
            i += 1
        if i >= n:
            break
        psize += rbsp[i]
        i += 1
        payload = rbsp[i:i + psize]
        i += psize
        fields = {}
        parser = _PARSERS.get(ptype)
        if parser is not None and len(payload) == psize:
            try:
                fields = parser(payload, sps)
            except Exception:
                fields = {}  # malformed payload: keep raw bytes only
        msgs.append(SEIMessage(ptype, payload, fields))
    return msgs


def write_sei_rbsp(msgs: list[SEIMessage]) -> bytes:
    """Inverse of parse_sei_rbsp (for tests / stream synthesis)."""
    out = bytearray()
    for m in msgs:
        t = m.payload_type
        while t >= 255:
            out.append(0xFF)
            t -= 255
        out.append(t)
        s = len(m.payload)
        while s >= 255:
            out.append(0xFF)
            s -= 255
        out.append(s)
        out += m.payload
    out.append(0x80)
    return bytes(out)
