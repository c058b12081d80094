"""Hand-authored PAFF (all-field) streams with smooth content, and the
committed 1080i smoke streams made from them.

    python tools/field_smoke.py [NAME ...]

writes tests/data/NAME.264 and tests/data/NAME.json for each NAME of
STREAMS (both by default): CAVLC Main-profile PAFF at 1920x1080 (120 x 34
MB fields, `frame_cropping_flag` with crop_bottom 2: CropUnitY is 4 for
an interlaced SPS, so 1088 coded rows show 1080).  The JSON holds the
per-frame MD5 of libavcodec's decode in output order, the structure
(field pair kinds in decode order) and the command that made them; it
needs the system libavcodec through tools/h264ref,
the machine that only decodes the committed streams does not.

x264 cannot emit PAFF, so the syntax is written here, as
tools/field_streams.py does; unlike its streams (uniform noise, or PCM
at QP 0, where the deblocking filter does nearly nothing), the content
here makes every field-specific rule of the decoder show:
- I fields of Intra16x16 MBs at QP > 0 (DC, vertical, horizontal and
  plane prediction, small DC and sparse AC levels, chroma DC levels):
  smooth samples with small steps, so that alpha and beta pass at edges
  and the filter works on most of them, bS 3 on horizontal MB edges;
- P fields of P_L0_16x16 MBs with ref_idx 0 and 1 (the same and the
  other parity: cross-parity chroma offsets of both signs), small MVDs,
  so that neighbours on the same reference often differ by 2 or 3
  quarter samples vertically (bS 1 in a field picture, 0 in a frame),
  P_Skip runs and intra MBs inside P fields;
- in the "IPBP" structure a non-reference B field pair of B_L0, B_L1
  and B_Bi 16x16 MBs, displayed between the two P pairs.
`make_field_smoke_stream` at a small size (6 x 4 MB fields) feeds the
CPU tests (tests/test_torch_fields.py).
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from arrow_h264_tpu.bitstream.bits import BitWriter  # noqa: E402
from arrow_h264_tpu.bitstream.params import (  # noqa: E402
    PPS, write_pps, write_sps,
)
from arrow_h264_tpu.bitstream.slicehdr import write_slice_header  # noqa: E402
from arrow_h264_tpu.entropy.cavlc import encode_residual_block  # noqa: E402
from tools.field_streams import _field_hdr, field_sps  # noqa: E402
from tools.fmo_streams import _ZBLK, _CavlcPicState, _nal  # noqa: E402

DATA = REPO / "tests" / "data"
HD_MB_W, HD_MAP_UNITS = 120, 34          # 1920 x 1088 coded, fields
# name -> (picture structure, QP, seed); different lengths (4 and 3
# frames), so that batch lanes end in different rounds
STREAMS = {"field_1080i_s0": ("IPBP", 32, 0),
           "field_1080i_s1": ("IPP", 28, 1)}

# slice_type (P 0, B 1, I 2) and the mb_type offset of Intra16x16 types
SLICE_TYPE = {"I": 2, "P": 0, "B": 1}
I16_BASE = {"I": 0, "P": 5, "B": 23}


def _pairs(structure: str) -> list[tuple]:
    """(kind, display index, frame_num, is reference) of each field pair
    in decode order: B pairs are non-reference, and a run of them is
    displayed, in decode order, just before the reference pair that
    precedes the run in decode order ("IPBBP": display 0, 3, 1, 2, 4)."""
    out, frame_num, disp, b_disp = [], 0, 0, 0
    for i, kind in enumerate(structure):
        if kind == "B":
            out.append((kind, b_disp, frame_num, False))
            b_disp += 1
            continue
        n_b = len(structure[i + 1:]) - len(structure[i + 1:].lstrip("B"))
        out.append((kind, disp + n_b, frame_num, True))
        b_disp = disp
        frame_num += 1
        disp += 1 + n_b
    return out


def _i16_mb(w: BitWriter, st: _CavlcPicState, rng, addr: int, kind: str):
    """One Intra16x16 MB: a prediction mode its neighbours allow, chroma
    DC prediction, small luma DC levels, sparse AC levels in a tenth of
    the MBs, chroma DC levels in most."""
    my, mx = divmod(addr, st.mb_w)
    modes = [2] + ([0] if my else []) + ([1] if mx else []) + \
        ([3] if mx and my else [])
    mode = int(rng.choice(modes))
    dc = np.zeros(16, np.int64)
    if rng.random() < 0.5:
        dc[0] = rng.choice([-1, 1])
    for pos in rng.choice(np.arange(1, 6), int(rng.integers(0, 3)),
                          replace=False):
        dc[pos] = rng.choice([-1, 1])
    ac = None
    if rng.random() < 0.1:
        ac = np.zeros((16, 15), np.int64)
        for b in rng.choice(16, int(rng.integers(1, 4)), replace=False):
            ac[b, int(rng.integers(0, 4))] = rng.choice([-1, 1])
    cdc = rng.choice([-1, 0, 0, 1], (2, 4)) if rng.random() < 0.7 else None
    cbp_c = 0 if cdc is None or not cdc.any() else 1
    w.ue(I16_BASE[kind] + 1 + mode + 4 * cbp_c + (12 if ac is not None
                                                   else 0))
    w.ue(0)                                  # intra_chroma_pred_mode DC
    w.se(0)                                  # mb_qp_delta
    by0, bx0 = my * 4, mx * 4
    encode_residual_block(w, st.nc(addr, by0, bx0), list(dc), 16)
    if ac is not None:
        for b, (dy, dx) in enumerate(_ZBLK):
            tc, _ = encode_residual_block(w, st.nc(addr, by0 + dy, bx0 + dx),
                                          list(ac[b]), 15)
            st.nz[by0 + dy, bx0 + dx] = tc
    if cbp_c:
        for pl in range(2):                  # chroma DC, nC -1
            encode_residual_block(w, -1, list(cdc[pl]), 4)


def _field_slice(sps, pps, kind: str, disp: int, frame_num: int, ref: bool,
                 parity: int, idr: bool, rng) -> bytes:
    """One field picture (one slice) of `kind` ("I", "P" or "B")."""
    n = sps.pic_width_in_mbs * sps.pic_height_in_map_units
    hdr = _field_hdr(frame_num, parity, SLICE_TYPE[kind], sps, idr)
    hdr.pic_order_cnt_lsb = (2 * disp + parity - 1) % \
        (1 << sps.log2_max_pic_order_cnt_lsb)
    hdr.nal_ref_idc = 3 if ref else 0
    if kind != "I":
        hdr.num_ref_idx_active_override_flag = 1
        hdr.num_ref_idx_l0_active = 2
        hdr.num_ref_idx_l1_active = 2
    w = BitWriter()
    write_slice_header(w, hdr, sps, pps)
    st = _CavlcPicState(sps.pic_width_in_mbs, sps.pic_height_in_map_units,
                        np.zeros(n, np.int32))
    skip_run = 0
    for addr in range(n):
        u = rng.random()
        if kind == "P" and u < 0.1:
            skip_run += 1                    # P_Skip
            continue
        if kind != "I":
            w.ue(skip_run)                   # mb_skip_run
            skip_run = 0
        if kind == "I" or u > 0.92:
            _i16_mb(w, st, rng, addr, kind)
            continue
        if kind == "P":
            lists = (0,)
            w.ue(0)                          # P_L0_16x16
        else:
            bt = int(rng.integers(1, 4))     # B_L0 / B_L1 / B_Bi_16x16
            lists = {1: (0,), 2: (1,), 3: (0, 1)}[bt]
            w.ue(bt)
        for _ in lists:
            w.te(int(rng.integers(0, 2)), 1)          # ref_idx 0 or 1
        for _ in lists:
            w.se(int(rng.integers(-2, 3)))            # mvd x
            w.se(int(rng.integers(-3, 4)))            # mvd y
        w.ue(0)                              # coded_block_pattern 0
    if skip_run:
        w.ue(skip_run)
    w.rbsp_trailing_bits()
    return _nal(5 if idr else 1, hdr.nal_ref_idc, w.get_bytes())


def make_field_smoke_stream(mb_w: int = 6, map_units: int = 4,
                            structure: str = "IPBP", qp: int = 32,
                            seed: int = 0, crop_bottom: int = 0) -> bytes:
    """A PAFF stream of field pairs (top field first) in `structure`
    (decode order; module docstring), pic_init_qp `qp`, content drawn
    from `seed`; each field is mb_w x map_units MBs."""
    sps = field_sps(mb_w, map_units)
    sps.level_idc = 40
    if crop_bottom:
        sps.frame_cropping_flag = 1
        sps.crop_bottom = crop_bottom
    pps = PPS(pic_init_qp=qp)
    out = [_nal(7, 3, write_sps(sps)), _nal(8, 3, write_pps(pps))]
    rng = np.random.default_rng(seed)
    for f, (kind, disp, frame_num, ref) in enumerate(_pairs(structure)):
        for parity in (1, 2):
            out.append(_field_slice(sps, pps, kind, disp, frame_num, ref,
                                    parity, f == 0 and parity == 1, rng))
    return b"".join(out)


def write_stream(name: str) -> None:
    from tools.streams import golden_decode
    structure, qp, seed = STREAMS[name]
    stream = DATA / f"{name}.264"
    stream.write_bytes(make_field_smoke_stream(
        HD_MB_W, HD_MAP_UNITS, structure, qp, seed, crop_bottom=2))
    golden, gw, gh = golden_decode(str(stream))
    stream.with_suffix(".json").write_text(json.dumps({
        "command": f"python tools/field_smoke.py {name}",
        "content": f"field_smoke.make_field_smoke_stream({HD_MB_W}, "
                   f"{HD_MAP_UNITS}, {structure!r}, qp={qp}, seed={seed}, "
                   "crop_bottom=2)",
        "structure": structure,
        "width": gw, "height": gh, "frames": int(golden.shape[0]),
        "md5": [hashlib.md5(f.tobytes()).hexdigest() for f in golden],
    }, indent=1) + "\n")
    print(f"{stream.relative_to(REPO)}: {stream.stat().st_size} bytes, "
          f"{golden.shape[0]} frames {gw}x{gh}")


def main() -> None:
    names = sys.argv[1:] or list(STREAMS)
    unknown = set(names) - set(STREAMS)
    if unknown:
        sys.exit(f"unknown stream(s) {sorted(unknown)}: expected "
                 f"{sorted(STREAMS)}")
    for name in names:
        write_stream(name)


if __name__ == "__main__":
    main()
