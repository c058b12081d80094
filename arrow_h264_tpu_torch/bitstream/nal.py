"""Annex-B byte-stream framing and NAL unit handling (spec Annex B, 7.3.1, 7.4.1).

Reference parity: JM-lineage `annexb.c` / `nalu.c` (SURVEY.md §2; parity is
against the spec clauses).
"""

from __future__ import annotations

from dataclasses import dataclass

# nal_unit_type values (spec Table 7-1)
NAL_SLICE_NON_IDR = 1
NAL_SLICE_DPA = 2
NAL_SLICE_DPB = 3
NAL_SLICE_DPC = 4
NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9
NAL_END_OF_SEQ = 10
NAL_END_OF_STREAM = 11
NAL_FILLER = 12


@dataclass
class NalUnit:
    nal_ref_idc: int
    nal_unit_type: int
    rbsp: bytes  # emulation prevention removed

    @property
    def is_slice(self) -> bool:
        return self.nal_unit_type in (NAL_SLICE_NON_IDR, NAL_SLICE_IDR)

    @property
    def is_idr(self) -> bool:
        return self.nal_unit_type == NAL_SLICE_IDR


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Remove emulation_prevention_three_byte (spec 7.4.1.1).

    0x00 0x00 0x03 followed by 0x00/0x01/0x02/0x03 -> drop the 0x03.
    Vectorized: candidate 0x03 positions come from a numpy scan; overlap
    chains (00 00 03 00 03 ...) are resolved left-to-right over the few
    candidates only.
    """
    if b"\x00\x00\x03" not in ebsp:
        return ebsp
    import numpy as np
    a = np.frombuffer(ebsp, np.uint8)
    n = len(a)
    is3 = a == 3
    z1 = np.concatenate([[False], a[:-1] == 0])
    z2 = np.concatenate([[False, False], a[:-2] == 0])
    nxt_ok = np.concatenate([a[1:] <= 3, [True]])
    # The mask is exact without sequential resolution: the scanner's
    # zero-run count before byte i is >= 2 iff bytes i-2, i-1 are both
    # literal zeros (zeros always increment the count; a dropped 0x03 is
    # itself non-zero so it can never BE one of the two zeros).
    drop = is3 & z1 & z2 & nxt_ok
    if not drop.any():
        return ebsp
    return a[~drop].tobytes()


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (spec 7.4.1.1 encoding rule)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def split_annexb(stream: bytes):
    """Yield raw EBSP NAL payloads (header byte included) from an Annex-B stream.

    Handles 3- and 4-byte start codes and trailing zero padding (Annex B.1.1).
    """
    i = 0
    n = len(stream)
    starts = []
    while True:
        j = stream.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        starts.append(j + 3)
        i = j + 3
    for k, s in enumerate(starts):
        e = n if k + 1 == len(starts) else starts[k + 1] - 3
        # strip trailing_zero_8bits and the leading zeros of next start code
        while e > s and stream[e - 1] == 0:
            e -= 1
        if e > s:
            yield stream[s:e]


def parse_annexb(stream: bytes):
    """Yield NalUnit objects from an Annex-B byte stream."""
    for ebsp in split_annexb(stream):
        hdr = ebsp[0]
        if hdr & 0x80:
            raise ValueError("forbidden_zero_bit set in NAL header")
        yield NalUnit(
            nal_ref_idc=(hdr >> 5) & 3,
            nal_unit_type=hdr & 0x1F,
            rbsp=ebsp_to_rbsp(ebsp[1:]),
        )


def write_nal(nal_ref_idc: int, nal_unit_type: int, rbsp: bytes,
              long_start_code: bool = True) -> bytes:
    """Serialize one NAL unit with an Annex-B start code."""
    hdr = bytes([((nal_ref_idc & 3) << 5) | (nal_unit_type & 0x1F)])
    sc = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return sc + rbsp_to_ebsp(hdr + rbsp)
