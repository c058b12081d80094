"""CAVLC residual block decode + encode (spec 9.2).

Reference parity: JM-lineage `read_comp_cavlc.c` / `vlc.c` (SURVEY.md §2;
implemented from spec 9.2.1-9.2.4).

decode_residual_block returns levels in SCAN order (caller applies the
inverse zig-zag).  The encode side exists for in-repo conformance-stream
synthesis and differential testing.
"""

from __future__ import annotations

from ..bitstream.bits import BitReader, BitWriter
from .cavlc_tables import (
    COEFF_TOKEN, COEFF_TOKEN_DEC, RUN_BEFORE, RUN_BEFORE_DEC,
    TOTAL_ZEROS_4x4, TOTAL_ZEROS_4x4_DEC,
    TOTAL_ZEROS_CHROMA_DC, TOTAL_ZEROS_CHROMA_DC_DEC,
)


def _nc_class(nc: int) -> int:
    if nc == -1:
        return 3
    if nc < 2:
        return 0
    if nc < 4:
        return 1
    if nc < 8:
        return 2
    return -1  # 6-bit FLC


def _read_vlc(r: BitReader, lut: dict, max_len: int = 16):
    code = ""
    for _ in range(max_len + 3):
        code += "1" if r.u1() else "0"
        if code in lut:
            return lut[code]
    raise ValueError(f"invalid VLC code {code!r}")


def decode_coeff_token(r: BitReader, nc: int) -> tuple[int, int]:
    cls = _nc_class(nc)
    if cls == -1:
        # nC >= 8: 6-bit FLC, value = 4*(TotalCoeff-1) + TrailingOnes, (0,0)=3
        v = r.u(6)
        if v == 3:
            return 0, 0
        return (v >> 2) + 1, v & 3
    return _read_vlc(r, COEFF_TOKEN_DEC[cls])


def encode_coeff_token(w: BitWriter, nc: int, total_coeff: int, trailing_ones: int) -> None:
    cls = _nc_class(nc)
    if cls == -1:
        v = 3 if total_coeff == 0 else (((total_coeff - 1) << 2) | trailing_ones)
        w.u(v, 6)
        return
    code = COEFF_TOKEN[cls][(total_coeff, trailing_ones)]
    w.u(int(code, 2), len(code))


def decode_residual_block(r: BitReader, nc: int, max_num_coeff: int) -> list[int]:
    """Decode one residual block (spec 9.2).

    Returns `max_num_coeff` levels in scan order (index 0 = DC/lowest freq).
    """
    total_coeff, trailing_ones = decode_coeff_token(r, nc)
    levels = [0] * max_num_coeff
    if total_coeff == 0:
        return levels

    # levels, highest frequency first
    lv = [0] * total_coeff
    for i in range(trailing_ones):
        lv[i] = -1 if r.u1() else 1

    suffix_length = 1 if (total_coeff > 10 and trailing_ones < 3) else 0
    for i in range(trailing_ones, total_coeff):
        # level_prefix (9.2.2.1)
        level_prefix = 0
        while r.u1() == 0:
            level_prefix += 1
            if level_prefix > 32:
                raise ValueError("invalid level_prefix")
        suffix_size = suffix_length
        if level_prefix == 14 and suffix_length == 0:
            suffix_size = 4
        elif level_prefix >= 15:
            suffix_size = level_prefix - 3
        level_code = (min(15, level_prefix) << suffix_length)
        if suffix_size:
            level_code += r.u(suffix_size)
        if level_prefix >= 15 and suffix_length == 0:
            level_code += 15
        if level_prefix >= 16:
            level_code += (1 << (level_prefix - 3)) - 4096
        if i == trailing_ones and trailing_ones < 3:
            level_code += 2
        lv[i] = (level_code + 2) >> 1 if level_code % 2 == 0 else -((level_code + 1) >> 1)
        if suffix_length == 0:
            suffix_length = 1
        if abs(lv[i]) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    # total_zeros
    if total_coeff < max_num_coeff:
        if max_num_coeff == 4:  # chroma DC 4:2:0
            total_zeros = _read_vlc(r, TOTAL_ZEROS_CHROMA_DC_DEC[total_coeff], 3)
        else:
            total_zeros = _read_vlc(r, TOTAL_ZEROS_4x4_DEC[total_coeff], 9)
    else:
        total_zeros = 0

    # run_before
    runs = [0] * total_coeff
    zeros_left = total_zeros
    for i in range(total_coeff - 1):
        if zeros_left > 0:
            runs[i] = _read_vlc(r, RUN_BEFORE_DEC[min(zeros_left, 7)], 11)
        zeros_left -= runs[i]
    runs[total_coeff - 1] = zeros_left

    # place levels: lv[0] is the highest-frequency coefficient
    pos = total_coeff + total_zeros - 1
    for i in range(total_coeff):
        levels[pos] = lv[i]
        pos -= runs[i] + 1
    return levels


def encode_residual_block(w: BitWriter, nc: int, levels: list[int],
                          max_num_coeff: int) -> tuple[int, int]:
    """Encode one residual block; `levels` in scan order, len == max_num_coeff.

    Returns (total_coeff, trailing_ones) for the caller's nC bookkeeping.
    """
    nz = [(i, v) for i, v in enumerate(levels[:max_num_coeff]) if v != 0]
    total_coeff = len(nz)
    # trailing ones: up to 3 consecutive |level|==1 at the end (highest freq)
    trailing_ones = 0
    for i in range(total_coeff - 1, -1, -1):
        if abs(nz[i][1]) == 1 and trailing_ones < 3:
            trailing_ones += 1
        else:
            break
    encode_coeff_token(w, nc, total_coeff, trailing_ones)
    if total_coeff == 0:
        return 0, 0

    # highest frequency first
    seq = nz[::-1]
    for i in range(trailing_ones):
        w.u(1 if seq[i][1] < 0 else 0, 1)
    suffix_length = 1 if (total_coeff > 10 and trailing_ones < 3) else 0
    for i in range(trailing_ones, total_coeff):
        level = seq[i][1]
        level_code = 2 * level - 2 if level > 0 else -2 * level - 1
        if i == trailing_ones and trailing_ones < 3:
            level_code -= 2
        if suffix_length == 0:
            if level_code < 14:
                w.u(1, level_code + 1)  # level_prefix = level_code, then stop bit
            elif level_code < 30:
                w.u(0, 14)
                w.u(1, 1)
                w.u(level_code - 14, 4)
            else:
                assert level_code - 30 < (1 << 12), "level too large for prefix-15 escape"
                w.u(0, 15)
                w.u(1, 1)
                w.u(level_code - 30, 12)
        else:
            if (level_code >> suffix_length) < 15:
                prefix = level_code >> suffix_length
                w.u(0, prefix)
                w.u(1, 1)
                w.u(level_code & ((1 << suffix_length) - 1), suffix_length)
            else:
                rem = level_code - (15 << suffix_length)
                assert rem < (1 << 12), "level too large for prefix-15 escape"
                w.u(0, 15)
                w.u(1, 1)
                w.u(rem, 12)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    total_zeros = nz[-1][0] + 1 - total_coeff
    if total_coeff < max_num_coeff:
        if max_num_coeff == 4:
            code = TOTAL_ZEROS_CHROMA_DC[total_coeff][total_zeros]
        else:
            code = TOTAL_ZEROS_4x4[total_coeff][total_zeros]
        w.u(int(code, 2), len(code))

    zeros_left = total_zeros
    for i in range(total_coeff - 1):
        if zeros_left <= 0:
            break
        run = seq[i][0] - seq[i + 1][0] - 1
        code = RUN_BEFORE[min(zeros_left, 7)][run]
        w.u(int(code, 2), len(code))
        zeros_left -= run
    return total_coeff, trailing_ones
