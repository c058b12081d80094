"""CABAC binary arithmetic decoding engine (spec 9.3.1, 9.3.3.2).

Reference parity: JM-lineage `biaridecod.c` / `context_ini.c` (SURVEY.md §2;
implemented from the spec clauses; context init tables extracted+validated in
cabac_init_tables.py, engine tables below are spec Tables 9-44/9-45 validated
end-to-end by stream conformance).
"""

from __future__ import annotations

import numpy as np

from ..bitstream.bits import BitReader
from .cabac_init_tables import INIT_I, INIT_PB

# Table 9-44: rangeTabLPS[pStateIdx][qCodIRangeIdx]
RANGE_TAB_LPS = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
], np.int32)

# Table 9-45: state transitions
TRANS_IDX_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
], np.int32)
TRANS_IDX_MPS = np.minimum(np.arange(64) + 1, 62).astype(np.int32)
TRANS_IDX_MPS[63] = 63


class CabacDecoder:
    """spec 9.3.1.2 (init) + 9.3.3.2 (decoding)."""

    __slots__ = ("r", "cod_range", "cod_offset", "state", "mps", "_log")

    def __init__(self, r: BitReader):
        r.align()
        self.r = r
        self.cod_range = 510
        self.cod_offset = r.u(9)
        self.state = np.zeros(1024, np.int32)
        self.mps = np.zeros(1024, np.int32)
        # SE tracing (bits.TracingBitReader): mute the raw renorm-bit log
        # and record per-bin ("cab", pos, ctx, bin) entries instead
        self._log = getattr(r, "log", None)
        if self._log is not None:
            r.mute = True

    def init_contexts(self, slice_qp: int, slice_type_i: bool,
                      cabac_init_idc: int) -> None:
        """spec 9.3.1.1 context initialization."""
        tab = INIT_I if slice_type_i else INIT_PB[cabac_init_idc]
        m = tab[:, 0].astype(np.int32)
        n = tab[:, 1].astype(np.int32)
        qp = max(0, min(51, slice_qp))
        pre = np.clip(((m * qp) >> 4) + n, 1, 126)
        self.mps = (pre > 63).astype(np.int32)
        self.state = np.where(pre <= 63, 63 - pre, pre - 64).astype(np.int32)

    def decision(self, ctx: int) -> int:
        if self._log is not None:
            p = self.r.pos
            bit = self._decision(ctx)
            self._log.append(("cab", p, ctx, bit))
            return bit
        return self._decision(ctx)

    def _decision(self, ctx: int) -> int:
        """decodeDecision (9.3.3.2.1) + renorm (9.3.3.2.2)."""
        state = int(self.state[ctx])
        q = (self.cod_range >> 6) & 3
        lps = int(RANGE_TAB_LPS[state, q])
        self.cod_range -= lps
        if self.cod_offset >= self.cod_range:
            bit = 1 - int(self.mps[ctx])
            self.cod_offset -= self.cod_range
            self.cod_range = lps
            if state == 0:
                self.mps[ctx] = 1 - self.mps[ctx]
            self.state[ctx] = TRANS_IDX_LPS[state]
        else:
            bit = int(self.mps[ctx])
            self.state[ctx] = TRANS_IDX_MPS[state]
        # renormalize
        while self.cod_range < 256:
            self.cod_range <<= 1
            self.cod_offset = (self.cod_offset << 1) | self.r.u1()
        return bit

    def bypass(self) -> int:
        """decodeBypass (9.3.3.2.3)."""
        p = self.r.pos
        self.cod_offset = (self.cod_offset << 1) | self.r.u1()
        if self.cod_offset >= self.cod_range:
            self.cod_offset -= self.cod_range
            bit = 1
        else:
            bit = 0
        if self._log is not None:
            self._log.append(("cby", p, -1, bit))
        return bit

    def terminate(self) -> int:
        """decodeTerminate (9.3.3.2.4)."""
        self.cod_range -= 2
        if self.cod_offset >= self.cod_range:
            return 1
        while self.cod_range < 256:
            self.cod_range <<= 1
            self.cod_offset = (self.cod_offset << 1) | self.r.u1()
        return 0

    def flush(self) -> None:
        """Position the bitreader for the I_PCM payload.

        After the mb_type terminate bin decodes 1 WITHOUT renormalization
        (9.3.3.2.4 binVal=1), the engine's last-read bit is one past the
        end of the CABAC-coded data; pcm_alignment_zero_bit byte-aligns
        from there.  (A renormalizing DecodeFlush here consumed 7 extra
        bits and started the PCM read up to a byte late — caught by the
        lossless-CABAC conformance streams, where x264 emits I_PCM.)
        Verified bit-exact vs libavcodec; the caller byte-aligns."""
        self.r.pos -= 1

    def reinit(self) -> None:
        """Re-initialize the engine after PCM samples (9.3.1.2); context
        states persist."""
        self.r.align()
        self.cod_range = 510
        self.cod_offset = self.r.u(9)

    # ---- binarization helpers --------------------------------------------

    def unary(self, ctx_fn, c_max: int | None = None) -> int:
        """Unary / truncated-unary; ctx_fn(bin_idx) -> ctx index."""
        k = 0
        while True:
            if c_max is not None and k >= c_max:
                return k
            if not self.decision(ctx_fn(k)):
                return k
            k += 1
            if k > 2048:
                raise ValueError("runaway unary")

    def expgolomb_bypass(self, k: int) -> int:
        """EGk suffix via bypass bins (spec 9.3.2.3 UEGk suffix part)."""
        v = 0
        while self.bypass():
            v += 1 << k
            k += 1
            if k > 32:
                raise ValueError("runaway EGk")
        while k > 0:
            k -= 1
            if self.bypass():
                v += 1 << k
        return v
