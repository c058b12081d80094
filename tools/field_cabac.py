"""CABAC High-profile PAFF (all-field) streams: the 1080i25 HD broadcast
format of ETSI TS 101 154 (High profile, Level 4.0, 1920x1080
interlaced) coded as field pictures, and small streams of the same
syntax for the CPU tests.

    python tools/field_cabac.py [NAME ...]

writes tests/data/NAME.264 and tests/data/NAME.json for each NAME of
STREAMS (all by default).  The JSON holds the MD5 of every frame of
libavcodec's decode in output order (a woven field pair a frame), the
structure (one letter a field, decode order), the bit rate, the count of
every syntax kind written and the call that made the stream; it needs
the system libavcodec through tools/h264ref, and fails if libavcodec
prints any message while decoding.

x264 cannot emit PAFF (its interlaced mode is MBAFF), so the syntax is
written here, as tools/field_smoke.py writes its CAVLC streams, but the
slice data goes through the arithmetic encoder of the spec's clause
9.3.4.2 (`CabacEncoder`), with the binarisation (9.3.2) and the context
index increments (9.3.3.1.1, 9.3.3.1.3, field-coded ranges) of each
syntax element written (`FieldSlice`).  Each field is one slice, top
field first; the SPS has frame_mbs_only_flag 0, no MBAFF,
direct_8x8_inference_flag 1 and 2 reference frames, the PPS CABAC and
the 8x8 transform.  A field codes, from the stream's seed:

- I fields: Intra16x16 (every prediction mode its neighbours allow, DC
  and AC levels) and I_NxN with transform_size_8x8_flag 1 (Intra 8x8
  modes through prev_intra8x8_pred_mode_flag / rem_intra8x8_pred_mode);
- P fields: P_L0_16x16 with ref_idx 0 and 1 (the same and the other
  parity), P_Skip and intra MBs;
- B fields (non-reference pairs, spatial direct): B_L0/B_L1/B_Bi_16x16,
  B_Skip, B_Direct_16x16 and intra MBs;
- residual: 4x4 and 8x8 luma (8x8 in inter MBs with the transform flag
  set), chroma DC and AC, mb_qp_delta not always 0, end_of_slice_flag.

Levels fall off with the scan position (mostly 1, now and then one past
the prefix's 14 bins), so the content stays smooth enough for the
deblocking filter to work on most edges; the coefficient density of each
picture kind sets the bit rate (`Recipe`).  An MB whose levels would take
a scaled coefficient or a transform intermediate past 16 bits, which a
conforming stream may not (8.5.10-8.5.13), has them cut down (`_fits`).
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from collections import Counter
from dataclasses import dataclass
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from arrow_h264_tpu_torch.bitstream.bits import BitWriter  # noqa: E402
from arrow_h264_tpu_torch.bitstream.params import (  # noqa: E402
    PPS, write_pps, write_sps,
)
from arrow_h264_tpu_torch.bitstream.slicehdr import (  # noqa: E402
    write_slice_header,
)
from arrow_h264_tpu_torch.common.tables import (  # noqa: E402
    BLK4_X, BLK4_Y, CHROMA_QP_TABLE, FIELD_SCAN_4x4, FIELD_SCAN_8x8,
    NORM_ADJUST_4x4, NORM_ADJUST_8x8,
)
from arrow_h264_tpu_torch.entropy.cabac import (  # noqa: E402
    RANGE_TAB_LPS, TRANS_IDX_LPS, TRANS_IDX_MPS,
)
from arrow_h264_tpu_torch.entropy.cabac_init_tables import (  # noqa: E402
    INIT_I, INIT_PB,
)
from arrow_h264_tpu_torch.mb.cabac_parse import (  # noqa: E402
    ABS_CAT_OFF, LAST8x8, SIG8x8_FIELD, SIG_CAT_OFF,
)
from tools.field_smoke import SLICE_TYPE, _pairs  # noqa: E402
from tools.field_streams import _field_hdr, field_sps  # noqa: E402
from tools.fmo_streams import _nal  # noqa: E402

DATA = REPO / "tests" / "data"


# ---- the arithmetic encoder (spec 9.3.4.2) ---------------------------------

class CabacEncoder:
    """Binary arithmetic encoder of one slice: contexts initialised as
    9.3.1.1 does for the slice's QP and type, bins encoded by
    EncodeDecision, EncodeBypass and EncodeTerminate (9.3.4.2-9.3.4.5)."""

    def __init__(self, slice_qp: int, slice_i: bool):
        # cabac_init_idc 0, as the slice headers write it
        tab = (INIT_I if slice_i else INIT_PB[0]).astype(int)
        qp = max(0, min(51, slice_qp))
        pre = np.clip(((tab[:, 0] * qp) >> 4) + tab[:, 1], 1, 126)
        self.mps = (pre > 63).astype(int).tolist()
        self.state = np.where(pre <= 63, 63 - pre, pre - 64).tolist()
        self.low, self.range = 0, 510
        self.outstanding, self.first = 0, True
        self.bits = bytearray()             # one bit a byte

    def _put(self, b: int) -> None:
        if self.first:
            self.first = False
        else:
            self.bits.append(b)
        if self.outstanding:
            self.bits.extend([1 - b] * self.outstanding)
            self.outstanding = 0

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: int, b: int) -> None:
        s = self.state[ctx]
        lps = int(RANGE_TAB_LPS[s, (self.range >> 6) & 3])
        self.range -= lps
        if b != self.mps[ctx]:
            self.low += self.range
            self.range = lps
            if s == 0:
                self.mps[ctx] = 1 - self.mps[ctx]
            self.state[ctx] = int(TRANS_IDX_LPS[s])
        else:
            self.state[ctx] = int(TRANS_IDX_MPS[s])
        self._renorm()

    def bypass(self, b: int) -> None:
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, b: int) -> None:
        """end_of_slice_flag, or the I_PCM bin of mb_type; b = 1 flushes
        (9.3.4.5): its last bit written is the rbsp_stop_one_bit."""
        self.range -= 2
        if not b:
            self._renorm()
            return
        self.low += self.range
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        v = ((self.low >> 7) & 3) | 1
        self.bits.extend((v >> 1, v & 1))

    def eg_bypass(self, v: int, k: int) -> None:
        """The k-th order Exp-Golomb suffix of a UEGk bin string (9.3.2.3)."""
        while v >= 1 << k:
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        while k:
            k -= 1
            self.bypass((v >> k) & 1)

    def data(self) -> bytes:
        """The slice data after the flush, zero-padded to a byte."""
        bits = np.frombuffer(bytes(self.bits), np.uint8)
        return np.packbits(bits).tobytes()


# ---- a macroblock as written ------------------------------------------------

class Mb:
    """One MB's syntax values and what its neighbours read of it.  kind:
    "I16", "I8" (I_NxN, 8x8 transform), "P" (P_L0_16x16), "B" (B_L0/L1/
    Bi_16x16 by `ref`), "PSKIP", "BSKIP", "BDIRECT"."""

    __slots__ = ("kind", "t8", "cbp_l", "cbp_c", "cmode", "i16", "i8",
                 "ref", "mvd", "dqp", "dc", "ac", "l4", "l8", "cdc", "cac",
                 "cbf4", "cbf_dc", "cbf_cdc", "cbf_cac")

    def __init__(self, kind: str):
        self.kind = kind
        self.t8 = self.cbp_l = self.cbp_c = self.cmode = self.i16 = 0
        self.dqp = 0
        self.i8 = None
        self.ref = [-1, -1]
        self.mvd = [[0, 0], [0, 0]]
        self.dc = self.cdc = None
        self.ac, self.l4, self.l8, self.cac = {}, {}, {}, {}
        self.cbf4 = [0] * 16            # raster 4x4 cells of the MB
        self.cbf_dc = 0
        self.cbf_cdc = [0, 0]
        self.cbf_cac = [[0] * 4, [0] * 4]

    @property
    def skip(self) -> bool:
        return self.kind in ("PSKIP", "BSKIP")

    @property
    def intra(self) -> bool:
        return self.kind in ("I16", "I8")

    @property
    def direct(self) -> bool:
        return self.kind in ("BSKIP", "BDIRECT")


# ---- the slice data writer -------------------------------------------------

class FieldSlice:
    """Writes one field picture's slice data MB by MB with `CabacEncoder`,
    keeping what the context selection reads of earlier MBs.  kind: the
    slice type letter; `counts` tallies every syntax kind written."""

    def __init__(self, mb_w: int, mb_h: int, kind: str, slice_qp: int,
                 n_ref: tuple):
        self.w, self.h, self.kind = mb_w, mb_h, kind
        self.n_ref = n_ref
        self.enc = CabacEncoder(slice_qp, kind == "I")
        self.mbs: list = [None] * (mb_w * mb_h)
        self.prev_dqp = 0
        self.counts: Counter = Counter()

    # -- neighbour reads (one slice a picture: available = inside it) --

    def _nb(self, addr: int):
        mx, my = addr % self.w, addr // self.w
        return (self.mbs[addr - 1] if mx else None,
                self.mbs[addr - self.w] if my else None)

    def _cell4(self, mb, a, b, x, y):
        """The MB and raster cell of luma 4x4 cell (x, y) of `mb`'s grid
        (-1: the left or top neighbour's)."""
        if x < 0:
            return a, 3, y
        if y < 0:
            return b, x, 3
        return mb, x, y

    def _cbf4_cond(self, n, x: int, y: int, intra: bool) -> int:
        """condTermFlagN of a luma 4x4 block's coded_block_flag (cat 1,
        2) at cell (x, y) of MB n (9.3.3.1.1.9)."""
        if n is None:
            return int(intra)
        if n.skip or not (n.cbp_l >> ((y >> 1) * 2 + (x >> 1))) & 1:
            return 0
        return 1 if n.t8 else n.cbf4[y * 4 + x]

    def _cac_cond(self, n, pl: int, x: int, y: int, intra: bool) -> int:
        if n is None:
            return int(intra)
        if n.skip or n.cbp_c != 2:
            return 0
        return n.cbf_cac[pl][y * 2 + x]

    # -- syntax elements --

    def _unary(self, v: int, ctx0: int, ctx1: int, ctx2: int) -> None:
        """Unary bins of v: bin 0 at ctx0, bin 1 at ctx1, later at ctx2."""
        e = self.enc
        e.decision(ctx0, int(v > 0))
        for k in range(1, v + 1):
            e.decision(ctx1 if k == 1 else ctx2, int(k < v))

    def _i16_suffix(self, mb, ctx) -> None:
        """The I mb_type bins after I_NxN's: not I_PCM, then the 16x16
        type's luma cbp, chroma cbp and prediction mode (Table 9-36)."""
        e = self.enc
        e.terminate(0)
        e.decision(ctx[0], int(mb.cbp_l != 0))
        e.decision(ctx[1], int(mb.cbp_c != 0))
        if mb.cbp_c:
            e.decision(ctx[2], int(mb.cbp_c == 2))
        e.decision(ctx[3], mb.i16 >> 1)
        e.decision(ctx[4], mb.i16 & 1)

    def _mb_type(self, mb, a, b) -> None:
        e = self.enc
        if self.kind == "I":
            inc = sum(n is not None and n.kind != "I8" for n in (a, b))
            e.decision(3 + inc, int(mb.kind == "I16"))
            if mb.kind == "I16":
                self._i16_suffix(mb, (6, 7, 8, 9, 10))
        elif self.kind == "P":
            e.decision(14, int(mb.intra))
            if mb.intra:
                e.decision(17, int(mb.kind == "I16"))
                if mb.kind == "I16":
                    self._i16_suffix(mb, (18, 19, 19, 20, 20))
            else:
                e.decision(15, 0)
                e.decision(16, 0)              # P_L0_16x16
        else:
            inc = sum(n is not None and not n.direct for n in (a, b))
            e.decision(27 + inc, int(mb.kind != "BDIRECT"))
            if mb.kind == "BDIRECT":
                return
            if mb.intra:                       # prefix 1 1 1 1 0 1
                for ctx, bit in ((30, 1), (31, 1), (32, 1), (32, 0),
                                 (32, 1)):
                    e.decision(ctx, bit)
                e.decision(32, int(mb.kind == "I16"))
                if mb.kind == "I16":
                    self._i16_suffix(mb, (33, 34, 34, 35, 35))
            elif mb.ref[0] >= 0 and mb.ref[1] >= 0:   # B_Bi_16x16
                for ctx, bit in ((30, 1), (31, 0), (32, 0), (32, 0),
                                 (32, 0)):
                    e.decision(ctx, bit)
            else:                                     # B_L0 / B_L1_16x16
                e.decision(30, 0)
                e.decision(32, int(mb.ref[1] >= 0))

    def _pred8(self, mb, a, b, blk: int) -> int:
        """predIntra8x8PredMode of 8x8 block blk (8.3.2.1)."""
        def mode(n, k):
            return n.i8[k] if n.kind == "I8" else 2
        x8, y8 = blk & 1, blk >> 1
        na = (mb, blk - 1) if x8 else (a, blk + 1)
        nb = (mb, blk - 2) if y8 else (b, blk + 2)
        if na[0] is None or nb[0] is None:
            return 2
        return min(mode(*na), mode(*nb))

    def _intra_pred(self, mb, a, b) -> None:
        e = self.enc
        if mb.kind == "I8":
            e.decision(399 + sum(n is not None and n.t8 for n in (a, b)), 1)
            for blk in range(4):
                pred, m = self._pred8(mb, a, b, blk), mb.i8[blk]
                e.decision(68, int(m == pred))
                if m != pred:
                    rem = m if m < pred else m - 1
                    for k in range(3):
                        e.decision(69, (rem >> k) & 1)
                    self.counts["rem_intra8x8_pred_mode"] += 1
                else:
                    self.counts["prev_intra8x8_pred_mode"] += 1
        inc = sum(n is not None and n.intra and n.cmode != 0 for n in (a, b))
        e.decision(64 + inc, int(mb.cmode != 0))
        if mb.cmode:
            e.decision(67, int(mb.cmode > 1))
            if mb.cmode > 1:
                e.decision(67, int(mb.cmode > 2))

    def _ref_idx(self, mb, a, b, lst: int) -> None:
        def cond(n):
            return int(n is not None and not n.skip and not n.intra and
                       not n.direct and n.ref[lst] > 0)
        r = mb.ref[lst]
        self._unary(r, 54 + cond(a) + 2 * cond(b), 58, 59)
        self.counts[f"ref_idx_l{lst}={r}"] += 1

    def _mvd(self, mb, a, b, lst: int, comp: int) -> None:
        e = self.enc

        def absmvd(n):
            if n is None or n.skip or n.intra or n.direct or n.ref[lst] < 0:
                return 0
            return abs(n.mvd[lst][comp])
        s = absmvd(a) + absmvd(b)
        base = 40 if comp == 0 else 47
        v = mb.mvd[lst][comp]
        u = abs(v)
        e.decision(base + (0 if s < 3 else 1 if s <= 32 else 2), int(u > 0))
        if not u:
            return
        for k in range(1, min(u, 9)):
            e.decision(base + 3 + min(k - 1, 3), 1)
        if u < 9:
            e.decision(base + 3 + min(u - 1, 3), 0)
        else:
            e.eg_bypass(u - 9, 3)
            self.counts["mvd_suffix"] += 1
        e.bypass(int(v < 0))

    def _cbp(self, mb, a, b) -> None:
        e = self.enc

        def lbit(n, b8):               # 1: condTermFlagN 0
            if n is None:
                return 1
            return 0 if n.skip else (n.cbp_l >> b8) & 1
        for b8 in range(4):
            x8, y8 = b8 & 1, b8 >> 1
            ba = (mb.cbp_l >> (b8 - 1)) & 1 if x8 else lbit(a, b8 + 1)
            bb = (mb.cbp_l >> (b8 - 2)) & 1 if y8 else lbit(b, b8 + 2)
            e.decision(73 + (1 - ba) + 2 * (1 - bb), (mb.cbp_l >> b8) & 1)

        def cval(n):
            return 0 if n is None or n.skip else n.cbp_c
        ca, cb = cval(a), cval(b)
        e.decision(77 + (ca != 0) + 2 * (cb != 0), int(mb.cbp_c != 0))
        if mb.cbp_c:
            e.decision(81 + (ca == 2) + 2 * (cb == 2), int(mb.cbp_c == 2))

    def _dqp(self, mb) -> None:
        v = 2 * mb.dqp - 1 if mb.dqp > 0 else -2 * mb.dqp
        self._unary(v, 60 + (self.prev_dqp != 0), 62, 63)
        self.prev_dqp = mb.dqp
        if mb.dqp:
            self.counts["mb_qp_delta!=0"] += 1

    def _block(self, cat: int, levels) -> None:
        """residual_block_cabac of one coded block (coded_block_flag
        written by the caller), levels in scan order."""
        e = self.enc
        n = len(levels)
        if cat == 5:
            sig_base, last_base = 436, 451
            abs_base = 426
        else:
            sig_base = 277 + SIG_CAT_OFF[cat]
            last_base = 338 + SIG_CAT_OFF[cat]
            abs_base = 227 + ABS_CAT_OFF[cat]
        nz = [i for i, v in enumerate(levels) if v]
        last = nz[-1]
        for i in range(n - 1):
            if cat == 5:
                s_inc, l_inc = SIG8x8_FIELD[i], LAST8x8[i]
            elif cat == 3:
                s_inc = l_inc = min(i, 2)
            else:
                s_inc = l_inc = i
            sig = int(levels[i] != 0)
            e.decision(sig_base + s_inc, sig)
            if sig:
                e.decision(last_base + l_inc, int(i == last))
                if i == last:
                    break
        eq1 = gt1 = 0
        for i in reversed(nz):
            v = abs(int(levels[i])) - 1
            e.decision(abs_base + (0 if gt1 else min(4, 1 + eq1)), int(v > 0))
            if v:
                ctx = abs_base + 5 + min(4 - (cat == 3), gt1)
                for _ in range(1, min(v, 14)):
                    e.decision(ctx, 1)
                if v < 14:
                    e.decision(ctx, 0)
                else:
                    e.eg_bypass(v - 14, 0)
                    self.counts["coeff_abs_level_suffix"] += 1
                gt1 += 1
            else:
                eq1 += 1
            e.bypass(int(levels[i] < 0))

    def _residual(self, mb, a, b) -> None:
        e = self.enc
        intra = mb.intra
        if mb.kind == "I16":
            def dc_cond(n):
                if n is None:
                    return 1
                return n.cbf_dc if n.kind == "I16" else 0
            mb.cbf_dc = int(any(mb.dc))
            e.decision(85 + dc_cond(a) + 2 * dc_cond(b), mb.cbf_dc)
            if mb.cbf_dc:
                self._block(0, mb.dc)
                self.counts["luma_dc"] += 1
        cat = 1 if mb.kind == "I16" else 2
        for i8 in range(4):
            if not (mb.cbp_l >> i8) & 1:
                continue
            if mb.t8:
                self._block(5, mb.l8[i8])
                self.counts["luma8x8"] += 1
                continue
            for blk in range(4 * i8, 4 * i8 + 4):
                x, y = BLK4_X[blk], BLK4_Y[blk]
                levels = (mb.ac if cat == 1 else mb.l4)[blk]
                na = self._cell4(mb, a, b, x - 1, y)
                nb = self._cell4(mb, a, b, x, y - 1)
                inc = self._cbf4_cond(*na, intra) + \
                    2 * self._cbf4_cond(*nb, intra)
                cbf = int(any(levels))
                e.decision(85 + 4 * cat + inc, cbf)
                mb.cbf4[y * 4 + x] = cbf
                if cbf:
                    self._block(cat, levels)
                    self.counts["luma_ac" if cat == 1 else "luma4x4"] += 1
        if not mb.cbp_c:
            return
        for pl in range(2):
            def cdc_cond(n):
                if n is None:
                    return int(intra)
                return 0 if n.skip or not n.cbp_c else n.cbf_cdc[pl]
            cbf = int(any(mb.cdc[pl]))
            e.decision(97 + cdc_cond(a) + 2 * cdc_cond(b), cbf)
            mb.cbf_cdc[pl] = cbf
            if cbf:
                self._block(3, mb.cdc[pl])
                self.counts["chroma_dc"] += 1
        if mb.cbp_c != 2:
            return
        for pl in range(2):
            for blk in range(4):
                x, y = blk & 1, blk >> 1
                na = (mb, x - 1, y) if x else (a, 1, y)
                nb = (mb, x, y - 1) if y else (b, x, 1)
                inc = self._cac_cond(na[0], pl, na[1], na[2], intra) + \
                    2 * self._cac_cond(nb[0], pl, nb[1], nb[2], intra)
                cbf = int(any(mb.cac[pl][blk]))
                e.decision(101 + inc, cbf)
                mb.cbf_cac[pl][blk] = cbf
                if cbf:
                    self._block(4, mb.cac[pl][blk])
                    self.counts["chroma_ac"] += 1

    # -- one MB --

    def write(self, addr: int, mb: Mb) -> None:
        """mb_skip_flag, macroblock_layer() and end_of_slice_flag of MB
        `addr`, in decoding order."""
        e = self.enc
        a, b = self._nb(addr)
        self.mbs[addr] = mb
        self.counts[mb.kind] += 1
        if self.kind != "I":
            inc = sum(n is not None and not n.skip for n in (a, b))
            e.decision((11 if self.kind == "P" else 24) + inc, int(mb.skip))
        if mb.skip:
            self.prev_dqp = 0
        else:
            self._mb_type(mb, a, b)
            if mb.intra:
                self._intra_pred(mb, a, b)
            elif mb.kind != "BDIRECT":
                for lst in range(2):
                    if mb.ref[lst] >= 0 and self.n_ref[lst] > 1:
                        self._ref_idx(mb, a, b, lst)
                for lst in range(2):
                    if mb.ref[lst] >= 0:
                        self._mvd(mb, a, b, lst, 0)
                        self._mvd(mb, a, b, lst, 1)
            if mb.kind != "I16":
                self._cbp(mb, a, b)
                if mb.cbp_l and not mb.intra:
                    e.decision(399 + sum(n is not None and n.t8
                                         for n in (a, b)), mb.t8)
                    if mb.t8:
                        self.counts["transform_size_8x8_flag(inter)"] += 1
            if mb.cbp_l or mb.cbp_c or mb.kind == "I16":
                self._dqp(mb)
                self._residual(mb, a, b)
            else:
                self.prev_dqp = 0
        e.terminate(int(addr == self.w * self.h - 1))


# ---- content ---------------------------------------------------------------

@dataclass(frozen=True)
class Recipe:
    """How a stream's MBs are drawn.  Per picture kind ("I", "P", "B"):
    `mix`, the MB kinds' weights; `coef`, the mean count of levels in a
    coded 4x4 (16 for 8x8) block; `cbp`, the chance that an 8x8 luma
    quadrant is coded; `chroma`, the weights of cbp_chroma 0, 1 and 2."""
    mix: dict
    coef: dict
    cbp: dict
    chroma: dict
    dqp: float = 0.08          # chance of an mb_qp_delta other than 0
    big_level: float = 0.01    # chance of a level past the 14-bin prefix
    big_mvd: float = 0.02      # chance of an mvd past the 9-bin prefix


BROADCAST = Recipe(
    mix={"I": {"I16": 0.35, "I8": 0.65},
         "P": {"P": 0.78, "PSKIP": 0.14, "I16": 0.03, "I8": 0.05},
         "B": {"B": 0.46, "BSKIP": 0.34, "BDIRECT": 0.16, "I16": 0.015,
               "I8": 0.025}},
    coef={"I": 1.4, "P": 0.9, "B": 0.8},
    cbp={"I": 0.9, "P": 0.4, "B": 0.15},
    chroma={"I": (0.2, 0.3, 0.5), "P": (0.55, 0.25, 0.2),
            "B": (0.75, 0.15, 0.1)})


def _levels(rng, n: int, mean: float, big: float) -> list:
    """Scan-order levels of one coded block: at least one, more near the
    start of the scan, mostly +-1."""
    k = min(n, 1 + int(rng.poisson(max(0.0, mean - 1))))
    pos = np.unique(np.minimum(rng.geometric(min(1.0, 2.5 / n), k) - 1,
                               n - 1))
    out = [0] * n
    for p in pos:
        u = rng.random()
        mag = 1 if u < 0.72 else 2 if u < 0.9 else int(rng.integers(3, 7))
        if rng.random() < big:
            mag = int(rng.integers(15, 40))
        out[int(p)] = mag if rng.random() < 0.5 else -mag
    return out


# ---- the spec's range of the inverse transforms -----------------------------
#
# A conforming stream keeps every scaled coefficient and every intermediate
# of the inverse transforms within 16 bits at 8-bit depth (8.5.10-8.5.13):
# libavcodec stores the scaled coefficients as int16, so a level that
# breaks the range decodes differently there.  `_fits` computes them all;
# the orientation of a block is taken both ways, which needs no scan
# convention and can only be stricter than the spec.

LIMIT = 1 << 15
HADAMARD4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1],
                      [1, -1, 1, -1]], np.int64)


def _stage4(d):
    """The 4-point inverse transform of 8.5.12.2 along the last axis:
    its intermediates and its output."""
    d0, d1, d2, d3 = np.moveaxis(d, -1, 0)
    e = np.stack((d0 + d2, d0 - d2, (d1 >> 1) - d3, d1 + (d3 >> 1)), -1)
    e0, e1, e2, e3 = np.moveaxis(e, -1, 0)
    return (e,), np.stack((e0 + e3, e1 + e2, e1 - e2, e0 - e3), -1)


def _stage8(d):
    """The 8-point inverse transform of 8.5.13.2 along the last axis."""
    d0, d1, d2, d3, d4, d5, d6, d7 = np.moveaxis(d, -1, 0)
    a0, a4 = d0 + d4, d0 - d4
    a2, a6 = (d2 >> 1) - d6, d2 + (d6 >> 1)
    b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
    a1 = -d3 + d5 - d7 - (d7 >> 1)
    a3 = d1 + d7 - d3 - (d3 >> 1)
    a5 = -d1 + d7 + d5 + (d5 >> 1)
    a7 = d3 + d5 + d1 + (d1 >> 1)
    b1, b7 = a1 + (a7 >> 2), a7 - (a1 >> 2)
    b3, b5 = a3 + (a5 >> 2), (a3 >> 2) - a5
    mid = np.stack((a0, a1, a2, a3, a4, a5, a6, a7, b0, b1, b2, b3, b4,
                    b5, b6, b7), -1)
    return (mid,), np.stack((b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1,
                             b4 - b3, b2 - b5, b0 - b7), -1)


def _in_range(*arrays) -> bool:
    return all(-LIMIT <= int(a.min()) and int(a.max()) < LIMIT
               for a in arrays)


def _transform_fits(d, stage) -> bool:
    """d (scaled) and the intermediates of its row then column transform,
    for d and its transpose."""
    for m in (d, d.T):
        inner, f = stage(m)
        inner2, h = stage(f.T)
        if not _in_range(m, *inner, f, *inner2, h):
            return False
    return True


def _scaled4(c, qp: int, dc=None):
    """8.5.12.1 with flat scaling lists; dc: the block's DC, already
    scaled by the DC transform."""
    ls = 16 * NORM_ADJUST_4x4[qp % 6].astype(np.int64)
    k = qp // 6
    d = (c * ls) << (k - 4) if k >= 4 else \
        (c * ls + (1 << (3 - k))) >> (4 - k)
    if dc is not None:
        d[0, 0] = dc
    return d


def _scaled8(c, qp: int):
    ls = 16 * NORM_ADJUST_8x8[qp % 6].astype(np.int64)
    k = qp // 6
    return (c * ls) << (k - 6) if k >= 6 else \
        (c * ls + (1 << (5 - k))) >> (6 - k)


def _raster(levels, scan, start: int, n: int):
    """The n x n coefficient block of scan-order `levels` from scan
    position `start` on (1 for AC blocks)."""
    c = np.zeros(n * n, np.int64)
    for k, v in enumerate(levels):
        c[scan[start + k]] = v
    return c.reshape(n, n)


def _fits(mb: Mb, qp: int) -> bool:
    """Every scaled coefficient and transform intermediate of the MB's
    residual, at luma QP `qp`, within the 16-bit range."""
    if mb.kind == "I16":
        c = _raster(mb.dc, FIELD_SCAN_4x4, 0, 4)
        hc = HADAMARD4 @ c
        f = hc @ HADAMARD4
        ls, k = 16 * int(NORM_ADJUST_4x4[qp % 6, 0, 0]), qp // 6
        dc = (f * ls) << (k - 6) if k >= 6 else \
            (f * ls + (1 << (5 - k))) >> (6 - k)
        if not _in_range(hc, f, dc):
            return False
        for blk, levels in mb.ac.items():
            x, y = BLK4_X[blk], BLK4_Y[blk]
            c = _raster(levels, FIELD_SCAN_4x4, 1, 4)
            if not all(_transform_fits(_scaled4(c, qp, v), _stage4)
                       for v in {int(dc[y, x]), int(dc[x, y])}):
                return False
    for levels in mb.l4.values():
        if not _transform_fits(
                _scaled4(_raster(levels, FIELD_SCAN_4x4, 0, 4), qp),
                _stage4):
            return False
    for levels in mb.l8.values():
        if not _transform_fits(
                _scaled8(_raster(levels, FIELD_SCAN_8x8, 0, 8), qp),
                _stage8):
            return False
    if mb.cbp_c:
        qpc = int(CHROMA_QP_TABLE[qp])
        ls, k = 16 * int(NORM_ADJUST_4x4[qpc % 6, 0, 0]), qpc // 6
        for pl in range(2):
            c = np.array(mb.cdc[pl], np.int64).reshape(2, 2)
            hc = np.array([[1, 1], [1, -1]], np.int64) @ c
            f = hc @ np.array([[1, 1], [1, -1]], np.int64)
            dc = ((f * ls) << k) >> 5
            if not _in_range(hc, f, dc):
                return False
            if mb.cbp_c == 2:
                for blk, levels in enumerate(mb.cac[pl]):
                    c = _raster(levels, FIELD_SCAN_4x4, 1, 4)
                    if not _transform_fits(
                            _scaled4(c, qpc, int(dc[blk >> 1, blk & 1])),
                            _stage4):
                        return False
    return True


def _modes(x: int, y: int, left: bool, top: bool, kinds: tuple) -> list:
    """The prediction modes of `kinds` whose neighbours exist: each mode's
    needs (l left, t top, c the corner)."""
    have = {"l": left, "t": top, "c": left and top}
    return [m for m, need in kinds if all(have[c] for c in need)]


I16_MODES = ((0, "t"), (1, "l"), (2, ""), (3, "ltc"))
I8_MODES = ((0, "t"), (1, "l"), (2, ""), (3, "t"), (4, "ltc"), (5, "ltc"),
            (6, "ltc"), (7, "t"), (8, "l"))
CHROMA_MODES = ((0, ""), (1, "l"), (2, "t"), (3, "ltc"))


def draw_mb(rng, pic: str, mx: int, my: int,
            qp: int, qp0: int) -> Mb:
    """One MB of a `pic` field at (mx, my), its QP delta kept within 3 of
    the slice's qp0 (qp: the QP it predicts from)."""
    recipe = BROADCAST
    mix = recipe.mix[pic]
    kinds = list(mix)
    p = np.array([mix[k] for k in kinds])
    kind = kinds[int(rng.choice(len(kinds), p=p / p.sum()))]
    mb = Mb(kind)
    if mb.skip:
        return mb
    coef, q_cbp = recipe.coef[pic], recipe.cbp[pic]
    big = recipe.big_level
    if kind == "I16":
        mb.i16 = int(rng.choice(_modes(mx, my, mx > 0, my > 0, I16_MODES)))
        mb.cbp_l = 15 if rng.random() < q_cbp / 2 else 0
        mb.dc = _levels(rng, 16, coef + 1, big) if rng.random() < 0.9 \
            else [0] * 16
        if mb.cbp_l:
            mb.ac = {blk: (_levels(rng, 15, coef / 2, big)
                           if rng.random() < 0.6 else [0] * 15)
                     for blk in range(16)}
    elif kind == "I8":
        mb.t8 = 1
        mb.i8 = [int(rng.choice(_modes(0, 0, mx > 0 or blk & 1,
                                       my > 0 or blk >> 1, I8_MODES)))
                 for blk in range(4)]
    elif kind == "P":
        mb.ref = [int(rng.integers(0, 2)), -1]
    elif kind == "B":
        lists = (0, 1, 2)[int(rng.integers(0, 3))]
        mb.ref = [int(rng.integers(0, 2)) if lists != 1 else -1,
                  int(rng.integers(0, 2)) if lists != 0 else -1]
    for lst in range(2):
        if mb.ref[lst] >= 0:
            for c in range(2):
                v = int(rng.integers(-3, 4)) if c == 0 else \
                    int(rng.integers(-4, 5))
                if rng.random() < recipe.big_mvd:
                    v = int(rng.integers(9, 24)) * (1 if rng.random() < 0.5
                                                    else -1)
                mb.mvd[lst][c] = v
    if mb.intra:
        mb.cmode = int(rng.choice(_modes(mx, my, mx > 0, my > 0,
                                         CHROMA_MODES)))
    if kind != "I16":
        mb.cbp_l = sum(1 << b8 for b8 in range(4) if rng.random() < q_cbp)
        if mb.cbp_l and kind != "I8":
            mb.t8 = int(rng.random() < 0.5)
        if kind == "I8" or mb.t8:
            mb.l8 = {b8: _levels(rng, 64, 4 * coef, big) for b8 in range(4)
                     if (mb.cbp_l >> b8) & 1}
        else:
            mb.t8 = 0
            for b8 in range(4):
                if (mb.cbp_l >> b8) & 1:
                    live = int(rng.integers(0, 4))
                    for blk in range(4 * b8, 4 * b8 + 4):
                        mb.l4[blk] = _levels(rng, 16, coef, big) \
                            if blk == 4 * b8 + live or rng.random() < 0.5 \
                            else [0] * 16
    mb.cbp_c = int(rng.choice(3, p=recipe.chroma[pic]))
    if mb.cbp_c:
        mb.cdc = [_levels(rng, 4, 1.5, big) if rng.random() < 0.8
                  else [0] * 4 for _ in range(2)]
        if mb.cbp_c == 2:
            mb.cac = [[_levels(rng, 15, coef / 2, big)
                       if rng.random() < 0.5 else [0] * 15
                       for _ in range(4)] for _ in range(2)]
    if (mb.cbp_l or mb.cbp_c or kind == "I16") and \
            rng.random() < recipe.dqp:
        d = int(rng.choice([-2, -1, 1, 2]))
        if abs(qp + d - qp0) <= 3:
            mb.dqp = d
    # levels that break the transforms' range are cut down, the largest
    # first (no draw from rng, so the MBs after it stay as they were)
    for cap in (14, 2, 1):
        if _fits(mb, qp + mb.dqp):
            return mb
        _cap_levels(mb, cap)
    if not _fits(mb, qp + mb.dqp):
        raise AssertionError(f"{kind} MB at ({mx}, {my}) out of range")
    return mb


def _cap_levels(mb: Mb, cap: int) -> None:
    """Every level of the MB clipped to magnitude `cap`."""
    def clip(levels):
        return [max(-cap, min(cap, v)) for v in levels]
    if mb.dc is not None:
        mb.dc = clip(mb.dc)
    for blocks in (mb.ac, mb.l4, mb.l8):
        for k in blocks:
            blocks[k] = clip(blocks[k])
    if mb.cbp_c:
        mb.cdc = [clip(c) for c in mb.cdc]
    if mb.cbp_c == 2:
        mb.cac = [[clip(c) for c in pl] for pl in mb.cac]


# ---- streams ---------------------------------------------------------------

def cabac_field_sps(mb_w: int, map_units: int, crop_bottom: int = 0):
    """High profile, Level 4.0, all-field PAFF (frame_mbs_only_flag 0, no
    MBAFF), direct_8x8_inference_flag 1, 2 reference frames."""
    sps = field_sps(mb_w, map_units)
    sps.profile_idc, sps.level_idc = 100, 40
    sps.log2_max_pic_order_cnt_lsb = 6
    sps.direct_8x8_inference_flag = 1
    if crop_bottom:
        sps.frame_cropping_flag, sps.crop_bottom = 1, crop_bottom
    return sps


def make_field_cabac_stream(mb_w: int = 6, map_units: int = 4,
                            structure: str = "IPBBPB", qp: int = 30,
                            seed: int = 0, crop_bottom: int = 0,
                            counts: Counter | None = None) -> bytes:
    """A CABAC High PAFF stream of field pairs (top field first) in
    `structure` (frames in decode order, field_smoke._pairs), one IDR,
    pic_init_qp `qp` (P fields +1, B fields +2), content drawn from
    `seed`; each field is mb_w x map_units MBs.  counts: tallies every
    syntax kind written, if given."""
    sps = cabac_field_sps(mb_w, map_units, crop_bottom)
    pps = PPS(entropy_coding_mode_flag=1, transform_8x8_mode_flag=1,
              pic_init_qp=qp)
    out = [_nal(7, 3, write_sps(sps)), _nal(8, 3, write_pps(pps))]
    rng = np.random.default_rng(seed)
    for f, (kind, disp, frame_num, ref) in enumerate(_pairs(structure)):
        for parity in (1, 2):
            idr = f == 0 and parity == 1
            hdr = _field_hdr(frame_num, parity, SLICE_TYPE[kind], sps, idr)
            hdr.pic_order_cnt_lsb = (2 * disp + parity - 1) % \
                (1 << sps.log2_max_pic_order_cnt_lsb)
            hdr.nal_ref_idc = 3 if ref else 0
            hdr.slice_qp_delta = {"I": 0, "P": 1, "B": 2}[kind]
            n_ref = (1, 1)
            if kind != "I":
                hdr.num_ref_idx_active_override_flag = 1
                hdr.num_ref_idx_l0_active = hdr.num_ref_idx_l1_active = 2
                n_ref = (2, 2)
            w = BitWriter()
            write_slice_header(w, hdr, sps, pps)
            while not w.byte_aligned():
                w.put_bit(1)                 # cabac_alignment_one_bit
            qp0 = qp + hdr.slice_qp_delta
            sl = FieldSlice(mb_w, map_units, kind, qp0, n_ref)
            cur = qp0
            for addr in range(mb_w * map_units):
                mb = draw_mb(rng, kind, addr % mb_w, addr // mb_w, cur,
                             qp0)
                sl.write(addr, mb)
                cur += mb.dqp
            rbsp = w.get_bytes() + sl.enc.data()
            out.append(_nal(5 if idr else 1, hdr.nal_ref_idc, rbsp))
            if counts is not None:
                counts.update(sl.counts)
                counts[f"{kind} fields"] += 1
    return b"".join(out)


# name -> (mb_w, map_units, frame structure, QP, seed, crop_bottom)
HD = (120, 34)
STREAMS = {
    **{f"bench_field1080i_s{s}": (*HD, "IPBBPBBPBBPB", 30, 27000 + s, 2)
       for s in range(4)},
    "field_cabac_s0": (6, 4, "IPBBPB", 30, 0, 0),
    "field_cabac_s1": (6, 4, "IPBBPB", 26, 1, 0),
    "field_cabac_s2": (8, 6, "IPBBP", 33, 2, 2),
}
# the syntax every stream holds (the counts' keys)
SYNTAX = ("I16", "I8", "P", "PSKIP", "B", "BSKIP", "BDIRECT",
          "prev_intra8x8_pred_mode", "rem_intra8x8_pred_mode",
          "ref_idx_l0=0", "ref_idx_l0=1", "ref_idx_l1=0", "ref_idx_l1=1",
          "transform_size_8x8_flag(inter)", "mb_qp_delta!=0", "luma_dc",
          "luma_ac", "luma4x4", "luma8x8", "chroma_dc", "chroma_ac")


def libavcodec_md5s(path: Path) -> tuple[list, int, int]:
    """(MD5 of each frame of libavcodec's decode, width, height); raises
    if it prints any message (a CABAC desync or a stray syntax value shows
    there)."""
    from tools.streams import ensure_h264ref
    out = path.with_suffix(".golden.yuv.tmp")
    try:
        r = subprocess.run([ensure_h264ref(), "decode", str(path), str(out)],
                           check=True, capture_output=True, text=True)
        if r.stderr.strip():
            raise RuntimeError(f"{path.name}: libavcodec said "
                               f"{r.stderr.strip()[:400]}")
        n, w, h = map(int, r.stdout.split())
        data = out.read_bytes()
    finally:
        out.unlink(missing_ok=True)
    size = w * h * 3 // 2
    assert len(data) == n * size, (len(data), n, size)
    return [hashlib.md5(data[i * size:(i + 1) * size]).hexdigest()
            for i in range(n)], w, h


def write_stream(name: str) -> None:
    mb_w, map_units, structure, qp, seed, crop = STREAMS[name]
    counts: Counter = Counter()
    data = make_field_cabac_stream(mb_w, map_units, structure, qp, seed,
                                   crop, counts=counts)
    missing = [k for k in SYNTAX if not counts[k]]
    if missing:
        raise SystemExit(f"{name}: no {missing}")
    path = DATA / f"{name}.264"
    path.write_bytes(data)
    md5, w, h = libavcodec_md5s(path)
    fields = "".join(k + k for k in structure)
    path.with_suffix(".json").write_text(json.dumps({
        "command": f"python tools/field_cabac.py {name}",
        "content": f"field_cabac.make_field_cabac_stream({mb_w}, "
                   f"{map_units}, {structure!r}, qp={qp}, seed={seed}, "
                   f"crop_bottom={crop})",
        "pairs": structure, "structure": fields,
        "width": w, "height": h, "frames": len(md5),
        "sha256": hashlib.sha256(data).hexdigest(),
        "kbit_per_frame": round(len(data) * 8 / 1000 / len(md5), 1),
        "syntax": dict(sorted(counts.items())),
        "md5": md5,
    }, indent=1) + "\n")
    print(f"{path.relative_to(REPO)}: {len(data)} bytes, {len(md5)} frames "
          f"{w}x{h}, {len(data) * 8 / 1000 / len(md5):.1f} kbit a frame")


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
