"""MB-tensor ABI: the frozen host->device contract (SURVEY.md §7 step 2).

The host entropy layer (mb.parse, later C++) emits per-frame dense numpy
arrays; every device kernel codes against THIS layout.  All per-block data
is in raster block order (y-major), levels already inverse-zigzag-scanned
to raster — the host does the permutation, the device only does arithmetic.

Layout (per frame; the stream batch dimension B is added by stacking):
  kind        [nMB] int32   0=I4x4 1=I8x8 2=I16x16 3=IPCM (4=P, 5=B later)
  qp          [nMB] int32   luma QP (deblock uses 0 for IPCM)
  luma4       [nMB,16,4,4] int32  4x4-transform levels, raster blocks (y4,x4)
  luma8       [nMB,4,8,8]  int32  8x8-transform levels (I8x8/inter-8x8 MBs)
  luma_dc     [nMB,4,4]    int32  I16x16 DC levels (raster)
  chroma_dc   [nMB,2,2,2]  int32  per plane 2x2 DC
  chroma_ac   [nMB,2,2,2,4,4] int32  per plane raster blocks, [0,0]=0
  i4_modes    [nMB,16] int32  per 4x4 block, raster (y4*4+x4)
  i8_modes    [nMB,4]  int32
  i16_mode    [nMB] int32
  chroma_mode [nMB] int32
  i4_avail    [nMB,16,4] int32  per-block (left, top, topleft, topright)
  i8_avail    [nMB,4,4]  int32
  mb_avail    [nMB,3]    int32  MB-level (left, top, topleft) for I16/chroma
  pcm         [nMB,384]  int32  raw samples for IPCM MBs (else 0)
  nz          [nMB,4,4]  int32  deblock coded-flag per 4x4 (8x8-ORed for tr8)
  tr8         [nMB] int32
  slice_id / disable_idc / alpha_off / beta_off  [nMB] int32
  deblock_off [nMB] int32  per-MB deblock-disable OVERRIDE (concealment:
                           filtered edges must not bleed repaired pixels
                           into parsed MBs).  ORed into disable_idc on
                           device; per-MB, unlike the per-slice idc, so
                           the wire's per-slice renormalization keeps it.
  mv          [nMB,4,4,2,2] int32   (y4,x4,list,(x,y))  inter only
  refid       [nMB,4,4,2]   int32   unique DPB picture id, -1 unused (deblock)
  refslot     [nMB,4,4,2]   int32   device DPB slot, -1 unused (MC gather)
  refidx      [nMB,4,4,2]   int32   slice ref-list index, -1 unused (weights)
  wtab        [MAX_SLICES,33,33,3,4] int16  per-slice weight table indexed by
                                    (refidx_l0+1, refidx_l1+1, plane):
                                    (w0, o0, w1, o1); row/col 0 = unused list
                                    = identity.  Resolved to per-cell weights
                                    on DEVICE (models.pipeline.resolve_weights)
                                    — replaces the old dense per-cell wp array
                                    (6.3MB/frame of host fills + upload).
  slogwd      [MAX_SLICES,2] int32  per-slice (luma, chroma) log2 weight denom

Reference parity: this replaces the JM-lineage per-MB struct soup
(`macroblock.c`) with dense tensors (SURVEY.md §2 TPU re-layering).
"""

from __future__ import annotations

import numpy as np

from ..common.tables import (
    BLK4_X, BLK4_Y, FIELD_SCAN_4x4, FIELD_SCAN_8x8, RASTER_TO_BLK4,
    ZIGZAG_4x4, ZIGZAG_8x8,
)
from ..mb.parse import PictureParse
from ..mb.types import (
    MB_B, MB_BDIRECT16, MB_BSKIP, MB_I4x4, MB_I8x8, MB_I16x16, MB_IPCM,
    MB_P, MB_PSKIP,
)

KIND_I4x4, KIND_I8x8, KIND_I16, KIND_IPCM, KIND_P, KIND_B = range(6)

MAX_SLICES = 16   # device-side slice PARAMETER rows (slices sharing
                  # identical parameters share a row; see fill_weight_tables)
CONCEAL_SLICE = MAX_SLICES - 1  # reserved identity row used by concealment
                  # (never assigned to a real slice — a 16th real slice
                  # would otherwise have its weights/deblock params
                  # clobbered by a concealment pass)


def patch_capacity(mb_w: int, mb_h: int) -> int:
    """Static size of the ABI 'patch' cell list: out-of-envelope inter
    cells the hybrid MC path repairs with the gather pass (avg one cell
    per MB before the frame demotes to the full gather path)."""
    return max(256, mb_w * mb_h)


_IDENTITY_WTAB: np.ndarray | None = None


def identity_wtab() -> np.ndarray:
    """[MAX_SLICES,33,33,3,4] int16 all-identity weight table (a cached
    read-only singleton — rebuilding the 840 KB table cost ~0.7 ms per
    frame on the wire pack path; callers that mutate must copy)."""
    global _IDENTITY_WTAB
    if _IDENTITY_WTAB is None:
        w = np.zeros((MAX_SLICES, 33, 33, 3, 4), np.int16)
        w[..., 0] = 1
        w[..., 2] = 1
        w.setflags(write=False)
        _IDENTITY_WTAB = w
    return _IDENTITY_WTAB

_CAT_TO_KIND = {MB_I4x4: KIND_I4x4, MB_I8x8: KIND_I8x8,
                MB_I16x16: KIND_I16, MB_IPCM: KIND_IPCM,
                MB_P: KIND_P, MB_PSKIP: KIND_P,
                MB_B: KIND_B, MB_BSKIP: KIND_B, MB_BDIRECT16: KIND_B}

_ZZ4 = np.array(ZIGZAG_4x4)
_ZZ8 = np.array(ZIGZAG_8x8)
_FS4 = np.array(FIELD_SCAN_4x4)
_FS8 = np.array(FIELD_SCAN_8x8)


def _unscan4(levels16: np.ndarray, fld: bool = False) -> np.ndarray:
    out = np.zeros(16, np.int32)
    out[_FS4 if fld else _ZZ4] = levels16
    return out.reshape(4, 4)


def _unscan8(levels64: np.ndarray, fld: bool = False) -> np.ndarray:
    out = np.zeros(64, np.int32)
    out[_FS8 if fld else _ZZ8] = levels64
    return out.reshape(8, 8)


class FrameABI(dict):
    """dict of numpy arrays keyed as in the module docstring."""

    @property
    def n_mb(self) -> int:
        return self["kind"].shape[0]


def empty_frame_abi(mb_w: int, mb_h: int) -> FrameABI:
    """All-intra-DC zero template (also the lockstep batch's dummy lane
    for finished/failed streams)."""
    n = mb_w * mb_h
    abi = FrameABI(
        kind=np.zeros(n, np.int32),
        qp=np.zeros(n, np.int32),
        luma4=np.zeros((n, 16, 4, 4), np.int32),
        luma8=np.zeros((n, 4, 8, 8), np.int32),
        luma_dc=np.zeros((n, 4, 4), np.int32),
        chroma_dc=np.zeros((n, 2, 2, 2), np.int32),
        chroma_ac=np.zeros((n, 2, 2, 2, 4, 4), np.int32),
        i4_modes=np.full((n, 16), 2, np.int32),
        i8_modes=np.full((n, 4), 2, np.int32),
        i16_mode=np.zeros(n, np.int32),
        chroma_mode=np.zeros(n, np.int32),
        i4_avail=np.zeros((n, 16, 4), np.int32),
        i8_avail=np.zeros((n, 4, 4), np.int32),
        mb_avail=np.zeros((n, 3), np.int32),
        pcm=np.zeros((n, 384), np.int32),
        nz=np.zeros((n, 4, 4), np.int32),
        tr8=np.zeros(n, np.int32),
        slice_id=np.zeros(n, np.int32),
        disable_idc=np.zeros(n, np.int32),
        deblock_off=np.zeros(n, np.int32),
        alpha_off=np.zeros(n, np.int32),
        beta_off=np.zeros(n, np.int32),
        mv=np.zeros((n, 4, 4, 2, 2), np.int32),
        refid=np.full((n, 4, 4, 2), -1, np.int32),
        refslot=np.full((n, 4, 4, 2), -1, np.int32),
        refidx=np.full((n, 4, 4, 2), -1, np.int32),
        wtab=identity_wtab().copy(),
        slogwd=np.zeros((MAX_SLICES, 2), np.int32),
        patch=np.full(patch_capacity(mb_w, mb_h), -1, np.int32),
        mb_w=mb_w, mb_h=mb_h,
    )
    return abi


def pack_frame(pic: PictureParse, cur_poc: int = 0) -> FrameABI:
    abi = empty_frame_abi(pic.mb_w, pic.mb_h)
    mb_w, mb_h = pic.mb_w, pic.mb_h
    n = mb_w * mb_h
    # coded FIELD pictures inverse-scan residuals with the field tables
    fld = bool(pic.headers and pic.headers[0].field_pic_flag)

    def mb_avail_intra(nb_x, nb_y, cur) -> bool:
        if nb_x < 0 or nb_y < 0 or nb_x >= mb_w or nb_y >= mb_h:
            return False
        if nb_y * mb_w + nb_x >= cur.mb_y * mb_w + cur.mb_x:
            return False
        if pic.slice_map[nb_y, nb_x] != cur.slice_id:
            return False
        nb = pic.mbs[nb_y * mb_w + nb_x]
        if pic.pps.constrained_intra_pred_flag and not nb.is_intra:
            return False
        return True

    def blk_avail_intra(bx, by, cur, cur_blk) -> bool:
        if bx < 0 or by < 0 or bx >= mb_w * 4 or by >= mb_h * 4:
            return False
        nb_mbx, nb_mby = bx // 4, by // 4
        if (nb_mbx, nb_mby) == (cur.mb_x, cur.mb_y):
            return RASTER_TO_BLK4[(bx % 4) + 4 * (by % 4)] < cur_blk
        return mb_avail_intra(nb_mbx, nb_mby, cur)

    for addr, mb in enumerate(pic.mbs):
        if mb is None:      # lost-slice MB (concealed later, api.conceal)
            continue
        k = _CAT_TO_KIND[mb.category]
        abi["kind"][addr] = k
        abi["qp"][addr] = mb.qp
        abi["tr8"][addr] = int(mb.transform_8x8)
        abi["nz"][addr] = (mb.tc_luma > 0).astype(np.int32)
        if mb.transform_8x8:
            nz = abi["nz"][addr]
            for y8 in range(2):
                for x8 in range(2):
                    q = nz[2 * y8:2 * y8 + 2, 2 * x8:2 * x8 + 2].any()
                    nz[2 * y8:2 * y8 + 2, 2 * x8:2 * x8 + 2] = int(q)
        hdr = pic.headers[mb.slice_id]
        abi["slice_id"][addr] = mb.slice_id
        abi["disable_idc"][addr] = hdr.disable_deblocking_filter_idc
        abi["alpha_off"][addr] = 2 * hdr.slice_alpha_c0_offset_div2
        abi["beta_off"][addr] = 2 * hdr.slice_beta_offset_div2
        abi["mb_avail"][addr] = [
            mb_avail_intra(mb.mb_x - 1, mb.mb_y, mb),
            mb_avail_intra(mb.mb_x, mb.mb_y - 1, mb),
            mb_avail_intra(mb.mb_x - 1, mb.mb_y - 1, mb),
        ]

        if mb.category == MB_IPCM:
            abi["pcm"][addr] = mb.pcm_samples.astype(np.int32)
            abi["qp"][addr] = 0  # deblock qp; PCM has no residual path
            continue

        # chroma residual
        if mb.cbp_chroma:
            for pl in range(2):
                abi["chroma_dc"][addr, pl] = mb.chroma_dc[pl].reshape(2, 2)
                for blk in range(4):
                    abi["chroma_ac"][addr, pl, blk // 2, blk % 2] = \
                        _unscan4(mb.chroma_ac[pl, blk], fld)

        if mb.category == MB_I16x16:
            abi["i16_mode"][addr] = mb.i16_mode
            abi["chroma_mode"][addr] = mb.chroma_mode
            abi["luma_dc"][addr] = _unscan4(mb.luma_dc, fld)
            for blk in range(16):
                r = BLK4_Y[blk] * 4 + BLK4_X[blk]
                abi["luma4"][addr, r] = _unscan4(mb.luma_levels[blk], fld)
        elif mb.category == MB_I8x8:
            abi["chroma_mode"][addr] = mb.chroma_mode
            for blk in range(4):
                abi["luma8"][addr, blk] = _unscan8(mb.luma_levels[blk], fld)
                abi["i8_modes"][addr, blk] = mb.i8_modes[blk]
                bx = mb.mb_x * 4 + (blk % 2) * 2
                by = mb.mb_y * 4 + (blk // 2) * 2
                cur_blk4 = RASTER_TO_BLK4[(bx % 4) + 4 * (by % 4)]
                abi["i8_avail"][addr, blk] = [
                    blk_avail_intra(bx - 1, by, mb, cur_blk4),
                    blk_avail_intra(bx, by - 1, mb, cur_blk4),
                    blk_avail_intra(bx - 1, by - 1, mb, cur_blk4),
                    blk_avail_intra(bx + 2, by - 1, mb, cur_blk4),
                ]
        elif mb.category == MB_I4x4:
            abi["chroma_mode"][addr] = mb.chroma_mode
            for blk in range(16):
                r = BLK4_Y[blk] * 4 + BLK4_X[blk]
                abi["luma4"][addr, r] = _unscan4(mb.luma_levels[blk], fld)
                abi["i4_modes"][addr, r] = mb.i4_modes[blk]
                bx = mb.mb_x * 4 + BLK4_X[blk]
                by = mb.mb_y * 4 + BLK4_Y[blk]
                abi["i4_avail"][addr, r] = [
                    blk_avail_intra(bx - 1, by, mb, blk),
                    blk_avail_intra(bx, by - 1, mb, blk),
                    blk_avail_intra(bx - 1, by - 1, mb, blk),
                    blk_avail_intra(bx + 1, by - 1, mb, blk),
                ]
        else:
            # inter MB: residual levels + motion/ref/weight resolution
            if mb.luma_levels is not None:
                if mb.transform_8x8:
                    for blk in range(4):
                        abi["luma8"][addr, blk] = _unscan8(mb.luma_levels[blk], fld)
                else:
                    for blk in range(16):
                        r = BLK4_Y[blk] * 4 + BLK4_X[blk]
                        abi["luma4"][addr, r] = _unscan4(mb.luma_levels[blk], fld)
            abi["mv"][addr] = np.moveaxis(mb.mvs, 0, 2)
            ridx = np.moveaxis(mb.refidx, 0, 2).astype(np.int32)  # [4,4,2]
            abi["refidx"][addr] = ridx
            hdr = pic.headers[mb.slice_id]
            l0, l1 = pic.slice_reflists[mb.slice_id]
            for lst, lref in ((0, l0), (1, l1)):
                if not len(lref):
                    continue
                uids = np.array([p.uid for p in lref], np.int32)
                slots = np.array([p.slot for p in lref], np.int32)
                r_ = ridx[..., lst]
                valid = (r_ >= 0) & (r_ < len(lref))
                rc = np.clip(r_, 0, len(lref) - 1)
                abi["refid"][addr, :, :, lst] = np.where(valid, uids[rc], -1)
                abi["refslot"][addr, :, :, lst] = np.where(valid, slots[rc], -1)
    note_nonexisting_refs(abi, pic.slice_reflists)
    fill_weight_tables(abi, pic.pps, pic.headers, pic.slice_reflists, cur_poc)
    return abi


def note_nonexisting_refs(abi: FrameABI, slice_reflists) -> None:
    """Record the uids of non-existing (frame_num-gap, spec 8.2.5.2)
    pictures referenced by this frame's lists under abi["nx_uids"].

    api.py binds gap placeholders to device slot 0 (MC gather bounds),
    where a real picture may also live; the wire format substitutes
    refid := refslot, which would make the two compare equal in the
    deblock bS same-ref test.  The wire pack flags such cells
    (refslot | NX_FLAG) so the unpacked refid stays distinct."""
    nx = sorted({p.uid for (l0, l1) in slice_reflists for p in (*l0, *l1)
                 if getattr(p, "non_existing", False)})
    if nx:
        abi["nx_uids"] = np.asarray(nx, np.int32)


def _slice_row_key(pps, hdr, l0, l1):
    """Hashable device-parameter key of a slice: two slices with equal
    keys are indistinguishable to every device consumer of the slice row
    (weight tables, slogwd, per-slice deblock params) EXCEPT the
    disable_idc==2 slice-boundary test, which the caller handles by
    forcing such slices unique while rows remain."""
    weighted_p = bool(pps.weighted_pred_flag) and hdr.is_p
    weighted_b = pps.weighted_bipred_idc == 1 and hdr.is_b
    implicit_b = pps.weighted_bipred_idc == 2 and hdr.is_b
    key = [hdr.disable_deblocking_filter_idc,
           hdr.slice_alpha_c0_offset_div2, hdr.slice_beta_offset_div2]
    if weighted_p or weighted_b:
        key += ["w", hdr.luma_log2_weight_denom, hdr.chroma_log2_weight_denom]
        for lst, pws in ((0, hdr.pred_weights_l0), (1, hdr.pred_weights_l1)):
            if not pws or (lst == 1 and not weighted_b):
                key.append(None)
                continue
            key.append(tuple(
                (pw.luma_weight, pw.luma_offset,
                 tuple(pw.chroma_weight), tuple(pw.chroma_offset))
                for pw in pws))
    elif implicit_b:
        # implicit weights depend only on the (cur, l0[i], l1[j]) POC /
        # long-term geometry
        key += ["i", tuple((p.poc, p.long_term) for p in l0),
                tuple((p.poc, p.long_term) for p in l1)]
    else:
        key.append("n")
    return tuple(key)


def assign_slice_rows(pps, headers, slice_reflists) -> list[int]:
    """Map each slice to a device parameter row in [0, MAX_SLICES-2]
    (CONCEAL_SLICE is reserved).  <= MAX_SLICES-1 slices map 1:1; above
    that, slices sharing identical device-visible parameters share a row
    (slice-per-MB-row encoders emit dozens of identical slices — the old
    hard reject failed legal streams, ADVICE r3).  disable_idc==2 slices
    are kept unique while rows remain so the same-slice boundary test
    stays exact; if even the deduped key set overflows, idc==2 slices
    merge too (their shared boundaries then get filtered: a bounded,
    deblock-only deviation instead of a decode failure)."""
    usable = MAX_SLICES - 1
    if len(headers) <= usable:
        return list(range(len(headers)))
    for force_unique_idc2 in (True, False):
        rows: dict = {}
        assign = []
        for s, hdr in enumerate(headers):
            l0, l1 = slice_reflists[s]
            key = _slice_row_key(pps, hdr, l0, l1)
            if force_unique_idc2 and hdr.disable_deblocking_filter_idc == 2:
                key = key + ("u", s)
            if key not in rows:
                rows[key] = len(rows)
            assign.append(rows[key])
        if len(rows) <= usable:
            return assign
    # > usable truly distinct parameter sets: the caller falls back to
    # DENSE per-cell weights (no row limit) — see fill_weight_tables.
    return None


def fill_weight_tables(abi: FrameABI, pps, headers, slice_reflists,
                       cur_poc: int) -> None:
    """Per-slice-row weight tables (spec 8.4.2.3 / 8.4.2.3.1).

    abi["wtab"][s, r0+1, r1+1, plane] = (w0, o0, w1, o1) for slice row s;
    index 0 on either ref axis means that list is unused for the cell and
    holds identity, so the device gather needs no validity masking.
    Pictures with more than MAX_SLICES-1 slices are remapped onto shared
    parameter rows (assign_slice_rows), including abi["slice_id"].

    If even the deduped parameter sets exceed the rows (a low-latency
    encoder emitting dozens of slices with DISTINCT pred-weight tables,
    see tests/test_slice_rows.py), the picture falls back to DENSE per-cell weights:
    abi["wp"]/abi["logwd"] filled on host from the true per-slice tables
    (no row limit; models.pipeline.resolve_weights passes them through)
    and slice_id kept at the true per-slice ids (deblock only compares
    ids for equality, so no 4-bit row bound applies off the wire)."""
    row_of = assign_slice_rows(pps, headers, slice_reflists)
    if row_of is None:
        _fill_dense_weights(abi, pps, headers, slice_reflists, cur_poc)
        return
    if row_of != list(range(len(headers))):
        # remap per-MB ids onto the shared rows (copy: abi["slice_id"]
        # may be a zero-copy view of pooled parser arrays)
        lut = np.asarray(row_of, np.int32)
        abi["slice_id"] = lut[np.asarray(abi["slice_id"])]
    wtab, slogwd = abi["wtab"], abi["slogwd"]
    done = set()
    for s0, hdr in enumerate(headers):
        s = row_of[s0]
        if s in done:
            continue
        done.add(s)
        l0, l1 = slice_reflists[s0]
        _fill_wtab_row(wtab, slogwd, s, pps, hdr, l0, l1, cur_poc)


def _fill_wtab_row(wtab, slogwd, s: int, pps, hdr, l0, l1,
                   cur_poc: int) -> None:
    """Fill one weight-table row (spec 8.4.2.3 / 8.4.2.3.1) for slice
    header `hdr` into wtab[s]/slogwd[s] (pre-initialized to identity)."""
    weighted_p = bool(pps.weighted_pred_flag) and hdr.is_p
    weighted_b = pps.weighted_bipred_idc == 1 and hdr.is_b
    implicit_b = pps.weighted_bipred_idc == 2 and hdr.is_b
    if weighted_p or weighted_b:
        slogwd[s] = [hdr.luma_log2_weight_denom,
                     hdr.chroma_log2_weight_denom]
        for lst, pws in ((0, hdr.pred_weights_l0),
                         (1, hdr.pred_weights_l1)):
            if not pws or (lst == 1 and not weighted_b):
                continue
            arr = np.array(
                [[(pw.luma_weight, pw.luma_offset),
                  (pw.chroma_weight[0], pw.chroma_offset[0]),
                  (pw.chroma_weight[1], pw.chroma_offset[1])]
                 for pw in pws], np.int16)          # [nref,3,2]
            nr = min(len(pws), 32)
            if lst == 0:
                wtab[s, 1:nr + 1, :, :, 0:2] = arr[:nr, None]
            else:
                wtab[s, :, 1:nr + 1, :, 2:4] = arr[None, :nr]
    elif implicit_b:
        slogwd[s] = [5, 5]
        wtab[s, ..., 0] = 32        # identity at logWD 5
        wtab[s, ..., 2] = 32
        wtab[s, ..., 1] = 0
        wtab[s, ..., 3] = 0
        n0, n1 = min(len(l0), 32), min(len(l1), 32)
        if n0 and n1:
            pair = np.zeros((n0, n1, 2), np.int16)
            for i0 in range(n0):
                for i1 in range(n1):
                    pair[i0, i1] = implicit_weights(
                        cur_poc, l0[i0], l1[i1])
            wtab[s, 1:n0 + 1, 1:n1 + 1, :, 0] = pair[:, :, None, 0]
            wtab[s, 1:n0 + 1, 1:n1 + 1, :, 2] = pair[:, :, None, 1]


def _fill_dense_weights(abi: FrameABI, pps, headers, slice_reflists,
                        cur_poc: int) -> None:
    """Row-overflow fallback: per-CELL weights from the true per-slice
    tables.  abi["wp"] [n,4,4,2,3,2] / abi["logwd"] [n,2] match what
    resolve_weights produces from the compact rows, so every MC path
    (Pallas combine + gather) consumes them unchanged; the frame ships
    dense (wire bypass) — rare enough that the upload cost is fine."""
    S = len(headers)
    fullw = np.zeros((S, 33, 33, 3, 4), np.int16)
    fullw[..., 0] = 1
    fullw[..., 2] = 1
    fulls = np.zeros((S, 2), np.int32)
    for s, hdr in enumerate(headers):
        l0, l1 = slice_reflists[s]
        _fill_wtab_row(fullw, fulls, s, pps, hdr, l0, l1, cur_poc)
    sid = np.asarray(abi["slice_id"])
    ridx = np.asarray(abi["refidx"])
    r0 = np.clip(ridx[..., 0], -1, 31) + 1      # [n,4,4]; 0 = unused
    r1 = np.clip(ridx[..., 1], -1, 31) + 1
    t = fullw[sid[:, None, None], r0, r1].astype(np.int32)  # [n,4,4,3,4]
    abi["wp"] = np.stack([t[..., 0:2], t[..., 2:4]], axis=3)
    abi["logwd"] = fulls[sid]


def implicit_weights(cur_poc: int, p0, p1) -> tuple[int, int]:
    """Implicit weighted bi-prediction weights (spec 8.4.2.3.1)."""
    if p0.long_term or p1.long_term:
        return 32, 32
    td = max(-128, min(127, p1.poc - p0.poc))
    if td == 0:
        return 32, 32
    tb = max(-128, min(127, cur_poc - p0.poc))
    tx = (16384 + (abs(td) >> 1)) // td
    dsf = max(-1024, min(1023, (tb * tx + 32) >> 6))
    w1 = dsf >> 2
    if w1 < -64 or w1 > 128:
        return 32, 32
    return 64 - w1, w1
