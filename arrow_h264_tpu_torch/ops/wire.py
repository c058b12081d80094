"""Compact host->device wire format for the frame ABI (PyTorch).

Port of `arrow_h264_tpu.ops.wire`.  The dense MB-tensor ABI (ops.abi) is
the device-side contract, but it is ~35-44 MB of int32 a 1080p frame,
almost all of it zeros.  The wire ships a picture as ONE uint8 buffer
instead, and `unpack_wire` scatters it back into the dense ABI on the
device.

Layout (all sections concatenated into one uint8 buffer, each 8-byte
aligned; the spec determines every offset, so the same walk runs on the
host at pack time and on the device in the unpack):

  meta6    [n, 6]  u8   kind, qp, slice_id | deblock_off << 4,
                        flags(tr8|avail|i16|chroma), nz bitmask lo/hi
  slice8   [S, 6]  i8   per slice row: disable_idc, alpha_off, beta_off,
                        slogwd_y, slogwd_c
  intra    sparse rows of 40 ext bytes (i4/i8 modes + packed avail) for
                        MBs that carry any intra side-info
  inter    "base": per-MB cell-0 mv/refidx/refslot + sparse full-grid
                        rows for sub-partitioned MBs; refid is not
                        shipped (see unpack_wire)
  <coeff>  "bm8": per nonzero block idx i32 + significance bitmap u16 +
                        nonzero values packed int8 (dense16 / dense int32
                        when levels or density overflow)
  pcm      sparse u8 rows, wtab sparse non-identity rows

`pack_wire_raw` (host: one GIL-released call of host/cpp/
entropy_wire.inc) returns compact records and the picture's own spec;
`emit_wire` renders them into the upload buffer laid out per a target
spec.  A lockstep batch merges its lanes' specs (`merge_specs`) so that
one [B, total] buffer serves the whole round.  `pack_wire_raw_numpy`,
`pack_wire`, `conform_sections` and `flatten_wire` are the readable
numpy forms that the shipped path is tested byte-equal against.

The reference's `patch` section (the TPU's MC envelope repair list) is
not part of the port's wire: for an ABI that carries no patch entries the
buffers are byte-equal to the reference's, whose spec then ends in
("patch", "zero", 0).  Nor are its sticky and persisted specs: they exist
because an XLA function retraces when its input's structure changes, and
a torch function does not.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host.centropy import (
    WIRE_CLASS, WIRE_INTER, WIRE_INTER_K, WIRE_INTRA, WIRE_INTRA_K, WIRE_PCM,
    WIRE_PCM_K, WIRE_WTAB_K, gather_blocks8, pack_wire_records, scan_blocks8,
    scan_inter,
)
from .abi import KIND_IPCM, KIND_P, MAX_SLICES, identity_wtab
from .transforms import device_copy

# (field, source key, grid cells per MB, values per cell)
_COEFF_FIELDS = (
    ("l4", "luma4", 16, 16),
    ("l8", "luma8", 4, 64),
    ("ca", "chroma_ac", 8, 16),
    ("ldc", "luma_dc", 1, 16),
    ("cdc", "chroma_dc", 1, 8),
)

_COEFF_SHAPES = {"l4": (16, 4, 4), "l8": (4, 8, 8), "ca": (2, 2, 2, 4, 4),
                 "ldc": (4, 4), "cdc": (2, 2, 2)}

_MIN_BUCKET = 32
_WTAB_COLS = 33 * 33 * 3 * 4
NX_FLAG = 64      # shipped-refslot flag: ref is a non-existing (gap)
                  # picture — refid must not collide with the real
                  # picture at the same device slot (fits int8; device
                  # DPB slots are < 64)


def _bucket(k: int, cap: int, lo: int = _MIN_BUCKET) -> int:
    """Next bucket >= k from the {2^i, 3*2^i} ladder (<=33% padding)."""
    b = lo
    while True:
        if b >= k:
            return min(b, cap)
        if (b + (b >> 1)) >= k:
            return min(b + (b >> 1), cap)
        b <<= 1


# ---------------------------------------------------------------------------
# layout: spec -> ordered (name, dtype, shape) section table
# ---------------------------------------------------------------------------

def _sections_of(spec, n: int):
    """Ordered section table for one frame's wire buffer."""
    out = [("meta6", np.uint8, (n, 6)),
           ("slice8", np.int8, (MAX_SLICES, 6))]
    sd = dict((f, (s, b)) for f, s, b in spec)

    sch, b = sd["intra"]
    if sch == "sparse":
        out += [("in_idx", np.int32, (b,)), ("in_ext", np.uint8, (b, 40))]
    elif sch == "dense":
        out += [("in_ext", np.uint8, (n, 40))]

    sch, b = sd["inter"]
    if sch == "base":
        out += [("mv_base", np.int16, (n, 4)), ("ref_base", np.int8, (n, 4))]
        if b:
            out += [("nu_idx", np.int32, (b,)), ("nu_mv", np.int16, (b, 64)),
                    ("nu_ref", np.int8, (b, 64))]
    elif sch == "dense":
        out += [("mv16", np.int16, (n, 64)), ("ref8", np.int8, (n, 64))]

    for f, _, cpm, w in _COEFF_FIELDS:
        grid = n * cpm
        sch, b = sd[f]
        if sch == "bm8":
            br, bv = b
            bmw = (w + 15) // 16
            out += [(f + "_idx", np.int32, (br,)),
                    (f + "_bm", np.uint16, (br, bmw)),
                    (f + "_val", np.int8, (bv,))]
        elif sch == "dense16":
            out += [(f + "_dense", np.int16, (grid, w))]
        elif sch == "dense":
            out += [(f + "_dense", np.int32, (grid, w))]

    sch, b = sd["pcm"]
    if sch == "sparse":
        out += [("pcm_idx", np.int32, (b,)), ("pcm_val", np.uint8, (b, 384))]
    elif sch == "dense":
        out += [("pcm_val", np.uint8, (n, 384))]

    sch, b = sd["wtab"]
    if sch == "sparse":
        out += [("wt_idx", np.int32, (b,)),
                ("wt_val", np.int16, (b, _WTAB_COLS))]
    return out


def _offsets(spec, n: int):
    """(name -> (offset, dtype, shape)) plus total buffer bytes."""
    off = 0
    table = {}
    for name, dt, shape in _sections_of(spec, n):
        nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
        table[name] = (off, dt, shape)
        off += (nbytes + 7) & ~7
    return table, off


def wire_total(spec, n: int) -> int:
    """Bytes of one picture's wire buffer laid out per `spec`."""
    return _offsets(spec, n)[1]


def flatten_wire(sections, spec, n: int) -> np.ndarray:
    """Sections dict -> ONE uint8 buffer."""
    table, total = _offsets(spec, n)
    buf = np.zeros(total, np.uint8)
    for name, (off, dt, shape) in table.items():
        a = np.ascontiguousarray(sections[name], dtype=dt)
        raw = a.view(np.uint8).reshape(-1)
        buf[off:off + raw.size] = raw
    return buf


# ---------------------------------------------------------------------------
# raw pack + direct emit (the shipped path): the pack produces COMPACT records
# (k rows, no bucket padding), and emit_wire writes every section straight
# into the upload buffer at its spec offset — one copy per section,
# conforming to a bigger target spec for free (pad space is just buffer
# zeros + idx sentinels).
# ---------------------------------------------------------------------------

def pack_wire_raw(abi, mb_w: int, mb_h: int):
    """Dense numpy ABI -> (raw records dict, own spec tuple), every
    section in one call of the host library with the GIL released
    (centropy.pack_wire_records: host/cpp/entropy_wire.inc).

    raw["<field>"] holds compact records (first-k rows only);
    emit_wire(raw, spec, target, n) renders the upload buffer.
    raw["full_scans"] counts the coefficient classes whose decode-time
    row hints were unusable (not ascending, as under ASO), so that every
    row was scanned.  pack_wire_raw_numpy is its readable twin."""
    n = mb_w * mb_h
    cnt, out, srcs = pack_wire_records(abi, n, _COEFF_FIELDS)
    raw = {"meta6": out("meta6"), "slice8": out("slice8")}
    spec = []

    k = cnt[WIRE_INTRA_K]
    sch = ("zero", "sparse", "dense")[cnt[WIRE_INTRA]]
    spec.append(("intra", sch, _bucket(k, n) if sch == "sparse" else 0))
    if sch == "dense":
        raw["in_ext"] = out("in_ext")
    elif sch == "sparse":
        raw["in_idx"] = out("in_idx")[:k]
        raw["in_ext"] = out("in_ext")[:k]

    k = cnt[WIRE_INTER_K]
    sch = ("zero", "base", "dense")[cnt[WIRE_INTER]]
    if sch == "dense":
        spec.append(("inter", "dense", 0))
        raw["mv16"] = out("mv16")
        raw["ref8_idx"] = out("ref8")[:, :32]
        raw["ref8_slot"] = out("ref8")[:, 32:]
    elif sch == "base":
        spec.append(("inter", "base", _bucket(k, n // 2 + 1) if k else 0))
        raw["mv_base"] = out("mv_base")
        raw["ref_base"] = out("ref_base")
        if k:
            raw["nu_idx"] = out("nu_idx")[:k]
            raw["nu_mv"] = out("nu_mv")[:k]
            raw["nu_ref"] = out("nu_ref")[:k]
        raw["nu_k"] = k
    else:
        spec.append(("inter", "zero", 0))

    full = 0
    for c, (f, _key, cpm, w) in enumerate(_COEFF_FIELDS):
        sch, k, nnz, unusable = cnt[WIRE_CLASS + 4 * c:WIRE_CLASS + 4 * c + 4]
        sch = ("zero", "bm8", "dense16", "dense")[sch]
        full += unusable
        grid = n * cpm
        spec.append((f, sch, (_bucket(k, grid), _bucket(nnz, grid * w, lo=128))
                     if sch == "bm8" else 0))
        if sch == "bm8":
            raw[f + "_idx"] = out(f + "_idx")[:k]
            raw[f + "_bm"] = out(f + "_bm")[:k]
            raw[f + "_val"] = out(f + "_val")[:nnz]
            raw[f + "_nnz"] = nnz
        elif sch == "dense16":
            raw[f + "_src16"] = out(f + "_src16")
        elif sch == "dense":
            raw[f + "_src"] = srcs[c]

    k = cnt[WIRE_PCM_K]
    sch = ("zero", "sparse", "dense")[cnt[WIRE_PCM]]
    spec.append(("pcm", sch, _bucket(k, n, lo=1) if sch == "sparse" else 0))
    if sch == "dense":
        raw["pcm_val"] = out("pcm_val")
    elif sch == "sparse":
        raw["pcm_idx"] = out("pcm_idx")[:k]
        raw["pcm_val"] = out("pcm_val")[:k]

    k = cnt[WIRE_WTAB_K]
    if k == 0:
        spec.append(("wtab", "zero", 0))
    else:
        spec.append(("wtab", "sparse", _bucket(k, MAX_SLICES, lo=1)))
        raw["wt_idx"] = out("wt_idx")[:k]
        raw["wt_val"] = out("wt_val")[:k]
    raw["full_scans"] = full
    return raw, tuple(spec)


def emit_wire(raw, spec, target, n: int, out: np.ndarray | None = None
              ) -> np.ndarray:
    """Raw records (own `spec`) -> ONE uint8 buffer laid out per `target`
    (a superset spec from merge_specs, or spec itself), written into `out`
    (a uint8 array of wire_total(target, n) bytes, e.g. a lane's row of a
    pinned staging tensor) or a new array.  Byte-equal to
    flatten_wire(conform_sections(sections, spec, target)) by
    construction (tests/test_torch_wire.py)."""
    table, total = _offsets(target, n)
    if out is None:
        buf = np.zeros(total, np.uint8)
    else:
        if out.shape != (total,) or out.dtype != np.uint8:
            raise ValueError(f"out: {out.dtype} {out.shape}, expected "
                             f"uint8 ({total},)")
        buf = out
        buf[:] = 0

    def view(name):
        off, dt, shape = table[name]
        nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
        return buf[off:off + nbytes].view(dt).reshape(shape)

    view("meta6")[:] = raw["meta6"]
    view("slice8")[:] = raw["slice8"]
    sd = dict((f, (s, b)) for f, s, b in spec)
    td = dict((f, (s, b)) for f, s, b in target)

    sch, b = sd["intra"]
    tsch, tb = td["intra"]
    if tsch == "dense":
        if sch == "sparse":
            view("in_ext")[raw["in_idx"]] = raw["in_ext"]
        elif sch == "dense":
            view("in_ext")[:] = raw["in_ext"]
    elif tsch == "sparse":
        idx = view("in_idx")
        idx[:] = n
        if sch == "sparse":
            k = len(raw["in_idx"])
            idx[:k] = raw["in_idx"]
            view("in_ext")[:k] = raw["in_ext"]

    sch, b = sd["inter"]
    tsch, tb = td["inter"]
    if tsch == "dense":
        mv16 = view("mv16")
        ref8 = view("ref8")
        if sch == "dense":
            mv16[:] = raw["mv16"]
            ref8[:, :32] = raw["ref8_idx"]
            ref8[:, 32:] = raw["ref8_slot"]
        elif sch == "base":
            mv16[:] = np.tile(raw["mv_base"], 16)
            rb = raw["ref_base"]
            ref8[:, :32] = np.repeat(rb[:, 0:2], 16, axis=0) \
                .reshape(n, 32)
            ref8[:, 32:] = np.repeat(rb[:, 2:4], 16, axis=0) \
                .reshape(n, 32)
            if raw.get("nu_k"):
                mv16[raw["nu_idx"]] = raw["nu_mv"]
                ref8[raw["nu_idx"]] = raw["nu_ref"]
        else:  # zero
            ref8[:] = -1
    elif tsch == "base":
        rbv = view("ref_base")
        if sch == "base":
            view("mv_base")[:] = raw["mv_base"]
            rbv[:] = raw["ref_base"]
        else:  # zero
            rbv[:] = -1
        if tb:
            idx = view("nu_idx")
            idx[:] = n
            if sch == "base" and raw.get("nu_k"):
                k = raw["nu_k"]
                idx[:k] = raw["nu_idx"]
                view("nu_mv")[:k] = raw["nu_mv"]
                view("nu_ref")[:k] = raw["nu_ref"]

    for f, _key, cpm, w in _COEFF_FIELDS:
        grid = n * cpm
        sch, b = sd[f]
        tsch, tb = td[f]
        if tsch == "zero":
            continue
        if tsch in ("dense", "dense16"):
            dv = view(f + "_dense")
            if sch == "bm8":
                dv[:] = _expand_bm8_np(raw[f + "_idx"], raw[f + "_bm"],
                                       raw[f + "_val"], grid, w)
            elif sch in ("dense", "dense16"):
                dv[:] = raw.get(f + "_src16", raw.get(f + "_src"))
        else:  # bm8 target
            idx = view(f + "_idx")
            idx[:] = grid
            if sch == "bm8":
                k = len(raw[f + "_idx"])
                idx[:k] = raw[f + "_idx"]
                view(f + "_bm")[:k] = raw[f + "_bm"]
                view(f + "_val")[:raw[f + "_nnz"]] = raw[f + "_val"]

    sch, b = sd["pcm"]
    tsch, tb = td["pcm"]
    if tsch == "dense":
        if sch == "sparse":
            view("pcm_val")[raw["pcm_idx"]] = raw["pcm_val"]
        elif sch == "dense":
            view("pcm_val")[:] = raw["pcm_val"]
    elif tsch == "sparse":
        idx = view("pcm_idx")
        idx[:] = n
        if sch == "sparse":
            k = len(raw["pcm_idx"])
            idx[:k] = raw["pcm_idx"]
            view("pcm_val")[:k] = raw["pcm_val"]
        elif sch == "dense":
            # own dense cannot conform DOWN to sparse (merge_specs never
            # shrinks a scheme)
            raise ValueError("pcm: a dense section cannot conform to a "
                             "sparse target")

    tsch, tb = td["wtab"]
    if tsch == "sparse":
        idx = view("wt_idx")
        idx[:] = MAX_SLICES
        if sd["wtab"][0] == "sparse":
            k = len(raw["wt_idx"])
            idx[:k] = raw["wt_idx"]
            view("wt_val")[:k] = raw["wt_val"]
    return buf


# ---------------------------------------------------------------------------
# the readable twin (tests only): numpy sections at their bucket sizes
# ---------------------------------------------------------------------------


def _pack_meta(abi, n: int, sec: dict):
    m = np.empty((n, 6), np.uint8)
    m[:, 0] = abi["kind"]
    m[:, 1] = abi["qp"]
    # slice_id < MAX_SLICES = 16 occupies bits 0..3; bit 4 carries the
    # per-MB deblock-disable override (concealment edges), which the
    # per-slice renormalization of disable_idc below would otherwise drop
    dbo = np.asarray(abi.get("deblock_off", 0), np.uint8)
    m[:, 2] = np.asarray(abi["slice_id"], np.uint8) | (dbo << 4)
    mba = np.asarray(abi["mb_avail"], np.uint8)
    m[:, 3] = (np.asarray(abi["tr8"], np.uint8)
               | (mba[:, 0] << 1) | (mba[:, 1] << 2) | (mba[:, 2] << 3)
               | (np.asarray(abi["i16_mode"], np.uint8) << 4)
               | (np.asarray(abi["chroma_mode"], np.uint8) << 6))
    nzb = np.packbits(np.asarray(abi["nz"], np.uint8).reshape(n, 16),
                      axis=1, bitorder="little")
    m[:, 4:6] = nzb
    sec["meta6"] = m

    tab = np.zeros((MAX_SLICES, 6), np.int8)
    sid = np.asarray(abi["slice_id"])
    # MBs carrying the per-MB override (concealment wrote disable_idc=1
    # for the dense path) must not pollute their slice's row: scatter
    # only from clean MBs (all MBs of a slice share the header values,
    # so any clean member fills the row correctly)
    clean = np.broadcast_to(np.asarray(dbo == 0), sid.shape)
    tab[sid[clean], 0] = np.asarray(abi["disable_idc"], np.int8)[clean]
    tab[sid, 1] = np.asarray(abi["alpha_off"], np.int8)
    tab[sid, 2] = np.asarray(abi["beta_off"], np.int8)
    tab[:, 3:5] = np.asarray(abi["slogwd"], np.int8)
    sec["slice8"] = tab


def _intra_ext(abi, n: int):
    """(candidate rows, ext maker): MBs that carry any intra side-info,
    and the 40-byte ext rows of a selection of MBs.  Building ext over the
    whole grid costs ~9 ms a 1080p frame, so P/B frames build it only for
    their few candidate rows."""
    i4m = np.asarray(abi["i4_modes"])
    i4a = np.asarray(abi["i4_avail"])
    i8m = np.asarray(abi["i8_modes"])
    i8a = np.asarray(abi["i8_avail"])
    cand = (i4m.any(axis=1) | i4a.reshape(n, -1).any(axis=1)
            | i8m.any(axis=1) | i8a.reshape(n, -1).any(axis=1))

    def build_ext(sel):
        m = n if isinstance(sel, slice) else len(sel)
        ext = np.empty((m, 40), np.uint8)
        ext[:, 0:16] = i4m[sel]
        ext[:, 16:32] = np.packbits(
            i4a[sel].astype(np.uint8), axis=2,
            bitorder="little").reshape(m, 16)
        ext[:, 32:36] = i8m[sel]
        ext[:, 36:40] = np.packbits(
            i8a[sel].astype(np.uint8), axis=2,
            bitorder="little").reshape(m, 4)
        return ext

    return np.nonzero(cand)[0], build_ext


def _pack_intra(abi, n: int, sec: dict):
    rows, build_ext = _intra_ext(abi, n)
    k = len(rows)
    if k == 0:
        return ("intra", "zero", 0)
    b = _bucket(k, n)
    if b >= n:
        sec["in_ext"] = build_ext(slice(None))
        return ("intra", "dense", 0)
    idx = np.full(b, n, np.int32)
    idx[:k] = rows
    vals = np.zeros((b, 40), np.uint8)
    vals[:k] = build_ext(rows)
    sec["in_idx"] = idx
    sec["in_ext"] = vals
    return ("intra", "sparse", b)


def _inter_scan(abi, n: int):
    """None for a picture without inter MBs, else (mv, refidx, refslot as
    [n, 64] / [n, 32] / [n, 32] int32, cap, scan_inter's result).
    Cells referencing non-existing (frame_num-gap) pictures get NX_FLAG
    in the shipped slot, so that unpack's refid := refslot substitution
    keeps them distinct from the real picture sharing device slot 0
    (abi.note_nonexisting_refs); unpack strips the flag for MC."""
    if not (np.asarray(abi["kind"]) >= KIND_P).any():
        return None
    mv = np.ascontiguousarray(abi["mv"], np.int32).reshape(n, 64)
    ridx = np.ascontiguousarray(abi["refidx"], np.int32).reshape(n, 32)
    rslot = np.ascontiguousarray(abi["refslot"], np.int32)
    nx = abi.get("nx_uids")
    if nx is not None and len(nx):
        rslot = np.where(np.isin(np.asarray(abi["refid"]), nx),
                         rslot | NX_FLAG, rslot)
    rslot = rslot.reshape(n, 32)
    cap = n // 2 + 1
    return mv, ridx, rslot, cap, scan_inter(mv, ridx, rslot, cap)


def _pack_inter(abi, n: int, sec: dict):
    scan = _inter_scan(abi, n)
    if scan is None:
        return ("inter", "zero", 0)
    mv, ridx, rslot, cap, (k, mv_base, ref_base, idx_buf, mv_nu, ref_nu) \
        = scan
    if k >= cap:
        sec["mv16"] = mv.astype(np.int16)
        r8 = np.empty((n, 64), np.int8)
        r8[:, :32] = ridx
        r8[:, 32:] = rslot
        sec["ref8"] = r8
        return ("inter", "dense", 0)
    sec["mv_base"] = mv_base
    sec["ref_base"] = ref_base
    if k == 0:
        return ("inter", "base", 0)
    b = _bucket(k, cap)
    idx = np.full(b, n, np.int32)
    idx[:k] = idx_buf[:k]
    nmv = np.zeros((b, 64), np.int16)
    nmv[:k] = mv_nu[:k]
    nref = np.zeros((b, 64), np.int8)
    nref[:k] = ref_nu[:k]
    sec["nu_idx"] = idx
    sec["nu_mv"] = nmv
    sec["nu_ref"] = nref
    return ("inter", "base", b)


def _coeff_scan(abi, f: str, key: str, grid: int, w: int):
    """(src [grid, w] int32, scan_blocks8's result) of one coefficient
    class, through the decode-time row hints where the ABI has usable
    ones (centropy.pack_frame_cpp; unsorted hints, e.g. ASO, fall back to
    the full scan)."""
    src = np.ascontiguousarray(abi[key], np.int32).reshape(grid, w)
    cap_r = grid // 2 + 1
    cap_v = grid * w // 4 + 1
    nzr = abi.get("_nzr")
    res = None
    if nzr is not None and f in nzr:
        res = gather_blocks8(src, np.ascontiguousarray(nzr[f], np.int32),
                             cap_r, cap_v)
    if res is None:
        res = scan_blocks8(src, cap_r, cap_v)
    return src, cap_r, res


def _pcm_rows(abi):
    return np.nonzero(np.asarray(abi["kind"]) == KIND_IPCM)[0]


def _wtab_rows(abi):
    wt = np.asarray(abi["wtab"])
    return wt, np.nonzero((wt != identity_wtab()).any(axis=(1, 2, 3, 4)))[0]


def pack_wire_raw_numpy(abi, mb_w: int, mb_h: int):
    """pack_wire_raw's readable twin and test oracle: numpy and the C row
    scans, section by section (tests/test_torch_wire.py holds the two
    byte-equal).  Its raw records carry no "full_scans"."""
    n = mb_w * mb_h
    raw: dict = {}
    spec = []
    _pack_meta(abi, n, raw)

    rows, build_ext = _intra_ext(abi, n)
    k = len(rows)
    if k == 0:
        spec.append(("intra", "zero", 0))
    elif _bucket(k, n) >= n:
        spec.append(("intra", "dense", 0))
        raw["in_ext"] = build_ext(slice(None))
    else:
        spec.append(("intra", "sparse", _bucket(k, n)))
        raw["in_idx"] = rows.astype(np.int32)
        raw["in_ext"] = build_ext(rows)

    scan = _inter_scan(abi, n)
    if scan is None:
        spec.append(("inter", "zero", 0))
    else:
        mv, ridx, rslot, cap, (k, mv_base, ref_base, idx_buf, mv_nu,
                               ref_nu) = scan
        if k >= cap:
            spec.append(("inter", "dense", 0))
            raw["mv16"] = mv
            raw["ref8_idx"] = ridx
            raw["ref8_slot"] = rslot
        else:
            spec.append(("inter", "base", _bucket(k, cap) if k else 0))
            raw["mv_base"] = mv_base
            raw["ref_base"] = ref_base
            if k:
                raw["nu_idx"] = np.asarray(idx_buf[:k], np.int32)
                raw["nu_mv"] = mv_nu[:k]
                raw["nu_ref"] = ref_nu[:k]
            raw["nu_k"] = k

    for f, key, cpm, w in _COEFF_FIELDS:
        grid = n * cpm
        src, cap_r, (k, idx_buf, bm_buf, val_buf, nnz, ovf) = \
            _coeff_scan(abi, f, key, grid, w)
        if k == 0:
            spec.append((f, "zero", 0))
            continue
        if k >= cap_r or ovf:
            a16 = src.astype(np.int16)
            if np.array_equal(a16, src):
                spec.append((f, "dense16", 0))
                raw[f + "_src16"] = a16
            else:
                spec.append((f, "dense", 0))
                raw[f + "_src"] = src
            continue
        spec.append((f, "bm8", (_bucket(k, grid),
                                _bucket(nnz, grid * w, lo=128))))
        raw[f + "_idx"] = np.asarray(idx_buf[:k], np.int32)
        raw[f + "_bm"] = bm_buf[:k]
        raw[f + "_val"] = val_buf[:nnz]
        raw[f + "_nnz"] = nnz

    rows = _pcm_rows(abi)
    if len(rows) == 0:
        spec.append(("pcm", "zero", 0))
    else:
        src = np.asarray(abi["pcm"], np.uint8).reshape(n, 384)
        b = _bucket(len(rows), n, lo=1)
        if b >= n:
            spec.append(("pcm", "dense", 0))
            raw["pcm_val"] = src
        else:
            spec.append(("pcm", "sparse", b))
            raw["pcm_idx"] = rows.astype(np.int32)
            raw["pcm_val"] = src[rows]

    wt, rows = _wtab_rows(abi)
    if len(rows) == 0:
        spec.append(("wtab", "zero", 0))
    else:
        b = _bucket(len(rows), MAX_SLICES, lo=1)
        spec.append(("wtab", "sparse", b))
        raw["wt_idx"] = rows[:b].astype(np.int32)
        raw["wt_val"] = wt[rows[:b]].reshape(-1, _WTAB_COLS) \
            .astype(np.int16)
    return raw, tuple(spec)


def pack_wire(abi, mb_w: int, mb_h: int):
    """Host side: dense numpy ABI -> (sections dict, spec tuple), every
    section at its bucket's size (the readable form of pack_wire_raw +
    emit_wire)."""
    n = mb_w * mb_h
    sec = {}
    spec = []
    _pack_meta(abi, n, sec)
    spec.append(_pack_intra(abi, n, sec))
    spec.append(_pack_inter(abi, n, sec))

    for f, key, cpm, w in _COEFF_FIELDS:
        grid = n * cpm
        src, cap_r, (k, idx_buf, bm_buf, val_buf, nnz, ovf) = \
            _coeff_scan(abi, f, key, grid, w)
        if k == 0:
            spec.append((f, "zero", 0))
            continue
        if k >= cap_r or ovf:
            a16 = src.astype(np.int16)
            if np.array_equal(a16, src):
                spec.append((f, "dense16", 0))
                sec[f + "_dense"] = a16
            else:
                spec.append((f, "dense", 0))
                sec[f + "_dense"] = src
            continue
        br = _bucket(k, grid)
        bv = _bucket(nnz, grid * w, lo=128)
        spec.append((f, "bm8", (br, bv)))
        idx = np.full(br, grid, np.int32)
        idx[:k] = idx_buf[:k]
        bmw = (w + 15) // 16
        bm = np.zeros((br, bmw), np.uint16)
        bm[:k] = bm_buf[:k]
        vals = np.zeros(bv, np.int8)
        vals[:nnz] = val_buf[:nnz]
        sec[f + "_idx"] = idx
        sec[f + "_bm"] = bm
        sec[f + "_val"] = vals

    rows = _pcm_rows(abi)
    if len(rows) == 0:
        spec.append(("pcm", "zero", 0))
    else:
        src = np.asarray(abi["pcm"], np.uint8).reshape(n, 384)
        k = len(rows)
        b = _bucket(k, n, lo=1)
        if b >= n:
            spec.append(("pcm", "dense", 0))
            sec["pcm_val"] = src
        else:
            spec.append(("pcm", "sparse", b))
            idx = np.full(b, n, np.int32)
            idx[:k] = rows
            vals = np.zeros((b, 384), np.uint8)
            vals[:k] = src[rows]
            sec["pcm_idx"] = idx
            sec["pcm_val"] = vals

    wt, rows = _wtab_rows(abi)
    if len(rows) == 0:
        spec.append(("wtab", "zero", 0))
    else:
        k = len(rows)
        b = _bucket(k, MAX_SLICES, lo=1)
        spec.append(("wtab", "sparse", b))
        idx = np.full(b, MAX_SLICES, np.int32)
        idx[:k] = rows[:b]
        vals = np.zeros((b, _WTAB_COLS), np.int16)
        vals[:k] = wt[rows[:b]].reshape(-1, _WTAB_COLS)
        sec["wt_idx"] = idx
        sec["wt_val"] = vals
    return sec, tuple(spec)


def wire_nbytes(sections) -> int:
    if isinstance(sections, np.ndarray):
        return sections.nbytes
    return sum(np.asarray(v).nbytes for v in sections.values())


# ---------------------------------------------------------------------------
# spec merge / conform (lockstep batches share one spec per round)
# ---------------------------------------------------------------------------

_ORDER = {"zero": 0, "sparse": 1, "base": 1, "bm8": 1, "dense16": 2,
          "dense": 3}


def _bucket_max(entries):
    """Componentwise max over int-or-tuple buckets."""
    bs = [e[2] for e in entries if _ORDER[e[1]] == 1]
    if not bs:
        return 0
    if isinstance(bs[0], tuple):
        return tuple(max(b[i] for b in bs) for i in range(len(bs[0])))
    return max(bs)


def merge_specs(specs):
    """Superset spec: per field the max scheme / bucket across streams."""
    out = []
    for entries in zip(*specs):
        f = entries[0][0]
        if any(e[0] != f for e in entries):
            raise ValueError(f"specs disagree on field order at {f!r}")
        scheme = max((e[1] for e in entries), key=_ORDER.__getitem__)
        out.append((f, scheme,
                    _bucket_max(entries) if _ORDER[scheme] == 1 else 0))
    return tuple(out)


def conform_sections(sec, spec, target, mb_w: int, mb_h: int):
    """Pad / densify a stream's sections up to the merged round spec."""
    if spec == target:
        return sec
    n = mb_w * mb_h
    out = dict(sec)
    for (f, sch, b), (_, tsch, tb) in zip(spec, target):
        if (sch, b) == (tsch, tb):
            continue
        if f == "intra":
            if tsch == "dense":
                ext = np.zeros((n, 40), np.uint8)
                if sch == "sparse":
                    idx = out.pop("in_idx")
                    vals = out.pop("in_ext")
                    live = idx < n
                    ext[idx[live]] = vals[live]
                elif sch == "dense":
                    ext = out["in_ext"]
                out["in_ext"] = ext
            else:  # sparse target
                idx = np.full(tb, n, np.int32)
                vals = np.zeros((tb, 40), np.uint8)
                if sch == "sparse":
                    idx[:b] = out.pop("in_idx")
                    vals[:b] = out.pop("in_ext")
                out["in_idx"] = idx
                out["in_ext"] = vals
        elif f == "inter":
            if tsch == "dense":
                if sch != "dense":
                    mv16 = np.zeros((n, 64), np.int16)
                    ref8 = np.full((n, 64), -1, np.int8)
                    if sch == "base":
                        mv16[:] = np.tile(out.pop("mv_base"), 16)
                        rb = out.pop("ref_base")
                        ref8[:, :32] = np.repeat(
                            rb[:, 0:2], 16, axis=0).reshape(n, 32)
                        ref8[:, 32:] = np.repeat(
                            rb[:, 2:4], 16, axis=0).reshape(n, 32)
                        if b:
                            idx = out.pop("nu_idx")
                            live = idx < n
                            mv16[idx[live]] = out.pop("nu_mv")[live]
                            ref8[idx[live]] = out.pop("nu_ref")[live]
                    out["mv16"] = mv16
                    out["ref8"] = ref8
            else:  # base target
                if sch == "zero":
                    out["mv_base"] = np.zeros((n, 4), np.int16)
                    out["ref_base"] = np.full((n, 4), -1, np.int8)
                if tb:
                    idx = np.full(tb, n, np.int32)
                    nmv = np.zeros((tb, 64), np.int16)
                    nref = np.zeros((tb, 64), np.int8)
                    if sch == "base" and b:
                        idx[:b] = out.pop("nu_idx")
                        nmv[:b] = out.pop("nu_mv")
                        nref[:b] = out.pop("nu_ref")
                    out["nu_idx"] = idx
                    out["nu_mv"] = nmv
                    out["nu_ref"] = nref
        elif f == "pcm":
            if tsch == "dense":
                dense = np.zeros((n, 384), np.uint8)
                if sch == "sparse":
                    idx = out.pop("pcm_idx")
                    live = idx < n
                    dense[idx[live]] = out["pcm_val"][live]
                elif sch == "dense":
                    dense = out["pcm_val"]
                out["pcm_val"] = dense
            else:
                idx = np.full(tb, n, np.int32)
                vals = np.zeros((tb, 384), np.uint8)
                if sch == "sparse":
                    idx[:b] = out.pop("pcm_idx")
                    vals[:b] = out["pcm_val"]
                out["pcm_idx"] = idx
                out["pcm_val"] = vals
        elif f == "wtab":
            idx = np.full(tb, MAX_SLICES, np.int32)
            vals = np.zeros((tb, _WTAB_COLS), np.int16)
            if sch == "sparse":
                idx[:b] = out.pop("wt_idx")
                vals[:b] = out.pop("wt_val")
            out["wt_idx"] = idx
            out["wt_val"] = vals
        elif f in _COEFF_SHAPES:
            cpm, w = next((c, ww) for ff, _, c, ww in _COEFF_FIELDS
                          if ff == f)
            grid = n * cpm
            if tsch in ("dense", "dense16"):
                ddt = np.int16 if tsch == "dense16" else np.int32
                dense = np.zeros((grid, w), ddt)
                if sch == "bm8":
                    idx = out.pop(f + "_idx")
                    bm = out.pop(f + "_bm")
                    vals = out.pop(f + "_val")
                    dense = _expand_bm8_np(idx, bm, vals, grid, w) \
                        .astype(ddt)
                elif sch in ("dense", "dense16"):
                    dense = out[f + "_dense"].astype(ddt)
                out[f + "_dense"] = dense
            else:  # bm8 target: pad row/val buckets
                tbr, tbv = tb
                idx = np.full(tbr, grid, np.int32)
                bmw = (w + 15) // 16
                bm = np.zeros((tbr, bmw), np.uint16)
                vals = np.zeros(tbv, np.int8)
                if sch == "bm8":
                    br, bv = b
                    idx[:br] = out.pop(f + "_idx")
                    bm[:br] = out.pop(f + "_bm")
                    vals[:bv] = out.pop(f + "_val")
                out[f + "_idx"] = idx
                out[f + "_bm"] = bm
                out[f + "_val"] = vals
    return out


def _expand_bm8_np(idx, bm, vals, grid: int, w: int):
    """Host-side bm8 -> dense int32 (a bm8 lane under a dense target)."""
    br, bmw = bm.shape
    bits = (bm[:, :, None] >> np.arange(16, dtype=np.uint16)) & 1
    mask = bits.reshape(br, bmw * 16)[:, :w].astype(bool)
    dense = np.zeros((grid + 1, w), np.int32)
    rows = np.zeros((br, w), np.int32)
    rows[mask] = vals[:int(mask.sum())].astype(np.int32)
    dense[np.minimum(idx, grid)] = rows
    return dense[:grid]


# ---------------------------------------------------------------------------
# device-side unpack: [B, total] uint8 -> the dense ABI [B, ...] int32, one
# offset table for every lane of a round (they share its spec)
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int8): torch.int8,
                 # bitmaps are read as int16 and masked to 16 bits:
                 # uint16 tensors have few operators
                 np.dtype(np.uint16): torch.int16,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32}
_IDENTITY_WTAB = torch.from_numpy(identity_wtab().astype(np.int32))


def _read(buf, table, name):
    """Section `name` of every lane: [B, *shape] of its dtype, a view of
    buf [B, total] uint8."""
    off, dt, shape = table[name]
    isz = np.dtype(dt).itemsize
    nbytes = int(np.prod(shape)) * isz
    if off % isz or buf.stride(0) % isz or buf.stride(1) != 1:
        raise ValueError(f"wire section {name}: offset {off} or row stride "
                         f"{buf.stride(0)} not a multiple of {isz}")
    seg = buf[:, off:off + nbytes]
    return seg.view(_TORCH_DTYPES[np.dtype(dt)]).reshape(
        (buf.shape[0],) + tuple(shape))


def _i32(x):
    return x.to(torch.int32)


def _scatter_rows(base, idx, rows):
    """base [B, m, ...] with row idx[b, j] of lane b replaced by rows[b,
    j]; idx entries == m (bucket padding) land on a sentinel row that is
    dropped.  Duplicate indices occur only there."""
    B, m = base.shape[:2]
    out = torch.cat([base, base.new_zeros((B, 1) + base.shape[2:])], 1)
    bi = torch.arange(B, device=base.device)[:, None]
    out[bi, idx.long()] = rows
    return out[:, :m]


def _scatter_bm8(idx, bm, vals, grid: int, w: int):
    """bm8 sections of every lane -> dense [B, grid, w] int32.  vals are
    int8 (sign-extended); each lane's running count of set bits restarts
    at its own row of the batch."""
    B, br, bmw = bm.shape
    bits = (_i32(bm)[..., None] & 0xFFFF) >> torch.arange(
        16, dtype=torch.int32, device=bm.device)
    mask = (bits & 1).reshape(B, br, bmw * 16)[:, :, :w]
    flat = mask.reshape(B, -1)
    pos = torch.cumsum(flat, 1) - 1
    bv = vals.shape[1]
    gathered = torch.gather(_i32(vals), 1, pos.clamp(0, bv - 1)) * flat
    dense = torch.zeros((B, grid, w), dtype=torch.int32, device=bm.device)
    return _scatter_rows(dense, idx, gathered.reshape(B, br, w))


def unpack_wire(buf, mb_w: int, mb_h: int, spec) -> dict:
    """Wire buffers buf [B, total] uint8 (one lane a row, laid out per
    `spec`) -> dict of the dense ABI's [B, ...] int32 tensors on buf's
    device, as decode_frames_batch_fn takes them: unpack_wire_plain for a
    CPU buffer; for a CUDA buffer kernel K12 and, where coefficient
    classes ship as bm8, one call of K8 for all of them
    (ops/kernels/unpack_wire.py), which raise on a buffer they do not
    take."""
    # imported here: the wrapper module imports this one
    from .kernels.unpack_wire import unpack_wire as unpack_wire_kernel
    return unpack_wire_kernel(buf, mb_w, mb_h, spec)


def unpack_wire_plain(buf, mb_w: int, mb_h: int, spec) -> dict:
    """The plain version of unpack_wire (eager torch, ~110 launches a
    call), and K12's on the CPU.  All-zero coefficient and PCM classes
    are left out (residual_planes skips them).

    refid is not shipped: within one picture the DPB slot identifies the
    reference, and deblock's bS test compares refids only for equality
    and validity, which the injective uid -> slot substitution keeps.
    Cells referencing non-existing (gap) pictures arrive with NX_FLAG
    set: refid keeps the flag (a distinct identity), refslot drops it
    (the slot MC reads).

    Each coefficient class shipped as bm8 is expanded by kernel K8
    (ops/kernels/unpack_bm8.py, its one-class form a class) on a CUDA
    device, by _scatter_bm8 on the CPU."""
    # imported here: the wrapper module imports this one (_scatter_bm8)
    from .kernels.unpack_bm8 import unpack_bm8
    n = mb_w * mb_h
    table, total = _offsets(spec, n)
    if buf.dtype != torch.uint8 or buf.dim() != 2 or buf.shape[1] != total:
        raise ValueError(f"wire buffer {buf.dtype} {tuple(buf.shape)}, "
                         f"expected uint8 [B, {total}]")
    B = buf.shape[0]
    dev = buf.device
    sd = dict((f, (s, b)) for f, s, b in spec)

    m = _i32(_read(buf, table, "meta6"))
    fl = m[..., 3]
    tab = _i32(_read(buf, table, "slice8"))
    sid = m[..., 2] & 15
    dbo = (m[..., 2] >> 4) & 1           # per-MB deblock-disable override
    nzm = m[..., 4] | (m[..., 5] << 8)
    sid_l = sid.long()
    out = {
        "kind": m[..., 0], "qp": m[..., 1], "slice_id": sid,
        "tr8": fl & 1,
        "mb_avail": torch.stack([(fl >> b) & 1 for b in (1, 2, 3)], -1),
        "i16_mode": (fl >> 4) & 3, "chroma_mode": (fl >> 6) & 3,
        "disable_idc": torch.where(dbo == 1, 1,
                                   torch.gather(tab[..., 0], 1, sid_l)),
        "alpha_off": torch.gather(tab[..., 1], 1, sid_l),
        "beta_off": torch.gather(tab[..., 2], 1, sid_l),
        "slogwd": tab[..., 3:5].contiguous(),
        "nz": torch.stack([(nzm >> b) & 1 for b in range(16)], -1)
            .reshape(B, n, 4, 4),
    }

    sch, b = sd["intra"]
    if sch == "zero":
        ext = torch.zeros((B, n, 40), dtype=torch.int32, device=dev)
    elif sch == "dense":
        ext = _i32(_read(buf, table, "in_ext"))
    else:
        ext = _scatter_rows(
            torch.zeros((B, n, 40), dtype=torch.int32, device=dev),
            _read(buf, table, "in_idx"), _i32(_read(buf, table, "in_ext")))
    out["i4_modes"] = ext[..., 0:16]
    out["i4_avail"] = torch.stack(
        [(ext[..., 16:32] >> b) & 1 for b in range(4)], -1)
    out["i8_modes"] = ext[..., 32:36]
    out["i8_avail"] = torch.stack(
        [(ext[..., 36:40] >> b) & 1 for b in range(4)], -1)

    sch, b = sd["inter"]
    if sch == "zero":
        mv = torch.zeros((B, n, 64), dtype=torch.int32, device=dev)
        ref = torch.full((B, n, 64), -1, dtype=torch.int32, device=dev)
    elif sch == "dense":
        mv = _i32(_read(buf, table, "mv16"))
        ref = _i32(_read(buf, table, "ref8"))
    else:
        mvb = _i32(_read(buf, table, "mv_base"))
        rb = _i32(_read(buf, table, "ref_base"))
        mv = mvb.repeat(1, 1, 16)                                # [B, n, 64]
        ref = torch.cat([rb[..., 0:2].repeat(1, 1, 16),
                         rb[..., 2:4].repeat(1, 1, 16)], -1)
        if b:
            idx = _read(buf, table, "nu_idx")
            mv = _scatter_rows(mv, idx, _i32(_read(buf, table, "nu_mv")))
            ref = _scatter_rows(ref, idx, _i32(_read(buf, table, "nu_ref")))
    out["mv"] = mv.reshape(B, n, 4, 4, 2, 2)
    out["refidx"] = ref[..., :32].reshape(B, n, 4, 4, 2)
    rs = ref[..., 32:].reshape(B, n, 4, 4, 2)
    out["refid"] = rs
    out["refslot"] = torch.where(rs >= 0, rs & (NX_FLAG - 1), rs)

    for f, key, cpm, w in _COEFF_FIELDS:
        grid = n * cpm
        sch, b = sd[f]
        shape = (B, n) + _COEFF_SHAPES[f]
        if sch == "zero":
            continue                   # left out: residual_planes skips it
        if sch in ("dense", "dense16"):
            out[key] = _i32(_read(buf, table, f + "_dense")).reshape(shape)
        else:
            out[key] = unpack_bm8(
                _read(buf, table, f + "_idx"), _read(buf, table, f + "_bm"),
                _read(buf, table, f + "_val"), grid, w).reshape(shape)

    sch, b = sd["pcm"]
    if sch == "dense":
        out["pcm"] = _i32(_read(buf, table, "pcm_val"))
    elif sch == "sparse":
        out["pcm"] = _scatter_rows(
            torch.zeros((B, n, 384), dtype=torch.int32, device=dev),
            _read(buf, table, "pcm_idx"), _i32(_read(buf, table, "pcm_val")))

    out = {k: v.contiguous() for k, v in out.items()}
    # every lane's weight table is the identity but for the shipped rows
    # (an expanded view where no lane ships one)
    ident = device_copy(_IDENTITY_WTAB, dev).expand(
        (B,) + _IDENTITY_WTAB.shape)
    if sd["wtab"][0] == "zero":
        out["wtab"] = ident
    else:
        vals = _i32(_read(buf, table, "wt_val")).reshape(
            (B, -1) + _IDENTITY_WTAB.shape[1:])
        out["wtab"] = _scatter_rows(ident, _read(buf, table, "wt_idx"),
                                    vals)
    return out
