"""ctypes binding for the C++ host entropy library (host/cpp/entropy.cpp).

The library is built with g++ on first use into the package's git-ignored
`_build/` directory; its file name carries a hash of the sources and
flags, so an edit rebuilds it and a stale build never loads.  The
pure-Python parser in mb/parse.py remains the differential-testing
oracle.

Instruments: `gil_meter` sums the time spent inside the library's calls,
which ctypes makes with the GIL released; ARROW_H264_STATS=1 loads the
build with per-section counters (`read_stats`); ARROW_H264_SANITIZE=1
the build with ASAN and UBSAN (the library parses untrusted bitstreams).

`CppPictureParse` mirrors PictureParse closely enough for the decode
loops; `pack_frame_cpp` assembles the FrameABI mostly zero-copy from the
C++-filled arrays.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..bitstream.params import PPS, SPS
from ..bitstream.slicehdr import SliceHeader
from ..ops.abi import FrameABI

_PKG = Path(__file__).resolve().parent.parent
_CPP = Path(__file__).resolve().parent / "cpp"
_SRC = [_CPP / "entropy.cpp", _CPP / "entropy_mb.inc",
        _CPP / "entropy_inter.inc", _CPP / "tables_gen.h"]
BUILD_DIR = _PKG / "_build"

ABI_VERSION = 6


class _PicBuf(C.Structure):
    _fields_ = [
        ("mb_w", C.c_int32), ("mb_h", C.c_int32),
        ("transform_8x8_mode", C.c_int32), ("constrained_intra", C.c_int32),
        ("direct_8x8_inference", C.c_int32),
    ] + [(name, C.c_void_p) for name in (
        "kind", "cat", "qp", "tr8", "nz", "slice_id_arr", "disable_idc",
        "alpha_off", "beta_off", "luma4", "luma8", "luma_dc", "chroma_dc",
        "chroma_ac", "i4_modes", "i8_modes", "i16_mode", "chroma_mode",
        "i4_avail", "i8_avail", "mb_avail", "pcm", "mv", "refidx", "cbp",
        "refslot", "refid",
        "tc_luma", "tc_cb", "tc_cr", "mode_map", "slice_map", "mv_grid",
        "ref_grid", "order_grid", "direct_grid", "cbf_luma", "cbf_luma_dc",
        "cbf_cdc", "cbf_cac", "mvd_grid",
        "nzr_l4", "nzr_l8", "nzr_ca", "nzr_ldc", "nzr_cdc", "nzr_cnt")]


class _SliceParams(C.Structure):
    _fields_ = [
        ("slice_type", C.c_int32), ("first_mb", C.c_int32),
        ("slice_qp", C.c_int32), ("cabac", C.c_int32),
        ("cabac_init_idc", C.c_int32), ("num_ref_l0", C.c_int32),
        ("num_ref_l1", C.c_int32), ("direct_spatial", C.c_int32),
        ("slice_id", C.c_int32), ("cur_poc", C.c_int32),
        ("disable_deblock_idc", C.c_int32), ("alpha_off", C.c_int32),
        ("beta_off", C.c_int32),
        ("col_mv", C.c_void_p), ("col_refidx", C.c_void_p),
        ("col_ref_uid", C.c_void_p),
        ("col_longterm", C.c_int32), ("col_poc", C.c_int32),
        ("l0_poc", C.c_void_p), ("l0_lt", C.c_void_p), ("l0_uid", C.c_void_p),
        ("l0_len", C.c_int32),
        ("l1_poc", C.c_void_p), ("l1_lt", C.c_void_p), ("l1_uid", C.c_void_p),
        ("l1_len", C.c_int32),
        ("l0_slot", C.c_void_p), ("l1_slot", C.c_void_p),
        ("field_pic", C.c_int32),
        ("next_mb", C.c_void_p),
    ]


_libs: dict = {}


def _variant(sanitize: bool, trace: bool, stats: bool) -> tuple[str, list]:
    """(file name stem, g++ flags) of one build of the library."""
    name = "libh264entropy"
    flags = ["-O3", "-march=native", "-funroll-loops"]
    if sanitize:
        name += "_asan"
        flags = ["-O1", "-g", "-fsanitize=address,undefined",
                 "-fno-sanitize-recover=undefined"]
    if trace:
        name += "_trace"
        flags.append("-DH264E_TRACE")
    if stats:
        name += "_stats"
        flags.append("-DH264E_STATS")
    return name, flags + ["-shared", "-fPIC"]


def lib_path(sanitize: bool = False, trace: bool = False,
             stats: bool = False) -> Path:
    """Where the library for these sources and flags is built."""
    name, flags = _variant(sanitize, trace, stats)
    h = hashlib.sha256(" ".join(flags).encode())
    for src in _SRC:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def load_lib(sanitize: bool | None = None, trace: bool = False):
    """Build (if missing) and load the host entropy library.

    sanitize=True (None: ARROW_H264_SANITIZE=1) builds with ASAN and
    UBSAN, for a process started with the ASAN runtime preloaded
    (LD_PRELOAD); the library parses untrusted bitstreams.  trace=True
    builds with -DH264E_TRACE: every syntax-element read is recorded into
    a caller-provided buffer with the same records the Python
    TracingBitReader produces (--trace-se on the C++ engine).
    ARROW_H264_STATS=1 builds with -DH264E_STATS (per-section counters,
    read with read_stats()).  Both variables are read on every call, so
    that all the module's calls in a process load the same build.  Each
    variant is a separate .so so they coexist; the load cache is keyed by
    the three flags.
    """
    if sanitize is None:
        sanitize = os.environ.get("ARROW_H264_SANITIZE") == "1"
    stats = os.environ.get("ARROW_H264_STATS") == "1"
    key = (sanitize, trace, stats)
    if key in _libs:
        return _libs[key]
    path = lib_path(*key)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_variant(*key)[1], "-o", str(tmp),
                        str(_SRC[0])], check=True, cwd=str(_CPP))
        os.replace(tmp, path)
    if sanitize:
        # the sanitizers' runtimes, for the library's undefined symbols
        for rt in ("libasan.so", "libubsan.so"):
            C.CDLL(subprocess.run(["g++", f"-print-file-name={rt}"],
                                  capture_output=True, text=True,
                                  check=True).stdout.strip(),
                   mode=C.RTLD_GLOBAL)
    lib = C.CDLL(str(path))
    lib.h264e_parse_slice.restype = C.c_int
    lib.h264e_parse_slice.argtypes = [C.POINTER(_PicBuf),
                                      C.POINTER(_SliceParams),
                                      C.c_void_p, C.c_int64, C.c_int64]
    lib.h264e_reset_pic.restype = None
    lib.h264e_reset_pic.argtypes = [C.POINTER(_PicBuf)]
    lib.h264e_build_col.restype = None
    lib.h264e_build_col.argtypes = [
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p, C.c_int, C.c_int,
        C.c_int, C.c_void_p, C.c_void_p, C.c_void_p]
    if trace:
        lib.h264e_trace_set.restype = None
        lib.h264e_trace_set.argtypes = [C.c_void_p, C.c_long]
        lib.h264e_trace_count.restype = C.c_long
        lib.h264e_trace_count.argtypes = []
    lib.h264e_scan_rows32.restype = C.c_long
    lib.h264e_scan_rows32.argtypes = [
        C.c_void_p, C.c_long, C.c_int, C.c_void_p, C.c_void_p, C.c_long,
        C.POINTER(C.c_int)]
    lib.h264e_scan_blocks8.restype = C.c_long
    lib.h264e_scan_blocks8.argtypes = [
        C.c_void_p, C.c_long, C.c_int, C.c_void_p, C.c_void_p, C.c_void_p,
        C.c_long, C.c_long, C.POINTER(C.c_long), C.POINTER(C.c_int)]
    lib.h264e_gather_blocks8.restype = C.c_long
    lib.h264e_gather_blocks8.argtypes = [
        C.c_void_p, C.c_long, C.c_int, C.c_void_p, C.c_long, C.c_void_p,
        C.c_void_p, C.c_void_p, C.c_long, C.c_long, C.POINTER(C.c_long),
        C.POINTER(C.c_int)]
    lib.h264e_scan_inter.restype = C.c_long
    lib.h264e_scan_inter.argtypes = [
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_long, C.c_void_p,
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p, C.c_long]
    lib.h264e_abi_version.restype = C.c_int
    lib.h264e_abi_version.argtypes = []
    if stats:
        lib.h264e_stats.restype = C.POINTER(C.c_uint64 * len(_STATS_FIELDS))
        lib.h264e_stats.argtypes = []
    if lib.h264e_abi_version() != ABI_VERSION:
        raise RuntimeError(f"{path}: ABI version {lib.h264e_abi_version()},"
                           f" expected {ABI_VERSION}")
    _libs[key] = lib
    return lib


_STATS_FIELDS = ("decisions", "bypasses", "blocks", "coeffs", "mbs",
                 "sig_iters", "t_resid", "t_scatter", "t_motion",
                 "t_total", "t_skip", "t_tail", "t_imb", "t_presid")


def read_stats() -> dict:
    """Counters of the -DH264E_STATS build (ARROW_H264_STATS=1), summed
    since the library was loaded; t_* fields are rdtsc cycle sums.  The
    counters are globals of the C source that every call adds to without
    a lock, so they are exact only when one thread calls the library."""
    vals = load_lib().h264e_stats().contents
    return dict(zip(_STATS_FIELDS, vals))


class gil_meter:
    """Accounting for the time spent inside the library's calls, which
    ctypes makes with the GIL released.

    That time is the share of host work that can run on several threads
    at once (BatchDecoder's pool); the rest of a lane's parse and pack
    (Python and numpy) serialises on the GIL.  When `enabled` is False a
    call costs one attribute read.  `add` sums under a lock, so the total
    is whole when the pool's threads call at once.  `calls` splits
    `released_s` by C function."""
    enabled = False
    released_s = 0.0
    calls: dict = {}
    _lock = threading.Lock()

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls.released_s = 0.0
            cls.calls = {}

    @classmethod
    def add(cls, dt: float, name: str = "other") -> None:
        if cls.enabled:
            with cls._lock:
                cls.released_s += dt
                cls.calls[name] = cls.calls.get(name, 0.0) + dt


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def scan_rows32(src2d: np.ndarray, cap: int):
    """C-side nonzero-row scan + int16 gather.

    src2d: contiguous [rows, cols] int32.  Returns (k_total, idx [cap]
    i32, vals [cap, cols] i16, overflow).  If k_total > cap only the
    first cap rows were written (caller goes dense)."""
    lib = load_lib()
    rows, cols = src2d.shape
    idx = np.empty(cap, np.int32)
    vals = np.empty((cap, cols), np.int16)
    ovf = C.c_int(0)
    t0 = time.perf_counter() if gil_meter.enabled else None
    k = lib.h264e_scan_rows32(_ptr(src2d), rows, cols, _ptr(idx),
                              _ptr(vals), cap, C.byref(ovf))
    if t0 is not None:
        gil_meter.add(time.perf_counter() - t0, "h264e_scan_rows32")
    return int(k), idx, vals, bool(ovf.value)


def scan_blocks8(src2d: np.ndarray, cap_r: int, cap_v: int):
    """C-side bitmap+packed-int8 scan (ops/wire.py bm8 scheme).

    src2d: contiguous [rows, cols] int32, cols a multiple of 16 (or 8).
    Returns (k_rows, idx [cap_r] i32, bm [cap_r, ceil(cols/16)] u16,
    vals [cap_v] i8, nnz_written, overflow).  overflow is set when any
    value misses int8 or nnz exceeds cap_v; k_rows > cap_r means the
    row cap was hit — either way the caller falls back to dense."""
    lib = load_lib()
    rows, cols = src2d.shape
    bmw = (cols + 15) // 16
    idx = np.empty(cap_r, np.int32)
    bm = np.empty((cap_r, bmw), np.uint16)
    vals = np.empty(cap_v, np.int8)
    nnz = C.c_long(0)
    ovf = C.c_int(0)
    t0 = time.perf_counter() if gil_meter.enabled else None
    k = lib.h264e_scan_blocks8(_ptr(src2d), rows, cols, _ptr(idx), _ptr(bm),
                               _ptr(vals), cap_r, cap_v, C.byref(nnz),
                               C.byref(ovf))
    if t0 is not None:
        gil_meter.add(time.perf_counter() - t0, "h264e_scan_blocks8")
    return int(k), idx, bm, vals, int(nnz.value), bool(ovf.value)


def gather_blocks8(src2d: np.ndarray, rows_hint: np.ndarray,
                   cap_r: int, cap_v: int):
    """Hinted scan_blocks8: visit only the decode-time recorded rows.

    Returns the scan_blocks8 tuple, or None when the hint is unusable
    (non-ascending rows, e.g. ASO) — the caller falls back to the full
    scan.  Output is byte-identical to scan_blocks8 (all-zero hinted
    rows are skipped in C)."""
    lib = load_lib()
    rows, cols = src2d.shape
    bmw = (cols + 15) // 16
    idx = np.empty(cap_r, np.int32)
    bm = np.empty((cap_r, bmw), np.uint16)
    vals = np.empty(cap_v, np.int8)
    nnz = C.c_long(0)
    ovf = C.c_int(0)
    t0 = time.perf_counter() if gil_meter.enabled else None
    k = lib.h264e_gather_blocks8(
        _ptr(src2d), rows, cols, _ptr(rows_hint), len(rows_hint),
        _ptr(idx), _ptr(bm), _ptr(vals), cap_r, cap_v,
        C.byref(nnz), C.byref(ovf))
    if t0 is not None:
        gil_meter.add(time.perf_counter() - t0, "h264e_gather_blocks8")
    if k < 0:
        return None
    return int(k), idx, bm, vals, int(nnz.value), bool(ovf.value)


def scan_inter(mv: np.ndarray, refidx: np.ndarray, refslot: np.ndarray,
               cap: int):
    """C-side MV/ref uniformity scan (ops/wire.py inter base scheme).

    mv [n,16,2,2] / refidx,refslot [n,16,2], all contiguous int32.
    Returns (k_nonuniform, mv_base [n,4] i16, ref_base [n,4] i8,
    idx [cap] i32, mv_nu [cap,64] i16, ref_nu [cap,64] i8)."""
    lib = load_lib()
    n = mv.shape[0]
    mv_base = np.empty((n, 4), np.int16)
    ref_base = np.empty((n, 4), np.int8)
    idx = np.empty(cap, np.int32)
    mv_nu = np.empty((cap, 64), np.int16)
    ref_nu = np.empty((cap, 64), np.int8)
    t0 = time.perf_counter() if gil_meter.enabled else None
    k = lib.h264e_scan_inter(_ptr(mv), _ptr(refidx), _ptr(refslot), n,
                             _ptr(mv_base), _ptr(ref_base), _ptr(idx),
                             _ptr(mv_nu), _ptr(ref_nu), cap)
    if t0 is not None:
        gil_meter.add(time.perf_counter() - t0, "h264e_scan_inter")
    return int(k), mv_base, ref_base, idx, mv_nu, ref_nu


class PicBufPool:
    """Recycles the ~40MB of per-picture parse arrays across pictures.

    Fresh allocation + first-touch page faults cost ~30-50ms per 1080p
    picture; a recycled buffer is re-initialized by the C++
    h264e_reset_pic pre-pass (selective clears keyed on the previous
    picture's cbp records) in ~1-2ms.

    Safety: arrays may still be referenced downstream (e.g. a zero-copy
    torch.from_numpy on the CPU aliases numpy memory), so acquire()
    hands out an entry only when every array's refcount shows the pool as
    the sole owner; entries also sit out at least one picture
    (min-2-deep queue) before reuse.
    """

    def __init__(self):
        self._free: dict[tuple, list[dict]] = {}

    def acquire(self, key: tuple) -> dict | None:
        import sys
        entries = self._free.get(key)
        if not entries or len(entries) < 2:
            return None
        for i, a in enumerate(entries[:2]):
            # pool-owned only: dict ref + loop var + getrefcount arg == 3
            if all(sys.getrefcount(v) == 3 for v in a.values()):
                return entries.pop(i)
        return None

    def release(self, key: tuple, arrays: dict) -> None:
        self._free.setdefault(key, []).append(arrays)


def _alloc_arrays(mb_w: int, mb_h: int) -> dict:
    n = mb_w * mb_h
    h4, w4 = mb_h * 4, mb_w * 4
    h2, w2 = mb_h * 2, mb_w * 2
    z = lambda *shape: np.zeros(shape, np.int32)
    # NOTE: every array starts all-zero; h264e_reset_pic establishes the
    # -1 / sentinel initial values (and is a no-op on the residual arrays
    # here because a zero buffer records no previously-coded blocks).
    return {
        "kind": z(n), "cat": z(n), "qp": z(n), "tr8": z(n),
        "nz": z(n, 4, 4), "slice_id": z(n), "disable_idc": z(n),
        "alpha_off": z(n), "beta_off": z(n),
        "luma4": z(n, 16, 4, 4), "luma8": z(n, 4, 8, 8),
        "luma_dc": z(n, 4, 4), "chroma_dc": z(n, 2, 2, 2),
        "chroma_ac": z(n, 2, 2, 2, 4, 4),
        "i4_modes": z(n, 16), "i8_modes": z(n, 4),
        "i16_mode": z(n), "chroma_mode": z(n),
        "i4_avail": z(n, 16, 4), "i8_avail": z(n, 4, 4),
        "mb_avail": z(n, 3), "pcm": z(n, 384),
        "mv": z(n, 4, 4, 2, 2),
        "refidx": z(n, 4, 4, 2),
        "refslot": z(n, 4, 4, 2), "refid": z(n, 4, 4, 2),
        "cbp": z(n, 2),
        "tc_luma": z(h4, w4), "tc_cb": z(h2, w2), "tc_cr": z(h2, w2),
        "mode_map": z(h4, w4),
        "slice_map": z(mb_h, mb_w),
        "mv_grid": z(2, h4, w4, 2),
        "ref_grid": z(2, h4, w4),
        "order_grid": z(h4, w4),
        "direct_grid": z(h4, w4),
        "cbf_luma": z(h4, w4), "cbf_luma_dc": z(mb_h, mb_w),
        "cbf_cdc": z(2, mb_h, mb_w), "cbf_cac": z(2, h2, w2),
        "mvd_grid": z(2, h4, w4, 2),
        # nonzero-row hints the C++ parser records (ops/wire.py's pack
        # reads them instead of scanning every row); caps are the full
        # grids so appends never overflow
        "nzr_l4": z(n * 16), "nzr_l8": z(n * 4), "nzr_ca": z(n * 8),
        "nzr_ldc": z(n), "nzr_cdc": z(n), "nzr_cnt": z(5),
    }


class CppPictureParse:
    """C++-backed per-picture parse state (drop-in for api.Decoder)."""

    def __init__(self, sps: SPS, pps: PPS, pool: PicBufPool | None = None,
                 trace: bool = False):
        self.sps, self.pps = sps, pps
        self.mb_w = sps.pic_width_in_mbs
        self.mb_h = sps.pic_height_in_map_units
        self.headers: list[SliceHeader] = []
        self.slice_reflists: list[tuple] = []
        # trace: use the -DH264E_TRACE build and convert its per-read
        # records into the caller's SE log (api --trace-se on cpp)
        self._trace = trace
        self._pool = pool
        self._pool_key = (self.mb_w, self.mb_h)
        a = pool.acquire(self._pool_key) if pool is not None else None
        if a is None:
            a = _alloc_arrays(self.mb_w, self.mb_h)
        self.a = a
        # the ~45 ctypes pointer-field assignments below cost ~1.5 ms per
        # picture; the pointers only depend on the pooled array set, so
        # the filled _PicBuf rides the pool with its arrays and only the
        # per-parameter-set scalars are refreshed on reuse
        pb = a.get("_pb")
        if pb is not None:
            self.pb = pb
            pb.transform_8x8_mode = pps.transform_8x8_mode_flag
            pb.constrained_intra = pps.constrained_intra_pred_flag
            pb.direct_8x8_inference = sps.direct_8x8_inference_flag
            self._reset()
            self._keepalive = []
            self._fmo_tabs = {}
            return
        self.pb = _PicBuf(
            mb_w=self.mb_w, mb_h=self.mb_h,
            transform_8x8_mode=pps.transform_8x8_mode_flag,
            constrained_intra=pps.constrained_intra_pred_flag,
            direct_8x8_inference=sps.direct_8x8_inference_flag,
        )
        for name, key in (
                ("kind", "kind"), ("cat", "cat"), ("qp", "qp"), ("tr8", "tr8"),
                ("nz", "nz"), ("slice_id_arr", "slice_id"),
                ("disable_idc", "disable_idc"), ("alpha_off", "alpha_off"),
                ("beta_off", "beta_off"), ("luma4", "luma4"),
                ("luma8", "luma8"), ("luma_dc", "luma_dc"),
                ("chroma_dc", "chroma_dc"), ("chroma_ac", "chroma_ac"),
                ("i4_modes", "i4_modes"), ("i8_modes", "i8_modes"),
                ("i16_mode", "i16_mode"), ("chroma_mode", "chroma_mode"),
                ("i4_avail", "i4_avail"), ("i8_avail", "i8_avail"),
                ("mb_avail", "mb_avail"), ("pcm", "pcm"), ("mv", "mv"),
                ("refidx", "refidx"), ("cbp", "cbp"),
                ("refslot", "refslot"), ("refid", "refid"),
                ("tc_luma", "tc_luma"),
                ("tc_cb", "tc_cb"), ("tc_cr", "tc_cr"),
                ("mode_map", "mode_map"), ("slice_map", "slice_map"),
                ("mv_grid", "mv_grid"), ("ref_grid", "ref_grid"),
                ("order_grid", "order_grid"), ("direct_grid", "direct_grid"),
                ("cbf_luma", "cbf_luma"), ("cbf_luma_dc", "cbf_luma_dc"),
                ("cbf_cdc", "cbf_cdc"), ("cbf_cac", "cbf_cac"),
                ("mvd_grid", "mvd_grid"),
                ("nzr_l4", "nzr_l4"), ("nzr_l8", "nzr_l8"),
                ("nzr_ca", "nzr_ca"), ("nzr_ldc", "nzr_ldc"),
                ("nzr_cdc", "nzr_cdc"), ("nzr_cnt", "nzr_cnt")):
            setattr(self.pb, name, _ptr(a[key]))
        a["_pb"] = self.pb        # pooled with the arrays it points into
        self._reset()
        self._keepalive = []
        # FMO: NextMbAddress tables per slice_group_change_cycle (types
        # 3-5 re-derive the map per slice; static types share one entry)
        self._fmo_tabs: dict[int, np.ndarray] = {}

    def _reset(self) -> None:
        """Set the buffers' initial values (h264e_reset_pic)."""
        lib = load_lib(trace=self._trace)
        t0 = time.perf_counter() if gil_meter.enabled else None
        lib.h264e_reset_pic(C.byref(self.pb))
        if t0 is not None:
            gil_meter.add(time.perf_counter() - t0, "h264e_reset_pic")

    def nz_row_hints(self) -> dict:
        """Decode-time nonzero coeff rows per wire field (views into the
        pooled buffers — valid until retire()).  Keys match
        ops/wire._COEFF_FIELDS short names."""
        a, cnt = self.a, self.a["nzr_cnt"]
        return {"l4": a["nzr_l4"][:cnt[0]], "l8": a["nzr_l8"][:cnt[1]],
                "ca": a["nzr_ca"][:cnt[2]], "ldc": a["nzr_ldc"][:cnt[3]],
                "cdc": a["nzr_cdc"][:cnt[4]]}

    def retire(self) -> None:
        """Return the arrays to the pool (caller: api.Decoder, once the
        picture is committed and its device upload dispatched)."""
        if self._pool is not None and self.a is not None:
            self._pool.release(self._pool_key, self.a)
            self.a = None

    # C++ trace-record kind -> Python TracingBitReader kind tag
    _TR_KINDS = ("u", "ue", "se", "te", "cab", "cby")

    def parse_slice(self, r, hdr: SliceHeader, reflists=((), ()),
                    cur_poc: int = 0) -> None:
        lib = load_lib(trace=self._trace)
        slice_id = len(self.headers)
        self.headers.append(hdr)
        self.slice_reflists.append(reflists)
        l0, l1 = reflists
        sp = _SliceParams(
            slice_type=hdr.slice_type, first_mb=hdr.first_mb_in_slice,
            slice_qp=hdr.qp(self.pps),
            cabac=self.pps.entropy_coding_mode_flag,
            cabac_init_idc=hdr.cabac_init_idc,
            num_ref_l0=hdr.num_ref_idx_l0_active,
            num_ref_l1=hdr.num_ref_idx_l1_active,
            direct_spatial=hdr.direct_spatial_mv_pred_flag,
            slice_id=slice_id, cur_poc=cur_poc,
            disable_deblock_idc=hdr.disable_deblocking_filter_idc,
            alpha_off=2 * hdr.slice_alpha_c0_offset_div2,
            beta_off=2 * hdr.slice_beta_offset_div2,
            field_pic=hdr.field_pic_flag,
        )
        keep = []
        if self.pps.num_slice_groups > 1:
            from ..bitstream.fmo import mb_slice_group_map, next_mb_table
            cc = getattr(hdr, "slice_group_change_cycle", 0) or 0
            tab = self._fmo_tabs.get(cc)
            if tab is None:
                tab = next_mb_table(
                    mb_slice_group_map(self.sps, self.pps, cc))
                self._fmo_tabs[cc] = tab
            sp.next_mb = _ptr(tab)
            keep.append(tab)
        if hdr.is_b and len(l1):
            col = l1[0]
            if col.col_mv is not None:
                cmv = np.ascontiguousarray(col.col_mv, np.int32)
                cref = np.ascontiguousarray(col.col_refidx, np.int8)
                cuid = np.ascontiguousarray(col.col_ref_uid, np.int32)
                keep += [cmv, cref, cuid]
                sp.col_mv = _ptr(cmv)
                sp.col_refidx = _ptr(cref)
                sp.col_ref_uid = _ptr(cuid)
            sp.col_longterm = int(col.long_term)
            sp.col_poc = int(col.poc)
        for lname, lref in (("l0", l0), ("l1", l1)):
            poc = np.array([p.poc for p in lref], np.int32)
            lt = np.array([p.long_term for p in lref], np.uint8)
            uid = np.array([p.uid for p in lref], np.int32)
            slot = np.array([p.slot for p in lref], np.int32)
            keep += [poc, lt, uid, slot]
            setattr(sp, f"{lname}_poc", _ptr(poc) if len(lref) else None)
            setattr(sp, f"{lname}_lt", _ptr(lt) if len(lref) else None)
            setattr(sp, f"{lname}_uid", _ptr(uid) if len(lref) else None)
            setattr(sp, f"{lname}_slot", _ptr(slot) if len(lref) else None)
            setattr(sp, f"{lname}_len", len(lref))
        self._keepalive.append(keep)
        data = r.data
        tr_buf = None
        if self._trace:
            # Record count is spec-bounded: CABAC bins <= 32/3 per byte
            # (~1.33/bit, A.3.1) and CAVLC raw records are >= 1 bit each
            # except synthesized per-bit VLC records (1/bit), so 2x the
            # remaining bit budget + slack can't overflow on conforming
            # input.
            cap = (len(data) * 8 - r.pos) * 2 + 4096
            tr_buf = np.empty((cap, 4), np.int32)
            lib.h264e_trace_set(_ptr(tr_buf), cap)
        t0 = time.perf_counter() if gil_meter.enabled else None
        ret = lib.h264e_parse_slice(C.byref(self.pb), C.byref(sp),
                                    data, len(data), r.pos)
        if t0 is not None:
            gil_meter.add(time.perf_counter() - t0, "h264e_parse_slice")
        if tr_buf is not None:
            n = int(lib.h264e_trace_count())
            lib.h264e_trace_set(None, 0)   # buffer is freed on return
            log = getattr(r, "log", None)
            if log is not None:
                if n > len(tr_buf):
                    raise RuntimeError(
                        f"SE trace overflow ({n} records, cap {cap}): "
                        "non-conforming bin density")
                kinds = self._TR_KINDS
                for k, p, nn, v in tr_buf[:n].tolist():
                    log.append((kinds[k], p, nn, v))
        if ret != 0:
            raise ValueError(f"C++ slice parse failed: {ret}")

    def finished(self) -> bool:
        return bool((self.a["slice_map"] >= 0).all())

    def build_col_motion(self):
        """Colocated motion from the grids (C scan, GIL released)."""
        a = self.a
        h4, w4 = self.mb_h * 4, self.mb_w * 4
        n_slices = max(1, len(self.slice_reflists))
        uid_tab = np.full((n_slices, 2, 32), -1, np.int32)
        for sid, (l0, l1) in enumerate(self.slice_reflists):
            for lst, lref in ((0, l0), (1, l1)):
                for ridx, p in enumerate(lref[:32]):
                    uid_tab[sid, lst, ridx] = p.uid
        col_mv = np.empty((h4, w4, 2), np.int32)
        col_ref = np.empty((h4, w4), np.int8)
        col_uid = np.empty((h4, w4), np.int32)
        lib = load_lib(trace=self._trace)
        t0 = time.perf_counter() if gil_meter.enabled else None
        lib.h264e_build_col(
            _ptr(a["ref_grid"]), _ptr(a["mv_grid"]), _ptr(a["slice_id"]),
            _ptr(uid_tab), n_slices, self.mb_w, self.mb_h,
            _ptr(col_mv), _ptr(col_ref), _ptr(col_uid))
        if t0 is not None:
            gil_meter.add(time.perf_counter() - t0, "h264e_build_col")
        return col_mv, col_ref, col_uid


def pack_frame_cpp(pic: CppPictureParse, cur_poc: int = 0) -> FrameABI:
    """FrameABI from the C++-filled arrays (zero-copy).

    refslot/refid are filled by the C++ parser at set_part time; weighted
    prediction ships as compact per-slice tables (ops.abi.fill_weight_tables)
    resolved to per-cell weights on device (models.pipeline.resolve_weights).
    """
    from ..ops.abi import (
        MAX_SLICES, fill_weight_tables, identity_wtab,
        note_nonexisting_refs, patch_capacity,
    )
    a = pic.a
    abi = FrameABI(
        kind=a["kind"], qp=a["qp"], luma4=a["luma4"], luma8=a["luma8"],
        luma_dc=a["luma_dc"], chroma_dc=a["chroma_dc"],
        chroma_ac=a["chroma_ac"], i4_modes=a["i4_modes"],
        i8_modes=a["i8_modes"], i16_mode=a["i16_mode"],
        chroma_mode=a["chroma_mode"], i4_avail=a["i4_avail"],
        i8_avail=a["i8_avail"], mb_avail=a["mb_avail"], pcm=a["pcm"],
        nz=a["nz"], tr8=a["tr8"], slice_id=a["slice_id"],
        disable_idc=a["disable_idc"], alpha_off=a["alpha_off"],
        beta_off=a["beta_off"],
        deblock_off=np.zeros(pic.mb_w * pic.mb_h, np.int32),
        mv=a["mv"],
        refid=a["refid"], refslot=a["refslot"], refidx=a["refidx"],
        wtab=identity_wtab().copy(),
        slogwd=np.zeros((MAX_SLICES, 2), np.int32),
        patch=np.full(patch_capacity(pic.mb_w, pic.mb_h), -1, np.int32),
        mb_w=pic.mb_w, mb_h=pic.mb_h,
    )
    note_nonexisting_refs(abi, pic.slice_reflists)
    fill_weight_tables(abi, pic.pps, pic.headers, pic.slice_reflists,
                       cur_poc)
    # decode-time nonzero-row hints for ops.wire.pack_wire_raw (gather
    # instead of full dense rescan); safe under conceal (it only ZEROES
    # rows, and the gather skips all-zero hinted rows)
    abi["_nzr"] = pic.nz_row_hints()
    return abi
