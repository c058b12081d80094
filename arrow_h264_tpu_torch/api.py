"""Public decode API of the PyTorch port.

    dec = Decoder(device="cuda")
    for frame in dec.decode_annexb(stream_bytes):
        frame.y, frame.cb, frame.cr, frame.planar()

The host half (bitstream, entropy, DPB bookkeeping, ABI packing) is the
package's own copy of the JAX package's host code; the control loop is
carried over from `arrow_h264_tpu.api` with the behaviour unchanged.
Reconstruction runs in `models.pipeline.DevicePipeline` on `device`;
`order` chooses its intra and deblock kernels ("phase", the default: the
knight-move wavefront; "raster": raster order within each MB row, one
worker per row, two MBs behind the row above), and `upload` how a
picture's ABI reaches the device ("wire", the default: one compact uint8
buffer, ops/wire.py; "dense": the dense int32 ABI key by key).
Progressive Baseline/Main/High streams, and interlaced streams whose
pictures are all fields (PAFF): each field is decoded as a picture of
half the frame's height, and a field pair is output as one woven frame.
MBAFF and frame pictures of an interlaced SPS are rejected by the slice
header parse.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .bitstream import nal
from .bitstream.bits import BitReader, TracingBitReader
from .bitstream.params import PPS, SPS, parse_pps, parse_sps
from .bitstream.sei import SEIMessage, parse_sei_rbsp
from .bitstream.slicehdr import parse_slice_header
from .conceal import conceal_abi, nearest_ref_pic, slice_coverage
from .dpb import DPB, WovenPair
from .host import centropy
from .mb.parse import PictureParse
from .models.pipeline import ORDERS, UPLOADS, DevicePipeline
from .ops.abi import pack_frame
from .spans import now, recorder
from .trace import (
    dump_se_log, trace_frame_abi, trace_se_target, trace_slice_header,
    trace_target, trace_upload,
)


def crop_planes(sps: SPS, y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    if not sps.frame_cropping_flag:
        return y, cb, cr
    # 4:2:0: CropUnitX = 2; CropUnitY = 2 * (2 - frame_mbs_only_flag)
    # (spec 7.4.2.1.1 — vertical crop units double for interlaced SPS)
    cu_y = 2 * (2 - sps.frame_mbs_only_flag)
    l, r_, t, b = (2 * sps.crop_left, 2 * sps.crop_right,
                   cu_y * sps.crop_top, cu_y * sps.crop_bottom)
    h, w = y.shape
    y = y[t:h - b, l:w - r_]
    cb = cb[t // 2:(h - b) // 2, l // 2:(w - r_) // 2]
    cr = cr[t // 2:(h - b) // 2, l // 2:(w - r_) // 2]
    return y, cb, cr


@dataclass
class Frame:
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray
    poc: int = 0

    @property
    def width(self) -> int:
        return self.y.shape[1]

    @property
    def height(self) -> int:
        return self.y.shape[0]

    def planar(self) -> bytes:
        """Planar YUV420 bytes (the JM-comparison format)."""
        return self.y.tobytes() + self.cb.tobytes() + self.cr.tobytes()


class PendingFrame:
    """An output frame whose planes are still device tensors.

    The batch decoder (parallel.batch.BatchDecoder) does not wait for each
    frame's device->host copy: `start_fetch` queues the copy of the three
    planes into pinned host tensors behind the device work that made them
    and records a CUDA event, and `finalize`, a round later, waits on that
    event and returns the cropped Frame.  For CPU tensors both are plain
    copies."""

    __slots__ = ("y", "cb", "cr", "sps", "poc", "_host", "_done")

    def __init__(self, y, cb, cr, sps, poc):
        self.y, self.cb, self.cr = y, cb, cr
        self.sps, self.poc = sps, poc
        self._host = None
        self._done = None

    def start_fetch(self) -> None:
        """Queue the copy to the host on the current stream of the planes'
        device (once)."""
        if self._host is not None:
            return
        planes = (self.y, self.cb, self.cr)
        if self.y.device.type != "cuda":
            self._host = tuple(p.numpy().copy() for p in planes)
            return
        self._host = tuple(torch.empty(p.shape, dtype=p.dtype,
                                       pin_memory=True) for p in planes)
        # on the planes' device's stream (a sharded batch's lanes live on
        # several devices)
        with torch.cuda.device(self.y.device):
            for h, p in zip(self._host, planes):
                h.copy_(p, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()

    def finalize(self) -> Frame:
        """Wait for the copy (starting it if need be) -> cropped Frame."""
        self.start_fetch()
        if self._done is not None:
            self._done.synchronize()
            # copy out of the pinned tensors, so that they go back to the
            # caching host allocator for later rounds
            self._host = tuple(h.numpy().copy() for h in self._host)
            self._done = None
        y, cb, cr = crop_planes(self.sps, *self._host)
        return Frame(y=y, cb=cb, cr=cr, poc=self.poc)


@dataclass
class DecodeStats:
    """Per-decoder counters."""
    frames: int = 0
    host_parse_s: float = 0.0       # entropy + header + DPB bookkeeping
    device_dispatch_s: float = 0.0  # upload + submission of reconstruction
    emit_sync_s: float = 0.0        # device->host copy at output time
    concealed_mbs: int = 0
    upload_bytes: int = 0           # host->device bytes of the pictures' ABIs
    pack_full_scans: int = 0        # wire-packed pictures whose decode-time
                                    # row hints were unusable (not ascending,
                                    # as under ASO): rows scanned in full
    field_pictures: int = 0         # committed pictures that are fields
    weave_s: float = 0.0            # weaving field pairs into frames (the
                                    # calling thread's seconds in _emit)

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class Decoder:
    """H.264 decoder with PyTorch reconstruction on `device`.

    device: a torch device; "cuda" (the default) raises if no GPU is
    present.  entropy="cpp" uses the native host entropy library, "python"
    the pure-Python parser.  order: "phase" (default) or "raster", the
    intra and deblock kernels of models.pipeline.decode_frames_batch_fn.
    upload: "wire" (default) or "dense", how each picture's ABI is shipped
    (models.pipeline.DevicePipeline.decode_frame; pictures with dense
    per-cell weights always go dense).
    """

    def __init__(self, device="cuda", entropy: str = "cpp", trace=None,
                 conceal: bool = False, trace_se=None,
                 order: str = "phase", upload: str = "wire") -> None:
        self.device = torch.device(device)
        if order not in ORDERS:
            raise ValueError(f"order {order!r}: expected one of "
                             f"{sorted(ORDERS)}")
        if upload not in UPLOADS:
            raise ValueError(f"upload {upload!r}: expected one of "
                             f"{list(UPLOADS)}")
        self.order = order
        self.upload = upload
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Decoder(device='cuda'): no CUDA device")
        self._trace = trace_target(trace)
        self._trace_se = trace_se_target(trace_se)
        self._frame_idx = 0
        self.conceal = conceal
        self.concealed: list[tuple[int, int]] = []
        self.stats = DecodeStats()
        self.sps_map: dict[int, SPS] = {}
        self.pps_map: dict[int, PPS] = {}
        self._pipelines: dict[tuple, DevicePipeline] = {}
        self.dpb: DPB | None = None
        self._dpb_sps_id: int | None = None
        self.sei_messages: list[SEIMessage] = []
        if entropy == "cpp":
            try:
                centropy.load_lib()
            except Exception:
                entropy = "python"
        self.entropy = entropy
        self._pic_pool = centropy.PicBufPool()
        self._gap_bumped: list = []
        # set by BatchDecoder: _emit returns PendingFrames (no sync)
        self.deferred_emit = False
        # (parent, call, round, lane) of the `weave` spans that _emit
        # records with spans.recorder on; BatchDecoder sets it
        self.span_ctx = (0, -1, -1, -1)

    def _pipeline(self, sps: SPS, pps: PPS) -> DevicePipeline:
        key = (sps.seq_parameter_set_id, pps.pic_parameter_set_id,
               sps.pic_width_in_mbs, sps.pic_height_in_map_units)
        if key not in self._pipelines:
            self._pipelines[key] = DevicePipeline(sps, pps, self.device,
                                                  self.order, self.upload)
        return self._pipelines[key]

    def decode_annexb(self, data: bytes):
        """Yield Frames in output order."""
        gen = self.parse_pictures(data)
        while True:
            t0 = time.perf_counter()
            try:
                pic, poc = next(gen)
            except StopIteration:
                self.stats.host_parse_s += time.perf_counter() - t0
                break
            self.stats.host_parse_s += time.perf_counter() - t0
            yield from self._finish(pic, poc)
        if self.dpb is not None:
            for planes in self.dpb.flush():
                yield self._emit(planes)

    def parse_pictures(self, data: bytes):
        """Yield (PictureParse, poc) per complete coded picture.

        The generator suspends after each picture and before the next
        picture's reference-list construction, so the caller MUST store
        the decoded picture into self.dpb (via _finish) before resuming.

        With self.conceal, slice-level parse errors are swallowed (the
        affected MBs are repaired later by _finish via conceal_abi);
        without it they propagate.
        """
        cur: PictureParse | None = None
        cur_poc = 0
        prev_hdr = None
        for u in nal.parse_annexb(data):
            if u.nal_unit_type == nal.NAL_SPS:
                sp = parse_sps(u.rbsp)
                self.sps_map[sp.seq_parameter_set_id] = sp
            elif u.nal_unit_type == nal.NAL_PPS:
                pp = parse_pps(u.rbsp, self.sps_map)
                self.pps_map[pp.pic_parameter_set_id] = pp
            elif u.nal_unit_type == nal.NAL_SEI:
                sps0 = next(iter(self.sps_map.values()), None)
                self.sei_messages.extend(parse_sei_rbsp(u.rbsp, sps0))
            elif u.is_slice:
                try:
                    r2 = BitReader(u.rbsp)
                    r2.ue()
                    r2.ue()
                    pps = self.pps_map[r2.ue()]
                    sps = self.sps_map[pps.seq_parameter_set_id]
                    se_log: list = []
                    r = (TracingBitReader(u.rbsp, se_log)
                         if self._trace_se is not None else BitReader(u.rbsp))
                    hdr = parse_slice_header(r, sps, pps, u.nal_unit_type,
                                             u.nal_ref_idc)
                except Exception:
                    if self.conceal:
                        continue             # lost slice header
                    raise
                # Picture boundary: without FMO/ASO the first slice of a
                # picture starts at MB 0.  With FMO the first slice can
                # start anywhere and with ASO the MB-0 slice may arrive
                # mid-picture, so boundary = any header-field change (spec
                # 7.4.1.2.4 subset) or a slice whose first MB this picture
                # already parsed.
                if pps.num_slice_groups > 1:
                    mbs = getattr(cur, "mbs", None)
                    new_pic = (cur is None or prev_hdr is None
                               or hdr.pic_parameter_set_id !=
                                   prev_hdr.pic_parameter_set_id
                               or hdr.frame_num != prev_hdr.frame_num
                               or hdr.is_idr != prev_hdr.is_idr
                               or (hdr.is_idr and
                                   hdr.idr_pic_id != prev_hdr.idr_pic_id)
                               or hdr.pic_order_cnt_lsb !=
                                   prev_hdr.pic_order_cnt_lsb
                               or hdr.delta_pic_order_cnt !=
                                   prev_hdr.delta_pic_order_cnt
                               or (mbs is not None and
                                   mbs[hdr.first_mb_in_slice] is not None))
                else:
                    new_pic = hdr.first_mb_in_slice == 0
                prev_hdr = hdr
                if new_pic:
                    if cur is not None:
                        yield cur, cur_poc
                        # the caller has committed `cur` before resuming,
                        # so its parse arrays can go back to the pool
                        if hasattr(cur, "retire"):
                            cur.retire()
                    if self.dpb is None or \
                            self._dpb_sps_id != sps.seq_parameter_set_id:
                        self.dpb = DPB(sps)
                        self._dpb_sps_id = sps.seq_parameter_set_id
                    cur = (centropy.CppPictureParse(
                               sps, pps, pool=self._pic_pool,
                               trace=self._trace_se is not None)
                           if self.entropy == "cpp"
                           else PictureParse(sps, pps))
                    # spec 8.2.5.2: synthesize non-existing refs for
                    # frame_num gaps; bind them to slot 0 so a (non-
                    # conforming) reference to one stays in bounds.  Real
                    # output-pending pictures bumped by the gap insertion
                    # are queued for emission at the next commit.
                    gap_pics, gap_bumped = self.dpb.fill_frame_num_gaps(hdr)
                    for gp in gap_pics:
                        gp.slot = 0
                    self._gap_bumped.extend(gap_bumped)
                    cur_poc = self.dpb.compute_poc(hdr)
                if cur is None:
                    if self.conceal:
                        continue
                    raise ValueError("slice without picture start")
                try:
                    reflists = ((), ())
                    if hdr.is_p:
                        reflists = (self.dpb.init_list_p(hdr), ())
                    elif hdr.is_b:
                        reflists = self.dpb.init_lists_b(hdr, cur_poc)
                    if self._trace is not None:
                        trace_slice_header(self._trace, hdr, cur_poc,
                                           self._frame_idx)
                    cur.parse_slice(r, hdr, reflists, cur_poc)
                    if self._trace_se is not None:
                        dump_se_log(self._trace_se, se_log, self._frame_idx,
                                    len(cur.headers) - 1)
                except Exception:
                    if self.conceal:
                        continue             # lost slice body
                    raise
        if cur is not None:
            yield cur, cur_poc

    def pack_abi(self, pic, poc: int):
        """Entropy results -> frame ABI (+ optional JSONL trace)."""
        if isinstance(pic, centropy.CppPictureParse):
            abi = centropy.pack_frame_cpp(pic, poc)
        else:
            abi = pack_frame(pic, poc)
        hdr0 = pic.headers[0] if pic.headers else None
        if hdr0 is not None and hdr0.field_pic_flag:
            abi["cvoff"] = field_cvoff(pic.slice_reflists, hdr0.parity)
        if self._trace is not None:
            trace_frame_abi(self._trace, abi, pic.sps.pic_width_in_mbs,
                            pic.sps.pic_height_in_map_units,
                            self._frame_idx)
            self._trace.flush()
        self._frame_idx += 1
        return abi

    def commit(self, pic, poc: int, y, cb, cr, n_slots: int, store_ref):
        """DPB store + reference bookkeeping; yields output Frames.

        store_ref(slot, y, cb, cr) writes the picture into the device DPB
        slot."""
        self.stats.frames += 1
        if self._gap_bumped:
            for planes in self._gap_bumped:
                yield self._emit(planes)
            self._gap_bumped.clear()
        hdr = pic.headers[0]
        self.stats.field_pictures += hdr.field_pic_flag
        # the payload keeps DEVICE tensors: _emit copies to the host at
        # output time
        payload = (y, cb, cr, pic.sps, poc)
        outputs, stored = self.dpb.store(payload, hdr, poc)
        if stored.is_ref:
            stored.col_mv, stored.col_refidx, stored.col_ref_uid = \
                pic.build_col_motion()
            used = {p.slot for p in self.dpb.pics
                    if p.is_ref and p is not stored and p.slot >= 0}
            slot = next(s for s in range(n_slots) if s not in used)
            stored.slot = slot
            store_ref(slot, y, cb, cr)
        for planes in outputs:
            yield self._emit(planes)

    def _finish(self, pic, poc: int):
        if self.conceal and not pic.headers:
            return                       # every slice of the picture lost
        abi = self.pack_abi(pic, poc)
        if self.conceal:
            cov = slice_coverage(pic)
            if not cov.all():
                ref = nearest_ref_pic(self.dpb, poc)
                n = conceal_abi(abi, cov,
                                -1 if ref is None else ref.slot,
                                col_mv=getattr(ref, "col_mv", None))
                self.concealed.append((self._frame_idx - 1, n))
                self.stats.concealed_mbs += n
        pipeline = self._pipeline(pic.sps, pic.pps)
        t0 = time.perf_counter()
        y, cb, cr = pipeline.decode_frame(abi)
        self.stats.device_dispatch_s += time.perf_counter() - t0
        mode, nbytes = pipeline.last_upload
        self.stats.upload_bytes += nbytes
        self.stats.pack_full_scans += pipeline.last_full_scans
        if self._trace is not None:
            trace_upload(self._trace, self._frame_idx - 1, mode, nbytes)
        yield from self.commit(pic, poc, y, cb, cr, pipeline.n_slots,
                               pipeline.store_ref)

    def _emit(self, planes):
        """Output planes -> Frame, or PendingFrame with deferred_emit.  A
        field pair (dpb.WovenPair) is woven on the device into one frame
        with the smaller POC of the two (stats.weave_s; a `weave` span
        with the recorder on)."""
        if isinstance(planes, WovenPair):
            t0 = now()
            (yt, cbt, crt, sps, poct), (yb, cbb, crb, _, pocb) = \
                planes.top, planes.bottom
            y, cb, cr = (torch.stack((t, b), 1).reshape(2 * t.shape[0],
                                                        t.shape[1])
                         for t, b in ((yt, yb), (cbt, cbb), (crt, crb)))
            planes = (y, cb, cr, sps, min(poct, pocb))
            t1 = now()
            self.stats.weave_s += (t1 - t0) / 1e9
            if recorder.enabled:
                parent, call, rnd, lane = self.span_ctx
                recorder.add("weave", t0, t1, parent, call, rnd, lane)
        y, cb, cr, sps, poc = planes
        if self.deferred_emit:
            return PendingFrame(y, cb, cr, sps, poc)
        t0 = time.perf_counter()
        y, cb, cr = (p.cpu().numpy() for p in (y, cb, cr))
        self.stats.emit_sync_s += time.perf_counter() - t0
        y, cb, cr = crop_planes(sps, y, cb, cr)
        return Frame(y=y, cb=cb, cr=cr, poc=poc)


def field_cvoff(slice_reflists, parity: int) -> np.ndarray:
    """int32 [64]: the vertical chroma offset, in 1/8 chroma samples, of
    each DPB slot that a field picture of `parity` (1 top, 2 bottom)
    references (spec 8.4.1.4.1): -2 where the top field reads a bottom
    field, +2 where the bottom field reads a top field, else 0."""
    cvoff = np.zeros(64, np.int32)
    for l0, l1 in slice_reflists:
        for p in (*l0, *l1):
            # non-existing gap placeholders share slot 0 with a real
            # picture (parse_pictures); one must not set the real
            # picture's offset (a conforming stream reads no
            # non-existing field)
            if p.slot >= 0 and p.parity and not p.non_existing and \
                    p.parity != parity:
                cvoff[p.slot] = -2 if parity == 1 else 2
    return cvoff


def decode_annexb(data: bytes, device="cuda"):
    """One-shot convenience: bytes -> list[Frame]."""
    return list(Decoder(device=device).decode_annexb(data))
