"""Lockstep multi-stream decode on one device.

Port of `arrow_h264_tpu.parallel.batch` without the mesh.  Host entropy
parses each stream in a thread pool (the C++ slice parser releases the
GIL), the streams' next pictures form a round, and ONE call of
`decode_frames_batch_fn` reconstructs the whole round over [B, ...]
tensors, so each kernel is launched once a round for all lanes.  One
batched reference store (`store_refs_fn`) follows.  The next round's parse
runs while this round's device work is queued.

Per-stream error isolation: a stream that raises during parse, ABI pack
or commit is recorded in `BatchDecoder.errors` and leaves the rounds; the
other streams keep decoding, and their frames stay exact.

Field (PAFF) streams decode in lockstep like frames, a field a round:
their lanes ship each picture's per-slot chroma offsets (`cvoff`), and
field and frame streams cannot share a batch (`stream_params`).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..api import Decoder, Frame, PendingFrame
from ..models.pipeline import (
    ORDERS, decode_consts, decode_frames_batch_fn, dpb_alloc, dpb_slots,
    store_refs_fn, stream_params, upload_batch,
)
from ..ops.abi import KIND_P, empty_frame_abi


def _inter(abis) -> bool:
    """Whether any MB of the host ABIs is inter (P or B)."""
    return any(bool((np.asarray(a["kind"]) >= KIND_P).any()) for a in abis)


class BatchDecoder:
    """Decode N same-resolution streams in lockstep rounds on `device`.

    materialize=True returns Frames; each round's device->host copies are
    queued when the round commits and waited for a round later.
    materialize=False returns device-resident api.PendingFrames.
    on_frame(lane, frame) (needs materialize=False) is handed each frame
    when its round commits, and its return value replaces the frame in
    the result, so a caller that consumes frames on the device keeps only
    the DPB and one round resident.  order: the intra and deblock kernels,
    as for api.Decoder.
    """

    def __init__(self, n_streams: int, device="cuda", entropy: str = "cpp",
                 materialize: bool = True, on_frame=None,
                 order: str = "phase"):
        if order not in ORDERS:
            raise ValueError(f"order {order!r}: expected one of "
                             f"{sorted(ORDERS)}")
        if on_frame is not None and materialize:
            raise ValueError("on_frame streams device frames; use "
                             "materialize=False")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchDecoder(device='cuda'): no CUDA device")
        self.n_streams = n_streams
        self.order = order
        self.materialize = materialize
        self.on_frame = on_frame
        # lanes: the host half of a Decoder each (parse, pack, DPB
        # bookkeeping); their output stays on the device until fetched
        self.decoders = [Decoder(device=self.device, entropy=entropy)
                         for _ in range(n_streams)]
        for d in self.decoders:
            d.deferred_emit = True
        self.errors: list = [None] * n_streams
        self.rounds = 0             # lockstep rounds of the last decode
        self.inter_rounds = 0       # ... of them with an inter lane
        self._params = None
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, min(n_streams, os.cpu_count() or 1)))

    def close(self) -> None:
        """Stop the parse pool's threads."""
        self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def stats(self):
        """Per-stream DecodeStats (dicts).  A round's device dispatch time
        is split evenly over its lanes, so the lanes' sum is the batch's;
        host_parse_s is each lane's own time in the pool, whose lanes run
        at once."""
        return [d.stats.as_dict() for d in self.decoders]

    # ---- batched device state --------------------------------------------

    def _init_device(self, params: tuple, n_slots: int) -> None:
        """Device state for lanes of stream_params `params`, each with a
        DPB of n_slots slots (the most that a lane of the first round
        needs)."""
        self._params = params
        self._kw = decode_consts(params, self.device, self.order)
        mb_w, mb_h = params[:2]
        self.n_slots = n_slots
        B = self.n_streams
        y, c = dpb_alloc(mb_w, mb_h, B * self.n_slots, self.device)
        self._dpb_y = y.view((B, self.n_slots) + y.shape[1:])
        self._dpb_c = c.view((B, self.n_slots) + c.shape[1:])
        # what finished and failed lanes ship, so that B stays fixed: all
        # intra, no coefficients, qp 0 (no edge is filtered), no reference
        # read; its output is never committed or stored
        self._dummy = empty_frame_abi(mb_w, mb_h)

    # ---- lockstep decode --------------------------------------------------

    def decode(self, streams: list[bytes]) -> list[list[Frame]]:
        """Decode the Annex-B streams in lockstep; returns per-stream frame
        lists in output order (PendingFrames, or what on_frame returned,
        with materialize=False).  Failed streams yield partial lists; see
        self.errors."""
        B = self.n_streams
        if len(streams) != B:
            raise ValueError(f"{len(streams)} streams for {B} lanes")
        gens = [d.parse_pictures(s) for d, s in zip(self.decoders, streams)]
        pending: list = [None] * B
        frames: list[list] = [[] for _ in range(B)]
        in_flight: list[tuple[int, int]] = []   # fetches started, (lane, j)
        self.errors = [None] * B
        self.rounds = self.inter_rounds = 0

        def fail(i, e):
            self.errors[i] = e
            gens[i] = None
            pending[i] = None

        def advance(i):
            t0 = time.perf_counter()
            try:
                pending[i] = next(gens[i])
            except StopIteration:
                gens[i] = None
                pending[i] = None
            except Exception as e:           # corrupt lane: isolate
                fail(i, e)
            self.decoders[i].stats.host_parse_s += time.perf_counter() - t0

        def pack(i):
            t0 = time.perf_counter()
            try:
                return self.decoders[i].pack_abi(*pending[i])
            except Exception as e:
                fail(i, e)
                return None
            finally:
                self.decoders[i].stats.host_parse_s += \
                    time.perf_counter() - t0

        list(self._pool.map(advance, range(B)))
        while any(p is not None for p in pending):
            live = [i for i in range(B) if pending[i] is not None]
            abis = {i: abi for i, abi in zip(live, self._pool.map(pack, live))
                    if abi is not None}
            if abis and self._params is None:
                pic = pending[next(iter(abis))][0]
                self._init_device(
                    stream_params(pic.sps, pic.pps),
                    max(dpb_slots(pending[i][0].sps) for i in abis))
            for i in list(abis):
                pic = pending[i][0]
                if stream_params(pic.sps, pic.pps) != self._params:
                    raise ValueError(
                        f"lane {i}: stream parameters (resolution, scaling "
                        "lists, chroma QP offsets, bypass, field coding) "
                        "differ from the batch's; lockstep streams must "
                        "share them")
                if dpb_slots(pic.sps) > self.n_slots:
                    fail(i, ValueError(
                        f"lane {i}: {dpb_slots(pic.sps)} DPB slots, more "
                        f"than the {self.n_slots} of the batch's first "
                        "round"))
                    del abis[i]
            live = [i for i in live if i in abis]
            if not live:
                break

            t0 = time.perf_counter()
            inter = _inter(abis.values())
            batch = upload_batch([abis.get(i, self._dummy) for i in range(B)],
                                 self.device, self.n_slots)
            yb, cbb, crb = decode_frames_batch_fn(
                batch, self._dpb_y, self._dpb_c, inter=inter, **self._kw)
            self.rounds += 1
            self.inter_rounds += inter
            dispatch_s = time.perf_counter() - t0

            # commit each lane; the reference stores of the round are
            # collected and written by one batched store
            lanes, slots = [], []
            mark = [len(f) for f in frames]
            for i in live:
                def rec(slot, y, cb, cr, i=i):
                    lanes.append(i)
                    slots.append(slot)

                try:
                    frames[i].extend(self.decoders[i].commit(
                        *pending[i], yb[i], cbb[i], crb[i], self.n_slots,
                        rec))
                except Exception as e:
                    fail(i, e)
            t0 = time.perf_counter()
            keep = [k for k, i in enumerate(lanes) if self.errors[i] is None]
            store_refs_fn(self._dpb_y, self._dpb_c, [lanes[k] for k in keep],
                          [slots[k] for k in keep], yb, cbb, crb)
            dispatch_s += time.perf_counter() - t0
            for i in live:
                self.decoders[i].stats.device_dispatch_s += \
                    dispatch_s / len(live)
            abis.clear()   # release ABI views so parse buffers can recycle
            todo = [i for i in live if self.errors[i] is None]
            for i in todo:
                pending[i] = None

            new = [(i, j) for i in range(B)
                   for j in range(mark[i], len(frames[i]))]
            if self.materialize:
                # queue this round's copies, then wait for last round's
                # (queued before this round's device work)
                for i, j in new:
                    frames[i][j].start_fetch()
                for i, j in in_flight:
                    frames[i][j] = self._finalize_timed(i, frames[i][j])
                in_flight = new
            elif self.on_frame is not None:
                for i, j in new:
                    frames[i][j] = self.on_frame(i, frames[i][j])
            # parse the next round's pictures while this round runs on the
            # device
            list(self._pool.map(advance, todo))

        for i in range(B):
            d = self.decoders[i]
            if self.errors[i] is None and d.dpb is not None:
                tail = len(frames[i])
                frames[i].extend(d._emit(p) for p in d.dpb.flush())
                if self.on_frame is not None:
                    for j in range(tail, len(frames[i])):
                        frames[i][j] = self.on_frame(i, frames[i][j])
        if self.materialize:
            # every copy still to make is queued before the first wait
            rest = [(i, j) for i in range(B) for j in range(len(frames[i]))
                    if isinstance(frames[i][j], PendingFrame)]
            for i, j in rest:
                frames[i][j].start_fetch()
            for i, j in rest:
                frames[i][j] = self._finalize_timed(i, frames[i][j])
        return frames

    def _finalize_timed(self, i: int, pending: PendingFrame) -> Frame:
        """Materialize a deferred frame, timing the wait and copy into the
        lane's emit_sync_s."""
        t0 = time.perf_counter()
        f = pending.finalize()
        self.decoders[i].stats.emit_sync_s += time.perf_counter() - t0
        return f


def decode_batch_lockstep(abis: list[dict], dpbs: list[tuple], **kw):
    """One lockstep reconstruction step over a stream batch.

    abis: per-stream host ABIs (same geometry); dpbs: per-stream DPB pairs
    (dpb_y [S, 4, ...], dpb_c [S, 2, ...]) on one device; kw: the
    keyword arguments of decode_frames_batch_fn other than `inter`.
    Returns (y, cb, cr) uint8 [B, H, W] / [B, H/2, W/2]."""
    dpb_y = torch.stack([d[0] for d in dpbs])
    dpb_c = torch.stack([d[1] for d in dpbs])
    return decode_frames_batch_fn(
        upload_batch(abis, dpb_y.device, dpb_y.shape[1]), dpb_y, dpb_c,
        inter=_inter(abis), **kw)
