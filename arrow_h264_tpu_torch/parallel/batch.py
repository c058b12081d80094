"""Lockstep multi-stream decode, on one device or sharded over several.

Port of `arrow_h264_tpu.parallel.batch`.  Host entropy parses each stream
in a thread pool (the C++ slice parser releases the GIL), the streams'
next pictures form a round, and ONE call of `decode_frames_batch_fn` a
shard reconstructs the whole round over [B/k, ...] tensors, so each
kernel is launched once a round and shard for all its lanes.  One batched
reference store (`store_refs_fn`) a shard follows.  The next round's parse
runs while this round's device work is queued.  The mesh
(parallel.sharding) is one device unless the caller gives more.

Upload: the pool packs each lane's picture into wire records
(ops.wire.pack_wire_raw) beside its ABI; the main thread merges the
lanes' specs into the round's, the pool emits each lane into its row of
one pinned staging tensor, and each shard's rows go to its device in one
copy and are unpacked there (models.pipeline.wire_to_device).  A round
with a lane of dense per-cell weights, or every round with
upload="dense", ships the dense ABI instead (`upload_batch`).

Per-stream error isolation: a stream that raises during parse, ABI pack
or commit is recorded in `BatchDecoder.errors` and leaves the rounds; the
other streams keep decoding, and their frames stay exact.

Field (PAFF) streams decode in lockstep like frames, a field a round:
their lanes ship each picture's per-slot chroma offsets (`cvoff`), and
field and frame streams cannot share a batch (`stream_params`).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..api import Decoder, Frame, PendingFrame
from ..models.pipeline import (
    ORDERS, UPLOADS, decode_consts, dpb_alloc, dpb_slots, stage_cvoff,
    stream_params, upload_batch, upload_nbytes, wire_staging,
    wire_to_device,
)
from ..ops.abi import KIND_P, empty_frame_abi
from ..ops.wire import emit_wire, merge_specs, pack_wire_raw, wire_total
from ..spans import now, recorder
from .sharding import (
    make_stream_mesh, shard_bounds, sharded_decode_fn, sharded_store_fn,
)


def _inter(abis) -> bool:
    """Whether any MB of the host ABIs is inter (P or B)."""
    return any(bool((np.asarray(a["kind"]) >= KIND_P).any()) for a in abis)


def default_mesh(n_streams: int, device) -> tuple:
    """The mesh of a BatchDecoder given `device` and no mesh: for "cuda"
    without an index every visible GPU when n_streams splits evenly over
    them, else the current one; any other device alone."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return (device,)
    if not torch.cuda.is_available():
        raise RuntimeError("BatchDecoder(device='cuda'): no CUDA device")
    if n_streams % torch.cuda.device_count() == 0:
        return make_stream_mesh()
    return (torch.device("cuda", torch.cuda.current_device()),)


class BatchDecoder:
    """Decode N same-resolution streams in lockstep rounds on `mesh`.

    materialize=True returns Frames; each round's device->host copies are
    queued when the round commits and waited for a round later.
    materialize=False returns device-resident api.PendingFrames.
    on_frame(lane, frame) (needs materialize=False) is handed each frame
    when its round commits, and its return value replaces the frame in
    the result, so a caller that consumes frames on the device keeps only
    the DPB and one round resident.  order: the intra and deblock kernels,
    and upload: "wire" or "dense", as for api.Decoder.

    mesh: the devices of the shards (parallel.sharding: lanes split into
    len(mesh) contiguous shards, which must be even), default
    default_mesh(n_streams, device).  A lane's frames stay on its shard's
    device until fetched.
    """

    def __init__(self, n_streams: int, device="cuda", mesh=None,
                 entropy: str = "cpp", materialize: bool = True,
                 on_frame=None, order: str = "phase", upload: str = "wire"):
        if order not in ORDERS:
            raise ValueError(f"order {order!r}: expected one of "
                             f"{sorted(ORDERS)}")
        if upload not in UPLOADS:
            raise ValueError(f"upload {upload!r}: expected one of "
                             f"{list(UPLOADS)}")
        if on_frame is not None and materialize:
            raise ValueError("on_frame streams device frames; use "
                             "materialize=False")
        self.mesh = default_mesh(n_streams, device) if mesh is None \
            else make_stream_mesh(mesh)
        if any(d.type == "cuda" for d in self.mesh) and \
                not torch.cuda.is_available():
            raise RuntimeError("BatchDecoder(device='cuda'): no CUDA device")
        self._shards = shard_bounds(self.mesh, n_streams)
        self.device = self.mesh[0]
        self.n_streams = n_streams
        self.order = order
        self.upload = upload
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
        self.wire_rounds = 0        # ... of them uploaded as wire buffers
        self.dense_rounds = 0       # ... and as the dense ABI
        self.upload_s = 0.0         # main thread's seconds in the uploads
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
        needs): each shard's DPBs on its device."""
        self._params = params
        B = self.n_streams
        self._step = sharded_decode_fn(
            self.mesh, B, **decode_consts(params, self.device, self.order))
        self._store = sharded_store_fn(self.mesh, B)
        mb_w, mb_h = params[:2]
        self.n_slots = n_slots
        per = B // len(self.mesh)
        self._dpb_y, self._dpb_c = [], []
        for dev in self.mesh:
            y, c = dpb_alloc(mb_w, mb_h, per * n_slots, dev)
            self._dpb_y.append(y.view((per, n_slots) + y.shape[1:]))
            self._dpb_c.append(c.view((per, n_slots) + c.shape[1:]))
        # what finished and failed lanes ship, so that B stays fixed: all
        # intra, no coefficients, qp 0 (no edge is filtered), no reference
        # read; its output is never committed or stored
        self._dummy = empty_frame_abi(mb_w, mb_h)
        self._dummy_wire = pack_wire_raw(self._dummy, mb_w, mb_h)

    def _upload(self, abis: dict, wires: dict,
                ctx: tuple | None = None) -> list[dict]:
        """The round's ABI dict of each shard on its device: the lanes of
        `abis` (lane -> host ABI) and the dummy for the others, as wire
        buffers (`wires`: lane -> (raw, spec)) unless upload="dense" or
        a lane carries dense per-cell weights.  Counts the round and its
        lanes' upload_bytes.  ctx: (call, round, the upload span's id, the
        round span's attrs, given "upload" and "bytes" shipped) when the
        span recorder is on."""
        B = self.n_streams
        t = now() if ctx else 0
        if self.upload == "dense" or any("wp" in a for a in abis.values()):
            self.dense_rounds += 1
            out = []
            for (s0, s1), dev in zip(self._shards, self.mesh):
                batch = upload_batch(
                    [abis.get(i, self._dummy) for i in range(s0, s1)], dev,
                    self.n_slots)
                lane_bytes = upload_nbytes(batch) // (s1 - s0)
                for i in range(s0, s1):
                    if i in abis:
                        self.decoders[i].stats.upload_bytes += lane_bytes
                out.append(batch)
            if ctx:
                recorder.mark("upload.copy", t, ctx[2], *ctx[:2])
                ctx[3].update(upload="dense",
                              bytes=sum(map(upload_nbytes, out)))
            return out
        self.wire_rounds += 1
        mb_w, mb_h = self._params[:2]
        n = mb_w * mb_h
        specs = [w[1] for w in wires.values()]
        if len(wires) < B:
            specs.append(self._dummy_wire[1])
        target = merge_specs(specs)
        total = wire_total(target, n)
        buf = wire_staging(B, total, self.device)
        rows = buf.numpy()
        emit_id = 0
        if ctx:
            t = recorder.mark("upload.merge", t, ctx[2], *ctx[:2])
            emit_id = recorder.new_id()

        def emit(i):
            t0 = now() if ctx else 0
            emit_wire(*wires.get(i, self._dummy_wire), target, n,
                      out=rows[i])
            if ctx:
                recorder.add("lane.emit", t0, now(), emit_id, *ctx[:2], i)

        list(self._pool.map(emit, range(B)))
        if ctx:
            t = recorder.mark("upload.emit", t, ctx[2], *ctx[:2], emit_id)
        out = []
        for (s0, s1), dev in zip(self._shards, self.mesh):
            batch = wire_to_device(buf[s0:s1], target, mb_w, mb_h, dev)
            cv = stage_cvoff([abis[i].get("cvoff") if i in abis else None
                              for i in range(s0, s1)], self.n_slots, dev)
            if cv is not None:
                batch["cvoff"] = cv
            out.append(batch)
        field = any("cvoff" in a for a in abis.values())
        if ctx:
            recorder.mark("upload.copy", t, ctx[2], *ctx[:2])
            ctx[3].update(upload="wire",
                          bytes=B * (total + 4 * self.n_slots * field))
        for i in wires:
            self.decoders[i].stats.upload_bytes += \
                total + 4 * self.n_slots * field
        return out

    # ---- lockstep decode --------------------------------------------------

    def decode(self, streams: list[bytes]) -> list[list[Frame]]:
        """Decode the Annex-B streams in lockstep; returns per-stream frame
        lists in output order (PendingFrames, or what on_frame returned,
        with materialize=False).  Failed streams yield partial lists; see
        self.errors.  With spans.recorder on, records the call's spans
        (the module's docstring there)."""
        B = self.n_streams
        if len(streams) != B:
            raise ValueError(f"{len(streams)} streams for {B} lanes")
        gens = [d.parse_pictures(s) for d, s in zip(self.decoders, streams)]
        pending: list = [None] * B
        frames: list[list] = [[] for _ in range(B)]
        in_flight: list[tuple[int, int]] = []   # fetches started, (lane, j)
        self.errors = [None] * B
        self.rounds = self.inter_rounds = 0
        self.wire_rounds = self.dense_rounds = 0
        self.upload_s = 0.0
        shard_of = [(s, i - s0) for s, (s0, s1) in enumerate(self._shards)
                    for i in range(s0, s1)]
        # spans: the call, its id, the round's number and id, and the
        # main-thread wait that the pool's spans of the moment belong to
        on = recorder.enabled
        call = recorder.new_call() if on else -1
        did = recorder.new_id() if on else 0
        t_call = t = now() if on else 0
        r, rid, wait = -1, 0, 0

        def fail(i, e):
            self.errors[i] = e
            gens[i] = None
            pending[i] = None

        def advance(i):
            t0 = now()
            try:
                pending[i] = next(gens[i])
            except StopIteration:
                gens[i] = None
                pending[i] = None
            except Exception as e:           # corrupt lane: isolate
                fail(i, e)
            t1 = now()
            self.decoders[i].stats.host_parse_s += (t1 - t0) / 1e9
            if on:
                recorder.add("lane.parse", t0, t1, wait, call, r, i)

        def pack(i):
            """(host ABI, wire records or None) of lane i's picture."""
            t0 = now()
            try:
                abi = self.decoders[i].pack_abi(*pending[i])
                if self.upload == "dense" or "wp" in abi:
                    return abi, None
                sps = pending[i][0].sps
                raw, spec = pack_wire_raw(abi, sps.pic_width_in_mbs,
                                          sps.pic_height_in_map_units)
                self.decoders[i].stats.pack_full_scans += \
                    raw["full_scans"] > 0
                return abi, (raw, spec)
            except Exception as e:
                fail(i, e)
                return None
            finally:
                t1 = now()
                self.decoders[i].stats.host_parse_s += (t1 - t0) / 1e9
                if on:
                    recorder.add("lane.pack", t0, t1, wait, call, r, i)

        def out(i, j, frame, parent, rnd):
            """Hand lane i's frame j out: on_frame's return value, else
            the frame; a frame_out instant."""
            if on:
                t = now()
                recorder.add("frame_out", t, t, parent, call, rnd, i)
            frames[i][j] = frame if self.on_frame is None else \
                self.on_frame(i, frame)

        if on:
            wait = recorder.new_id()
        list(self._pool.map(advance, range(B)))
        if on:
            t = recorder.mark("parse_first", t, did, call, sid=wait)
        while any(p is not None for p in pending):
            r = self.rounds
            if on:
                rid, wait, t_round = recorder.new_id(), recorder.new_id(), t
            live = [i for i in range(B) if pending[i] is not None]
            packed = dict(zip(live, self._pool.map(pack, live)))
            if on:
                t = recorder.mark("pack_wait", t, rid, call, r, wait)
            abis = {i: p[0] for i, p in packed.items() if p is not None}
            wires = {i: p[1] for i, p in packed.items()
                     if p is not None and p[1] is not None}
            del packed
            full_scans = sum(w[0]["full_scans"] > 0 for w in wires.values())
            if abis and self._params is None:
                pic = pending[next(iter(abis))][0]
                self._init_device(
                    stream_params(pic.sps, pic.pps),
                    max(dpb_slots(pending[i][0].sps) for i in abis))
                if on:
                    t = recorder.mark("setup.device_state", t, rid, call, r)
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
                    wires.pop(i, None)
            live = [i for i in live if i in abis]
            if not live:
                if on:
                    t = recorder.mark("round", t_round, did, call, r, rid,
                                      {"live": 0})
                break

            t0 = now()
            uid, attrs = (recorder.new_id(), {}) if on else (0, None)
            inter = _inter(abis.values())
            batches = self._upload(abis, wires,
                                   (call, r, uid, attrs) if on else None)
            wires.clear()  # release views of the parse buffers
            t1 = now()
            self.upload_s += (t1 - t0) / 1e9
            planes = self._step(batches, self._dpb_y, self._dpb_c, inter)
            del batches
            self.rounds += 1
            self.inter_rounds += inter
            t2 = now()

            # commit each lane; the reference stores of the round are
            # collected and written by one batched store
            lanes, slots = [], []
            mark = [len(f) for f in frames]
            for i in live:
                def rec(slot, y, cb, cr, i=i):
                    lanes.append(i)
                    slots.append(slot)

                s, j = shard_of[i]
                try:
                    frames[i].extend(self.decoders[i].commit(
                        *pending[i], *(p[j] for p in planes[s]),
                        self.n_slots, rec))
                except Exception as e:
                    fail(i, e)
            t3 = now()
            keep = [k for k, i in enumerate(lanes) if self.errors[i] is None]
            self._store(self._dpb_y, self._dpb_c, [lanes[k] for k in keep],
                        [slots[k] for k in keep], planes)
            t4 = now()
            # the commit loop is the control loop's, not the dispatch's
            dispatch_s = (t2 - t0 + t4 - t3) / 1e9
            for i in live:
                self.decoders[i].stats.device_dispatch_s += \
                    dispatch_s / len(live)
            abis.clear()   # release ABI views so parse buffers can recycle
            todo = [i for i in live if self.errors[i] is None]
            for i in todo:
                pending[i] = None
            if on:
                recorder.add("upload", t0, t1, rid, call, r, sid=uid)
                recorder.add("step", t1, t2, rid, call, r)
                recorder.add("commit", t2, t3, rid, call, r)
                recorder.add("store", t3, t4, rid, call, r)

            new = [(i, j) for i in range(B)
                   for j in range(mark[i], len(frames[i]))]
            n_out = len(in_flight) if self.materialize else len(new)
            if self.materialize:
                # queue this round's copies, then wait for last round's
                # (queued before this round's device work)
                for i, j in new:
                    frames[i][j].start_fetch()
                for i, j in in_flight:
                    self._finalize_timed(i, j, frames, rid, call, r)
                in_flight = new
            else:
                for i, j in new:
                    out(i, j, frames[i][j], rid, r)
            # parse the next round's pictures while this round runs on the
            # device
            if on:
                t = recorder.mark("output", t4, rid, call, r)
                wait = recorder.new_id()
            list(self._pool.map(advance, todo))
            if on:
                t = recorder.mark("parse_wait", t, rid, call, r, wait)
                attrs.update(live=len(live), committed=len(todo),
                             output=n_out, full_scans=full_scans)
                recorder.add("round", t_round, t, did, call, r, -1, rid,
                             attrs)

        for i in range(B):
            d = self.decoders[i]
            if self.errors[i] is None and d.dpb is not None:
                tail = len(frames[i])
                frames[i].extend(d._emit(p) for p in d.dpb.flush())
                if not self.materialize:
                    for j in range(tail, len(frames[i])):
                        out(i, j, frames[i][j], did, -1)
        if self.materialize:
            # every copy still to make is queued before the first wait
            rest = [(i, j) for i in range(B) for j in range(len(frames[i]))
                    if isinstance(frames[i][j], PendingFrame)]
            for i, j in rest:
                frames[i][j].start_fetch()
            for i, j in rest:
                self._finalize_timed(i, j, frames, did, call, -1)
        if on:
            t = recorder.mark("flush", t, did, call)
            recorder.add("decode", t_call, t, 0, call, sid=did)
        return frames

    def _finalize_timed(self, i: int, j: int, frames: list, parent: int,
                        call: int, rnd: int) -> None:
        """Materialize lane i's deferred frame j in place, timing the wait
        and copy into the lane's emit_sync_s; with spans on, the frame's
        frame_out instant (a child of `parent`) at the copy's end."""
        t0 = now()
        frames[i][j] = frames[i][j].finalize()
        t1 = now()
        self.decoders[i].stats.emit_sync_s += (t1 - t0) / 1e9
        if call >= 0:
            recorder.add("frame_out", t1, t1, parent, call, rnd, i)


def decode_batch_lockstep(abis: list[dict], dpbs: list[tuple], mesh=None,
                          **kw):
    """One lockstep reconstruction step over a stream batch.

    abis: per-stream host ABIs (same geometry); dpbs: per-stream DPB pairs
    (dpb_y [S, 4, ...], dpb_c [S, 2, ...]); mesh: the devices of the
    shards (parallel.sharding; default: the first DPB's device alone);
    kw: the keyword arguments of decode_frames_batch_fn other than
    `inter`.  Each shard's lanes are uploaded dense to its device and
    decoded there.  Returns (y, cb, cr) uint8 [B, H, W] / [B, H/2, W/2]
    on the first shard's device."""
    mesh = make_stream_mesh([dpbs[0][0].device] if mesh is None else mesh)
    step = sharded_decode_fn(mesh, len(abis), **kw)
    batches, dpb_y, dpb_c = [], [], []
    for (s0, s1), dev in zip(shard_bounds(mesh, len(abis)), mesh):
        dpb_y.append(torch.stack([d[0] for d in dpbs[s0:s1]]).to(dev))
        dpb_c.append(torch.stack([d[1] for d in dpbs[s0:s1]]).to(dev))
        batches.append(upload_batch(abis[s0:s1], dev, dpb_y[-1].shape[1]))
    planes = step(batches, dpb_y, dpb_c, _inter(abis))
    return tuple(torch.cat([p[k].to(mesh[0]) for p in planes])
                 for k in range(3))
