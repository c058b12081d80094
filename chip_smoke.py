"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):
  1. device   require CUDA; print the card (nvidia-smi) and CUDA version
  2. build    compile arrow_h264_tpu_torch/csrc/*.cu with nvcc (sm_90a),
              one nvcc per source, all started together
  3. kernels  each kernel against its plain PyTorch version on the card at
              1080p (mb 120 x 68), exact equality, with CUDA-event times;
              the raster-order kernels K5/K6 also against K1/K2; K1/K5
              also on a random intra ABI of every MB kind over random
              init planes (the JSON keeps the synthetic_abi numbers);
              each kernel's device launches in one wrapper call, counted
              by torch.profiler (every kernel must launch once per call)
  4. wavefront  K1, K2 and the row-pipelined K5, K6 50 times each on one
              1080p input, every output equal to the plain version; all
              four at B = 4 (four 1080p frames in one launch each), exact
              and timed
  5. mc       K3 and K4 (uint8 predictions) at B = 1 on synthetic_abi_p
              and with 5 % wild MVs, warm and cold (L2 flushed before
              each launch); on the first P and the first B picture of
              the smoke stream, with the DPB that picture's decode reads;
              and at B = 8 (eight streams, each over 4 reference pictures
              of its own: ~330 MB of DPB, far beyond the 50 MB L2), also
              with every cell at one quarter-sample position and with
              one MV and slot for every cell of a list (reads that share
              sectors); all exact and timed.  K4 takes each slot's
              cross-parity chroma offset (cvoff): zeros as frames pass
              it, and random -2, 0 or +2 a slot at B = 1 and B = 8 (the
              fields phase's part (a))
  6. decode   arrow_h264_tpu_torch.api.Decoder(device="cuda") decodes
              tests/data/smoke_1080p_high.264 twice, with order="phase"
              (kernels K1-K4) and order="raster" (K5, K6, K3, K4); every
              frame's MD5 must equal the committed libavcodec golden, and
              every kernel of each path must have launched in its decode
  7. batch    arrow_h264_tpu_torch.parallel.batch.BatchDecoder(8,
              device="cuda") decodes 8 lanes that cycle through the four
              committed 1080p streams (BATCH_STREAMS: 6, 6, 5 and 4
              frames, so lanes finish in different rounds and the dummy
              lane runs), once with each order: every lane's frame MD5s
              must equal its golden, and the order's intra and deblock
              kernels must have launched once a round and K3/K4 once a
              round with an inter lane, not once a lane.  Then with one
              lane cut in half and junk appended (its error recorded, the
              other 7 exact); with materialize=False (every frame a
              PendingFrame on the card whose finalize() gives the golden);
              and timed: frames/s of the whole batch at B = 8 and B = 32
              (32 lanes cycling the four streams), and in the same
              process the single-stream Decoder over the four streams one
              after another, with the lanes' summed host_parse_s,
              device_dispatch_s and emit_sync_s
  8. fields   the committed 1080i PAFF streams (FIELD_STREAMS,
              tests/data/field_1080i_s0/s1.264: 120 x 34 MB fields, 4
              and 3 frames, made by tools/field_smoke.py): (b) each
              alone through Decoder(device="cuda") with each order, MD5s
              of the woven frames equal to the libavcodec golden, the
              order's intra and deblock kernels launched once a field and
              K3/K4 once a P or B field; (c) BatchDecoder(4) over lanes
              that cycle the two, with each order, MD5s per lane and one
              launch a round (K3/K4 one a round with an inter lane); (d)
              frames/s of both, log lines `[fields]`
Then one JSON line of per-kernel results, the nvidia-smi line, and the
last line {"ok": true, "device": {...}}.

Each kernel's `bound_ms` is the least time the card could take for the
work of the timed call: the larger of its bytes over 3.35 TB/s and its
int32 operations over 67 T/s (the H100's published rates: HBM, and
float32 outside the tensor cores, which no int32 rate exceeds).  Bytes
count each input the work needs read once and each output written once,
from this run's inputs (see the *_need functions).  No single PyTorch
call computes H.264 intra prediction, the deblocking filter or the
quarter-sample MC bit-exactly, so `library_ms` is null for every kernel.
Each kernel's `launches` counts its wrapper's launches in the main path's
run: BatchDecoder(8) over the batch lanes with the order that runs the
kernel (one a round, so 6 for the six rounds: the same number as the
single-stream decode of the 6-frame smoke stream, whose count is
`launches_decode`).  Each kernel also gets `device_launches`, the kernels
it puts on the card per wrapper call.  K1, K2, K5 and K6 also get `ms_b4`
and `bound_ms_b4`: the same for four 1080p frames in one launch.  K3 and
K4 also get `ms_b8` and `bound_ms_b8` (eight 1080p streams in one launch)
and `ms_cold` (L2 flushed before each launch); K4 also `ms_cvoff`,
`bound_ms_cvoff`, `ms_b8_cvoff` and `bound_ms_b8_cvoff` (random
cross-parity offsets).  `launches_fields` counts each kernel's launches
in the fields phase's main path: BatchDecoder(4) over the 1080i lanes
with the kernel's order (8 rounds, 6 with an inter lane).  The other MC
figures (launched back to back from the host without the device sleep,
the smoke stream's pictures, the B = 8 variants) are log lines only.

A kernel's `ms` is the median over ROUNDS rounds of the mean of
KERNEL_REPS launches, timed with CUDA events.  Each round is enqueued
behind a device sleep, so the launches run back to back on the card and
the events time the kernels, not the host's cost of a wrapper call (tens
of microseconds, more than a small kernel takes).  A plain version's
`plain_ms` is its wall time, timed the same way with no sleep.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
STREAM = REPO / "tests" / "data" / "smoke_1080p_high.264"
BATCH_STREAMS = [STREAM] + [STREAM.parent / f"batch_1080p_s{i}.264"
                            for i in (1, 2, 3)]
FIELD_STREAMS = [STREAM.parent / f"field_1080i_s{i}.264" for i in (0, 1)]
BATCH_LANES = 8                # lanes of the exactness runs
FIELD_LANES = 4                # lanes of the 1080i batch runs
BATCH_WIDE = 32                # lanes of the wide timing run
MB_W, MB_H = 120, 68          # 1920x1088 coded
SEED = 0
KERNEL_REPS = 20
ROUNDS = 5                     # rounds of KERNEL_REPS launches per figure
SLEEP_CYCLES = 10_000_000      # device sleep ahead of a timed round (~5 ms)
FLUSH_BYTES = 128 << 20        # written before each cold launch (L2 50 MB)
REPEATS = 50                   # exactness loop of the wavefront kernels
B4 = 4                         # streams of the batched wavefront case
B8 = 8                         # streams of the batched MC case
HBM_BYTES_S = 3.35e12          # H100 SXM device memory
CORE_OPS_S = 67e12             # H100 SXM, outside the tensor cores


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int, rounds: int = 1, queued: bool = False) -> float:
    """Median over `rounds` of the mean ms per call of `reps` calls, from
    CUDA events, after one warm-up call.  queued: each round is enqueued
    behind a device sleep, so the events time the calls' kernels back to
    back; a round the host did not finish enqueueing within the sleep is
    made again with twice the sleep.  Without it this is the calls' wall
    time (for host-bound plain versions, the host's)."""
    fn()
    torch.cuda.synchronize()
    times, sleep = [], SLEEP_CYCLES
    while len(times) < rounds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(sleep)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        late = queued and start.query()
        end.synchronize()
        if late:
            sleep *= 2
        else:
            times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_ms(fn) -> float:
    """A kernel's `ms` (module docstring)."""
    return cuda_ms(fn, KERNEL_REPS, ROUNDS, queued=True)


def cold_ms(fn, reps: int) -> float:
    """Median ms of `reps` calls, each timed by its own event pair after
    writing FLUSH_BYTES, so that the 50 MB L2 holds none of the call's
    inputs; a short device sleep after the write lets the host enqueue
    the call before the card reaches it."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    pairs = []
    for i in range(reps):
        flush.fill_(i & 0xff)
        torch.cuda._sleep(SLEEP_CYCLES // 10)
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        fn()
        pair[1].record()
        pairs.append(pair)
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms for nbytes moved and ops done, which of the two bounds)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / CORE_OPS_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# int32 ABI words an MB of each kind (I4x4, I8x8, I16, PCM) reads besides
# `kind`: mb_avail (3, chroma), chroma_mode (but PCM), then
# i4_modes + i4_avail, i8_modes + i8_avail, or i16_mode
ABI_WORDS = (3 + 1 + 16 + 64, 3 + 1 + 4 + 16, 3 + 1 + 1, 3)


def intra_need(a, res, init=None) -> tuple[float, float]:
    """Bytes and operations of intra reconstruction: `kind` of every MB,
    the other ABI fields each intra MB's kind reads (ABI_WORDS), the
    prediction tables, the residual of the intra MBs and the init samples
    of the other MBs read once, the uint8 planes written once; per intra
    luma sample 2 ops per directional tap (13 for 4x4, 25 for 8x8) plus
    the clip and residual add, and a few per chroma sample."""
    from arrow_h264_tpu_torch.ops.intra_tables import R4, R8, S4, S8, W4, W8
    kind = a["kind"]
    counts = [int((kind == k).sum()) for k in range(4)]
    n, n_intra = kind.numel(), sum(counts)
    byts = 4 * (n + sum(c * w for c, w in zip(counts, ABI_WORDS))) \
        + sum(t.nbytes for t in (W4, S4, R4, W8, S8, R8)) \
        + nbytes(*res) * n_intra / n \
        + (0 if init is None else nbytes(*init) * (n - n_intra) / n) \
        + sum(r.numel() for r in res)           # uint8 planes out
    ops = 256 * (counts[0] * 30 + counts[1] * 54 + counts[2] * 6 + counts[3]) \
        + 128 * 6 * n_intra
    return byts, ops


def deblock_need(tables, planes) -> tuple[float, float]:
    """Bytes and operations of deblocking: the tables read once, and the
    samples of the edges that bS > 0 filters read and written once, taken
    in proportion to those edges; ~40 ops per filtered line of an edge."""
    bs = [tables[k] for k in ("bs_v", "bs_h", "bs_c")]
    frac = sum(int((b > 0).sum()) for b in bs) / sum(b.numel() for b in bs)
    lines = 4 * sum(int((tables[k] > 0).sum()) for k in ("bs_v", "bs_h")) \
        + 2 * 2 * int((tables["bs_c"] > 0).sum())
    return nbytes(*tables.values()) + 2 * frac * nbytes(*planes), 40 * lines


def mc_need(out, mv, rs, *tables) -> tuple[float, float]:
    """Bytes and operations of MC: MVs, slots and `tables` (K4's cvoff)
    read once, at least one reference byte per predicted sample and list,
    the prediction written once; ~12 ops per predicted sample and list
    (the quarter-sample average of two half-sample planes and its
    addressing)."""
    used = int((rs >= 0).sum())                 # (4x4 block, list) pairs
    per_pair = out.numel() // rs.numel()        # samples of one pair
    return nbytes(mv, rs, out, *tables) + used * per_pair, \
        12 * used * per_pair


def stream_mc_inputs(data: bytes, dev) -> dict:
    """{"P": ..., "B": ...}: the (dpb_y, dpb_c, mv, refslot) [1, ...]
    that K3/K4 get for the first P and the first B picture of a decode
    of `data`, each DPB as it stood when that picture was decoded.  The
    loop is Decoder.decode_annexb's, with the inputs taken on the way."""
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.models.pipeline import upload_abi
    dec = Decoder(device=dev)
    found = {}
    for pic, poc in dec.parse_pictures(data):
        abi = dec.pack_abi(pic, poc)
        pipe = dec._pipeline(pic.sps, pic.pps)
        hdr = pic.headers[0]
        kind = "P" if hdr.is_p else "B" if hdr.is_b else None
        if kind is not None and kind not in found:
            a = upload_abi(abi, dev)
            found[kind] = (pipe.dpb_y[None].clone(), pipe.dpb_c[None].clone(),
                           a["mv"][None], a["refslot"][None])
        planes = pipe.decode_frame(abi)
        for _ in dec.commit(pic, poc, *planes, pipe.n_slots, pipe.store_ref):
            pass
    return found


def device_launches(calls: dict) -> dict:
    """{key: kernels named `key`_kernel that one call of calls[key] puts
    on the card}, from the device activities of one torch.profiler
    session that makes each call once."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in calls.values():
            call()
            torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    return {key: sum(e.count for e in dev_events if f"{key}_kernel" in e.key)
            for key in calls}


def compare(name: str, got, want) -> int:
    """Exact equality, dtype included, of two tensors or tuples of tensors;
    returns the max absolute error (0) or exits."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            sys.exit(f"{name}: {g.dtype} {tuple(g.shape)} != {w.dtype} "
                     f"{tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max().item()))
    if err:
        sys.exit(f"{name}: kernel differs from its plain version "
                 f"(max abs err {err})")
    return err


def batch_phase(paths: dict, smi: str) -> dict:
    """The batch phase (module docstring); returns {order: LAUNCHES of the
    main path's run, BatchDecoder(BATCH_LANES) with that order}."""
    from arrow_h264_tpu_torch.api import Decoder, PendingFrame
    from arrow_h264_tpu_torch.ops import kernels
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    data = [p.read_bytes() for p in BATCH_STREAMS]
    golden = [json.loads(p.with_suffix(".json").read_text())["md5"]
              for p in BATCH_STREAMS]

    def run(n, order="phase", materialize=True, corrupt=None):
        """Decode n lanes cycling through BATCH_STREAMS; check every lane
        but `corrupt` against its golden and the launches against the
        rounds.  Returns (decoder, frames, wall seconds, launches)."""
        datas = [data[i % len(data)] for i in range(n)]
        if corrupt is not None:
            d = datas[corrupt]
            datas[corrupt] = d[:len(d) // 2] + b"\x00\x17" * 40
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.perf_counter()
        with BatchDecoder(n, device="cuda", order=order,
                          materialize=materialize) as bd:
            outs = bd.decode(datas)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = dict(kernels.LAUNCHES)
        what = f"batch B={n} order={order}" + (
            "" if materialize else " materialize=False") + (
            "" if corrupt is None else f" lane {corrupt} corrupt")
        if any(d.entropy != "cpp" for d in bd.decoders):
            sys.exit(f"{what}: host entropy is not the C++ library")
        for i, frames in enumerate(outs):
            if i == corrupt:
                if bd.errors[i] is None:
                    sys.exit(f"{what}: the corrupt lane raised no error")
                continue
            if bd.errors[i] is not None:
                sys.exit(f"{what}: lane {i} failed: {bd.errors[i]!r}")
            if not materialize:
                if not all(isinstance(f, PendingFrame)
                           and f.y.device.type == "cuda" for f in frames):
                    sys.exit(f"{what}: lane {i} has frames that are not "
                             "PendingFrames on the card")
                frames = [f.finalize() for f in frames]
            md5 = [hashlib.md5(f.planar()).hexdigest() for f in frames]
            if md5 != golden[i % len(data)]:
                name = BATCH_STREAMS[i % len(data)].name
                sys.exit(f"{what}: lane {i} ({name}) MD5s differ from the "
                         "golden")
        intra, deblock, *mc = paths[order]
        want = dict.fromkeys(kernels.LAUNCHES, 0)
        want.update({intra: bd.rounds, deblock: bd.rounds,
                     **dict.fromkeys(mc, bd.inter_rounds)})
        if got != want or not 0 < bd.inter_rounds <= bd.rounds:
            sys.exit(f"{what}: launches {got}, expected {want} (one a round; "
                     f"{bd.rounds} rounds, {bd.inter_rounds} with an inter "
                     "lane)")
        if bd.rounds != max(len(golden[i % len(data)]) for i in range(n)
                            if i != corrupt):
            sys.exit(f"{what}: {bd.rounds} rounds")
        return bd, outs, wall, got

    def report(what, bd, wall):
        frames = sum(s["frames"] for s in bd.stats)
        sums = {k: round(sum(s[k] for s in bd.stats), 4) for k in
                ("host_parse_s", "device_dispatch_s", "emit_sync_s")}
        log("batch", f"{what}: {frames} frames in {wall:.4f} s, "
            f"{frames / wall:.3f} frames/s of the batch ({bd.rounds} rounds, "
            f"{bd.inter_rounds} inter); lanes' summed {sums}; on {smi}")

    run(BATCH_LANES)                             # warm-up: first-call costs
    launches = {}
    for order in paths:
        bd, _, wall, launches[order] = run(BATCH_LANES, order)
        log("batch", f"order={order}: {BATCH_LANES} lanes MD5 == golden; "
            f"launches {launches[order]} in {bd.rounds} rounds")
        report(f"B={BATCH_LANES} order={order}", bd, wall)
    bad = 2
    bd, *_ = run(BATCH_LANES, corrupt=bad)
    log("batch", f"lane {bad} corrupt: errors[{bad}] = "
        f"{type(bd.errors[bad]).__name__}: {bd.errors[bad]}; the other "
        f"{BATCH_LANES - 1} lanes MD5 == golden")
    run(BATCH_LANES, materialize=False)
    log("batch", "materialize=False: every frame a PendingFrame on the "
        "card, finalize() == golden")
    run(BATCH_WIDE)                              # warm-up at B = 32
    bd, _, wall, _ = run(BATCH_WIDE)
    report(f"B={BATCH_WIDE} order=phase", bd, wall)

    # the single-stream Decoder over the same four streams, one after
    # another, in the same process
    frames, wall, stats = 0, 0.0, []
    for d, md5 in zip(data, golden):
        dec = Decoder(device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = [hashlib.md5(f.planar()).hexdigest()
               for f in dec.decode_annexb(d)]
        torch.cuda.synchronize()
        wall += time.perf_counter() - t
        if got != md5:
            sys.exit("single-stream decode: MD5s differ from the golden")
        frames += len(got)
        stats.append(dec.stats.as_dict())
    sums = {k: round(sum(s[k] for s in stats), 4)
            for k in ("host_parse_s", "device_dispatch_s", "emit_sync_s")}
    log("batch", f"single-stream Decoder over the {len(data)} streams: "
        f"{frames} frames in {wall:.4f} s, {frames / wall:.3f} frames/s; "
        f"summed {sums}; on {smi}")
    return launches


def fields_phase(paths: dict, smi: str) -> dict:
    """The fields phase (module docstring), parts (b)-(d); returns {order:
    LAUNCHES of its main path's run, BatchDecoder(FIELD_LANES) over the
    1080i streams with that order}."""
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.ops import kernels
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    data = [p.read_bytes() for p in FIELD_STREAMS]
    meta = [json.loads(p.with_suffix(".json").read_text())
            for p in FIELD_STREAMS]

    def want(order, fields, inter_fields):
        intra, deblock, *mc = paths[order]
        w = dict.fromkeys(kernels.LAUNCHES, 0)
        w.update({intra: fields, deblock: fields,
                  **dict.fromkeys(mc, inter_fields)})
        return w

    def decode(order, d):
        dec = Decoder(device="cuda", order=order)
        torch.cuda.synchronize()
        t = time.perf_counter()
        md5 = [hashlib.md5(f.planar()).hexdigest()
               for f in dec.decode_annexb(d)]
        torch.cuda.synchronize()
        return dec, md5, time.perf_counter() - t

    # (b) each stream alone, with each order
    for order in paths:
        frames, wall = 0, 0.0
        for p, d, m in zip(FIELD_STREAMS, data, meta):
            decode(order, d)                     # warm-up: first-call costs
            kernels.reset_launches()
            dec, md5, wall_s = decode(order, d)
            got = dict(kernels.LAUNCHES)
            if md5 != m["md5"]:
                bad = [i for i, (a, b) in enumerate(zip(md5, m["md5"]))
                       if a != b]
                sys.exit(f"fields {p.name} {order}: {len(md5)} frames, "
                         f"golden {len(m['md5'])}; MD5 mismatch at {bad}")
            fields = 2 * len(m["structure"])
            inter = 2 * sum(k != "I" for k in m["structure"])
            if got != want(order, fields, inter) or \
                    dec.stats.frames != fields:
                sys.exit(f"fields {p.name} {order}: launches {got}, "
                         f"expected {want(order, fields, inter)} (a field "
                         f"picture each; K3/K4 for {inter} P/B fields)")
            frames += len(md5)
            wall += wall_s
            log("fields", f"{p.name} order={order}: {len(md5)} frames "
                f"({fields} fields) {m['width']}x{m['height']} MD5 == "
                f"libavcodec golden; launches {got}; {wall_s:.4f} s; "
                f"stats {dec.stats.as_dict()}")
        log("fields", f"single-stream Decoder order={order} over the "
            f"{len(data)} 1080i streams: {frames} frames in {wall:.4f} s, "
            f"{frames / wall:.3f} frames/s ({2 * frames / wall:.3f} fields/"
            f"s); on {smi}")

    # (c), (d) lockstep lanes that cycle the streams, with each order
    launches = {}
    for order in paths:
        datas = [data[i % len(data)] for i in range(FIELD_LANES)]
        lanes = [meta[i % len(data)] for i in range(FIELD_LANES)]
        for _ in range(2):                       # warm-up, then the run
            torch.cuda.synchronize()
            kernels.reset_launches()
            t = time.perf_counter()
            with BatchDecoder(FIELD_LANES, device="cuda", order=order) as bd:
                outs = bd.decode(datas)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches[order] = got = dict(kernels.LAUNCHES)
        for i, (frames, m) in enumerate(zip(outs, lanes)):
            if bd.errors[i] is not None:
                sys.exit(f"fields batch {order}: lane {i} failed: "
                         f"{bd.errors[i]!r}")
            if [hashlib.md5(f.planar()).hexdigest() for f in frames] \
                    != m["md5"]:
                sys.exit(f"fields batch {order}: lane {i} MD5s differ from "
                         "the golden")
        rounds = max(2 * len(m["structure"]) for m in lanes)
        inter = rounds - 2                      # all but the I pair
        if (bd.rounds, bd.inter_rounds) != (rounds, inter) or \
                got != want(order, bd.rounds, bd.inter_rounds):
            sys.exit(f"fields batch {order}: launches {got} in {bd.rounds} "
                     f"rounds ({bd.inter_rounds} inter), expected "
                     f"{want(order, rounds, inter)}")
        n = sum(len(f) for f in outs)
        log("fields", f"BatchDecoder({FIELD_LANES}) order={order}: every lane "
            f"MD5 == golden; launches {got} in {bd.rounds} rounds "
            f"({bd.inter_rounds} inter); {n} frames in {wall:.4f} s, "
            f"{n / wall:.3f} frames/s of the batch; on {smi}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs only on a GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.device_count()} device(s)")

    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.models.pipeline import dpb_alloc, store_ref_fn
    from arrow_h264_tpu_torch.ops import kernels
    from arrow_h264_tpu_torch.ops.deblock import (
        deblock_filter_planes, deblock_tables,
    )
    from arrow_h264_tpu_torch.ops.intra import intra_reconstruct
    from arrow_h264_tpu_torch.ops.inter import mc_chroma_plain, mc_luma_plain
    from arrow_h264_tpu_torch.ops.kernels import build
    from arrow_h264_tpu_torch.ops.kernels.deblock_phase import deblock_phase
    from arrow_h264_tpu_torch.ops.kernels.deblock_raster import deblock_raster
    from arrow_h264_tpu_torch.ops.kernels.intra_phase import intra_phase
    from arrow_h264_tpu_torch.ops.kernels.intra_raster import intra_raster
    from arrow_h264_tpu_torch.ops.kernels.mc import mc_chroma, mc_luma
    from arrow_h264_tpu_torch.ops.synthetic import (
        random_intra_abi, synthetic_batch,
    )
    from arrow_h264_tpu_torch.ops.transforms import (
        make_ws_consts, residual_planes,
    )

    # ---- build
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    log("build", f"{lib.relative_to(REPO)} in "
        f"{time.perf_counter() - t0:.3f} s (nvcc {build.build_seconds} s)")

    # ---- kernels vs plain versions at 1080p
    H, W = MB_H * 16, MB_W * 16
    ws4, ws8 = (t.to(dev) for t in make_ws_consts([[16] * 16] * 6,
                                                  [[16] * 64] * 2))
    results = {}
    calls = {}                       # key -> one call of the kernel

    def record(key, name, src, replaces, err, ms, plain_ms, need, note,
               call):
        bound_ms, bound_by = bound(*need)
        log("kernels", f"{name} {note}: equal, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        calls.setdefault(key, call)
        results.setdefault(key, dict(
            name=name, route="cuda", source=src, replaces=replaces,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None))

    # K1/K5 + K2/K6 on synthetic I (all intra) and P (inter MVs: bS 0..2)
    # ABIs; each pair against the plain version and against each other
    intra_kernels = (
        ("intra_phase", intra_phase, "K1", "intra_phase.cu",
         "arrow_h264_tpu/ops/pallas/intra_phase.py:694"),
        ("intra_raster", intra_raster, "K5", "intra_raster.cu",
         "arrow_h264_tpu/ops/pallas/intra_kernel.py:355"))
    deblock_kernels = (
        ("deblock_phase", deblock_phase, "K2", "deblock_phase.cu",
         "arrow_h264_tpu/ops/pallas/deblock_phase.py:395"),
        ("deblock_raster", deblock_raster, "K6", "deblock_raster.cu",
         "arrow_h264_tpu/ops/pallas/deblock_kernel.py:287"))
    for note, inter in (("synthetic_abi", False), ("synthetic_abi_p", True)):
        _, a = synthetic_batch(MB_W, MB_H, SEED, dev, inter=inter,
                               **({"bi_frac": 0.3} if inter else {}))
        res = residual_planes(a, MB_W, MB_H, ws4, ws8)
        if note == "synthetic_abi":
            want = tuple(p.to(torch.uint8)
                         for p in intra_reconstruct(a, *res, MB_W, MB_H))
            plain = cuda_ms(lambda: intra_reconstruct(a, *res, MB_W, MB_H), 1)
            outs = []
            for key, fn, kid, src, replaces in intra_kernels:
                got = fn(a, *res, None, None, None, MB_W, MB_H)
                torch.cuda.synchronize()
                err = compare(key, got, want)
                call = partial(fn, a, *res, None, None, None, MB_W, MB_H)
                ms = kernel_ms(call)
                record(key, f"{key} ({kid})",
                       f"arrow_h264_tpu_torch/csrc/{src}", replaces, err, ms,
                       plain, intra_need(a, res), note, call)
                outs.append(got)
            compare("intra_raster vs intra_phase", outs[1], outs[0])
            planes = outs[0]
        else:                        # mid-grey planes with texture
            g = torch.Generator(device=dev).manual_seed(SEED)
            planes = tuple(torch.randint(96, 160, s, generator=g, device=dev,
                                         dtype=torch.uint8)
                           for s in ((1, H, W), (1, H // 2, W // 2),
                                     (1, H // 2, W // 2)))
        tables = deblock_tables(a, MB_W, MB_H)
        want = tuple(p.to(torch.uint8)
                     for p in deblock_filter_planes(*planes, tables,
                                                    MB_W, MB_H))
        plain = cuda_ms(lambda: deblock_filter_planes(*planes, tables,
                                                      MB_W, MB_H), 1)
        outs = []
        for key, fn, kid, src, replaces in deblock_kernels:
            got = fn(*(p.clone() for p in planes), tables, MB_W, MB_H)
            torch.cuda.synchronize()
            err = compare(key, got, want)
            work = tuple(p.clone() for p in planes)
            call = partial(fn, *work, tables, MB_W, MB_H)
            ms = kernel_ms(call)
            record(key, f"{key} ({kid})", f"arrow_h264_tpu_torch/csrc/{src}",
                   replaces, err, ms, plain, deblock_need(tables, planes),
                   note, call)
            outs.append(got)
        compare("deblock_raster vs deblock_phase", outs[1], outs[0])
        if note == "synthetic_abi":      # K2, K6 again and again
            for key, fn, kid, *_ in deblock_kernels:
                for _ in range(REPEATS):
                    compare(f"{key} repeated", fn(*(p.clone() for p in planes),
                                                  tables, MB_W, MB_H), want)
                log("wavefront", f"{key} ({kid}): {REPEATS} calls on {note}, "
                    "each equal to the plain version")

    # K1/K5 on a random intra ABI of every kind (I4x4, I8x8, I16, PCM with
    # raw samples 0..255 as residual, and inter MBs that the kernels skip
    # and read as neighbours from random init planes)
    ra = {k: torch.from_numpy(v).to(dev)[None]
          for k, v in random_intra_abi(MB_W, MB_H, SEED + 4).items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    shapes = ((1, H, W), (1, H // 2, W // 2), (1, H // 2, W // 2))
    pcm = (ra["kind"].view(1, MB_H, MB_W) == 3) \
        .repeat_interleave(16, 1).repeat_interleave(16, 2)
    res = [torch.randint(-300, 300, s, generator=g, device=dev,
                         dtype=torch.int32) for s in shapes]
    res = [torch.where(m, r.remainder(256), r)
           for r, m in zip(res, (pcm, pcm[:, ::2, ::2], pcm[:, ::2, ::2]))]
    init = [torch.randint(0, 256, s, generator=g, device=dev,
                          dtype=torch.int32) for s in shapes]
    want = tuple(p.to(torch.uint8)
                 for p in intra_reconstruct(ra, *res, MB_W, MB_H, *init))
    plain = cuda_ms(lambda: intra_reconstruct(ra, *res, MB_W, MB_H, *init), 1)
    outs = []
    for key, fn, kid, src, replaces in intra_kernels:
        got = fn(ra, *res, *init, MB_W, MB_H)
        torch.cuda.synchronize()
        err = compare(key, got, want)
        call = partial(fn, ra, *res, *init, MB_W, MB_H)
        ms = kernel_ms(call)
        record(key, f"{key} ({kid})", f"arrow_h264_tpu_torch/csrc/{src}",
               replaces, err, ms, plain, intra_need(ra, res, init),
               "random_intra_abi", call)
        outs.append(got)
    compare("intra_raster vs intra_phase", outs[1], outs[0])
    # K1, K5 again and again on the input with every MB kind and inter MBs
    for key, fn, kid, *_ in intra_kernels:
        for _ in range(REPEATS):
            compare(f"{key} repeated", fn(ra, *res, *init, MB_W, MB_H), want)
        log("wavefront", f"{key} ({kid}): {REPEATS} calls on "
            "random_intra_abi, each equal to the plain version")

    # K1, K5 + K2, K6 at B = 4: four synthetic all-intra 1080p frames per
    # launch
    batch = [synthetic_batch(MB_W, MB_H, SEED + 10 + i, dev)[1]
             for i in range(B4)]
    a4 = {k: torch.cat([x[k] for x in batch]) for k in batch[0]}
    res4 = residual_planes(a4, MB_W, MB_H, ws4, ws8)
    want = tuple(p.to(torch.uint8)
                 for p in intra_reconstruct(a4, *res4, MB_W, MB_H))
    for key, fn, *_ in intra_kernels:
        got = fn(a4, *res4, None, None, None, MB_W, MB_H)
        compare(f"{key} B={B4}", got, want)
        results[key].update(
            ms_b4=kernel_ms(partial(fn, a4, *res4, None, None, None,
                                    MB_W, MB_H)),
            bound_ms_b4=bound(*intra_need(a4, res4))[0])
    tables4 = deblock_tables(a4, MB_W, MB_H)
    want = tuple(p.to(torch.uint8) for p in deblock_filter_planes(
        *got, tables4, MB_W, MB_H))
    for key, fn, *_ in deblock_kernels:
        compare(f"{key} B={B4}", fn(*(p.clone() for p in got), tables4,
                                     MB_W, MB_H), want)
        work = tuple(p.clone() for p in got)
        results[key].update(
            ms_b4=kernel_ms(partial(fn, *work, tables4, MB_W, MB_H)),
            bound_ms_b4=bound(*deblock_need(tables4, got))[0])
    log("wavefront", f"B={B4}: " + ", ".join(
        f"{key} {results[key]['ms_b4']:.4f} ms"
        for key, *_ in intra_kernels + deblock_kernels)
        + " per launch, all equal to the plain versions")

    # K3 + K4 on a P/B ABI over 4 random reference pictures, then with 5%
    # wild MVs (+-512 quarter samples); on synthetic_abi_p also cold (L2
    # flushed before each launch) and unqueued.  K4 takes each slot's
    # cross-parity chroma offset: zeros, as frames pass it, except in the
    # cvoff cases (random -2, 0 or +2 a slot, as field pictures pass it)
    mc_kernels = (("mc_luma", mc_luma, mc_luma_plain, "K3", "460"),
                  ("mc_chroma", mc_chroma, mc_chroma_plain, "K4", "505"))
    n_slots = 4
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def mc_args(key, dpbs, mv, rs, cvoff=None):
        """The arguments of K3 (key "mc_luma") or K4 but the grid size."""
        if key == "mc_luma":
            return dpbs[0], mv, rs
        if cvoff is None:
            cvoff = torch.zeros(dpbs[1].shape[:2], dtype=torch.int32,
                                device=dev)
        return dpbs[1], mv, rs, cvoff

    gc = torch.Generator(device=dev).manual_seed(SEED + 5)

    def random_cvoff(B):
        return torch.randint(-1, 2, (B, n_slots), generator=gc, device=dev,
                             dtype=torch.int32) * 2

    def random_dpbs(B):
        """[B, n_slots, ...] luma and chroma DPBs, every slot of every
        stream stored from its own random picture."""
        ys, cs = zip(*(dpb_alloc(MB_W, MB_H, n_slots, dev) for _ in range(B)))
        dpbs = torch.stack(ys), torch.stack(cs)
        for b in range(B):
            for s in range(n_slots):
                store_ref_fn(dpbs[0][b], dpbs[1][b], s, *(
                    torch.randint(0, 256, shp, generator=g, device=dev,
                                  dtype=torch.uint8)
                    for shp in ((H, W), (H // 2, W // 2), (H // 2, W // 2))))
        return dpbs

    dpbs = random_dpbs(1)
    abi_h, _ = synthetic_batch(MB_W, MB_H, SEED + 2, dev, inter=True,
                               n_slots=n_slots, bi_frac=0.3)
    rng = np.random.default_rng(SEED + 3)
    wild = rng.random((MB_W * MB_H, 4, 4)) < 0.05
    wmv = rng.integers(-512, 513, abi_h["mv"].shape).astype(np.int32)
    rs = torch.from_numpy(abi_h["refslot"]).to(dev)[None]
    for note, mv_h in (("synthetic_abi_p", abi_h["mv"]),
                       ("wild mv", np.where(wild[..., None, None], wmv,
                                            abi_h["mv"]))):
        mv = torch.from_numpy(np.ascontiguousarray(mv_h)).to(dev)[None]
        for key, kern, plain_fn, kid, line in mc_kernels:
            args = mc_args(key, dpbs, mv, rs)
            got = kern(*args, MB_W, MB_H)
            torch.cuda.synchronize()
            err = compare(key, got, plain_fn(*args, MB_W, MB_H))
            call = partial(kern, *args, MB_W, MB_H)
            ms = kernel_ms(call)
            plain = cuda_ms(lambda: plain_fn(*args, MB_W, MB_H),
                            KERNEL_REPS)
            record(key, f"{key} ({kid})", "arrow_h264_tpu_torch/csrc/mc.cu",
                   f"arrow_h264_tpu/ops/pallas/mc_kernel.py:{line}", err, ms,
                   plain, mc_need(got, *args[1:]), note, call)
            if note == "synthetic_abi_p":
                r = results[key]
                r.update(ms_cold=cold_ms(call, KERNEL_REPS))
                log("mc", f"{r['name']}: cold {r['ms_cold']:.4f} ms, "
                    f"unqueued {cuda_ms(call, KERNEL_REPS, ROUNDS):.4f} ms, "
                    f"{got.dtype}")

    def mc_case(note, dpbs, mv, rs, cvoff=None, keys=("mc_luma",
                                                      "mc_chroma")):
        """K3 and K4 (`keys` of them) on one input: equal to the plain
        versions; logs the kernel ms and the bound; returns {key: (ms,
        bound_ms)}."""
        out = {}
        for key, kern, plain_fn, kid, _ in mc_kernels:
            if key not in keys:
                continue
            args = mc_args(key, dpbs, mv, rs, cvoff)
            got = kern(*args, MB_W, MB_H)
            torch.cuda.synchronize()
            compare(f"{key} {note}", got, plain_fn(*args, MB_W, MB_H))
            out[key] = (kernel_ms(partial(kern, *args, MB_W, MB_H)),
                        bound(*mc_need(got, *args[1:]))[0])
            log("mc", f"{key} ({kid}) {note} ({nbytes(args[0]) / 1e6:.1f} "
                f"MB of DPB): equal, kernel {out[key][0]:.4f} ms, bound "
                f"{out[key][1]:.4f} ms")
        return out

    # K4 with cross-parity offsets on the synthetic_abi_p input (the
    # fields phase's part (a))
    mv = torch.from_numpy(np.ascontiguousarray(abi_h["mv"])).to(dev)[None]
    ms, bound_ms = mc_case("cvoff", dpbs, mv, rs, random_cvoff(1),
                           ("mc_chroma",))["mc_chroma"]
    results["mc_chroma"].update(ms_cvoff=ms, bound_ms_cvoff=bound_ms)
    del dpbs

    # K3 + K4 on the smoke stream's own pictures
    for kind, (*dpbs, mv, rs) in stream_mc_inputs(STREAM.read_bytes(),
                                                   dev).items():
        mc_case(f"smoke stream {kind} picture", dpbs, mv, rs)

    # K3 + K4 at B = 8: eight synthetic_abi_p streams in one launch, each
    # over 4 reference pictures of its own; K4 also with cross-parity
    # offsets; then every cell at one quarter-sample (and 1/8-sample)
    # position, each with its own integer MV and slot; then one MV and
    # slot for all cells of a list, so that neighbouring cells read
    # neighbouring samples
    dpbs = random_dpbs(B8)
    abis = [synthetic_batch(MB_W, MB_H, SEED + 20 + b, dev, inter=True,
                            n_slots=n_slots, bi_frac=0.3)[1]
            for b in range(B8)]
    mv, rs = (torch.cat([a[k] for a in abis]) for k in ("mv", "refslot"))
    del abis
    for key, (ms, bound_ms) in mc_case(f"B={B8}", dpbs, mv, rs).items():
        results[key].update(ms_b8=ms, bound_ms_b8=bound_ms)
    ms, bound_ms = mc_case(f"B={B8} cvoff", dpbs, mv, rs, random_cvoff(B8),
                           ("mc_chroma",))["mc_chroma"]
    results["mc_chroma"].update(ms_b8_cvoff=ms, bound_ms_b8_cvoff=bound_ms)
    frac = torch.tensor([5, 3], dtype=torch.int32, device=dev)
    mc_case(f"B={B8} one position", dpbs, (mv & ~7) | frac, rs)
    one_slot = torch.arange(2, dtype=torch.int32, device=dev)
    mc_case(f"B={B8} one MV and slot a list", dpbs,
            torch.zeros_like(mv) + frac, torch.where(rs >= 0, one_slot, rs))
    del dpbs

    # device launches per wrapper call: every kernel must launch once
    for key, n_dev in device_launches(calls).items():
        results[key]["device_launches"] = n_dev
        log("kernels", f"{results[key]['name']}: {n_dev} device launch(es) "
            "per wrapper call")
        if n_dev != 1:
            sys.exit(f"{key}: {n_dev} device launches per call, not 1")

    # ---- the main paths: decode the committed 1080p High stream with each
    # order of the intra and deblock kernels
    golden = json.loads(STREAM.with_suffix(".json").read_text())
    data = STREAM.read_bytes()

    paths = {"phase": ("intra_phase", "deblock_phase", "mc_luma",
                        "mc_chroma"),
             "raster": ("intra_raster", "deblock_raster", "mc_luma",
                        "mc_chroma")}

    def decode(order):
        dec = Decoder(device="cuda", order=order)
        t = time.perf_counter()
        md5 = [hashlib.md5(f.planar()).hexdigest()
               for f in dec.decode_annexb(data)]
        torch.cuda.synchronize()
        return dec, md5, time.perf_counter() - t

    launches = {}
    for order, path in paths.items():
        _, _, cold_s = decode(order)            # warm-up: first-call costs
        kernels.reset_launches()
        dec, md5, wall_s = decode(order)
        launches[order] = dict(kernels.LAUNCHES)
        if dec.entropy != "cpp":
            sys.exit(f"decode: host entropy is {dec.entropy!r}, not the C++ "
                     "library")
        if md5 != golden["md5"]:
            bad = [i for i, (a, b) in enumerate(zip(md5, golden["md5"]))
                   if a != b]
            sys.exit(f"decode {order}: {len(md5)} frames, golden "
                     f"{len(golden['md5'])}; MD5 mismatch at frames {bad}")
        ran = {k for k, v in launches[order].items() if v}
        if ran != set(path):
            sys.exit(f"decode {order}: launched {sorted(ran)}, expected "
                     f"{sorted(path)}: {launches[order]}")
        log("decode", f"order={order}: {len(md5)} frames "
            f"{golden['width']}x{golden['height']} MD5 == libavcodec golden; "
            f"{wall_s:.3f} s wall, {len(md5) / wall_s:.3f} fps (first pass "
            f"{cold_s:.3f} s) on {smi}; launches {launches[order]}; stats "
            f"{dec.stats.as_dict()}")

    batch_launches = batch_phase(paths, smi)
    field_launches = fields_phase(paths, smi)

    if "jax" in sys.modules or any(m.split(".")[0] == "arrow_h264_tpu"
                                   for m in sys.modules):
        sys.exit("the port imported jax or the JAX package")
    for key, r in results.items():
        order = "raster" if key.endswith("_raster") else "phase"
        r["launches"] = batch_launches[order][key]
        r["launches_decode"] = launches[order][key]
        r["launches_fields"] = field_launches[order][key]
    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
