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
              init planes, K2/K6 also on random tables (bS 0..4, tc0
              0..25, alpha and beta 0..255) over random planes (the JSON
              keeps the synthetic_abi numbers);
              K7 (deblock_tables) and K8 (unpack_bm8), the two stages
              the reference computes in XLA: K7's twelve tables
              torch.equal to ops/deblock.py::deblock_tables at 1080p and
              3840x2160, B = 1 and 4, on synthetic_abi_p,
              random_deblock_abi and synthetic_abi_p as fields (the JSON
              keeps the synthetic_abi_p frames); K8's dense output
              torch.equal to ops/wire.py::_scatter_bm8 for every bm8
              class of the smoke stream's pictures (each alone, and
              pictures 1-4 as four lanes) and of the uhd lanes (conf_c5
              picture 1 alone and as four lanes), from its one call for
              all of a round's classes (unpack_bm8_round) and from its
              one-class form, timed on the round's call;
              K9 (residual), K10 (inter_combine) and K11 (store_refs),
              the three stages on every picture's path that the
              reference computes in XLA: K9 torch.equal to
              ops/transforms.py::residual_planes on the wire rounds of
              the smoke stream's picture 1, pictures 1-4 as four lanes,
              conf_c5's picture 1 and four lanes of it (the JSON's
              figures), and on random_residual_abi, lossy and bypass, at
              1080p and 4K; K10 to ops/inter.py::inter_init_plain on the
              smoke stream's first B picture (K3's and K4's lists over
              the DPB it reads; its wire upload with the per-slice
              weight tables, and its dense upload) and on
              random_weighted_abi with tables,
              one shared table and dense weights at 1080p and 4K, B = 1
              and 4; K11 to ops/inter.py::store_refs_plain storing into
              DPBs of random bytes at 1080p and 4K, B = 1 and 4; then
              every K9/K10/K11 call of real decodes (the smoke stream,
              the lossless stream, the four 1080p streams as
              BatchDecoder lanes and the dense- and table-weighted
              lanes) compared with its plain version, and the phase's
              seconds logged;
              K12 (unpack_wire), the wire's device unpack but the bm8
              classes: its dict (with K8's classes) torch.equal to
              ops/wire.py::unpack_wire_plain for every key on the wire
              rounds above (each smoke picture alone, pictures 1-4 as
              four lanes, conf_c5's picture 1 and the uhd round of four),
              on every picture of feat_lossless_qcif (I_PCM) and
              feat_wp_table (weight-table rows) alone and as one round,
              and on rounds of four random 1080p lanes forced to each of
              ops/synthetic.py's WIRE_CASES (every scheme of every
              section); K12 alone (bm8=False) timed on the timed rounds
              beside its byte bound;
              each kernel's device launches in one wrapper call, counted
              by torch.profiler after phase 10 (every kernel must launch
              once per call, K8 its DEVICE_LAUNCHES, 2, K12 one, two
              where a section ships sparse rows)
  4. wavefront  K1, K2 and the row-pipelined K5, K6 50 times each on one
              1080p input, every output equal to the plain version; all
              four at B = 4 (four 1080p frames in one launch each), exact
              and timed, K2/K6 also on synthetic_abi_p and random tables
  5. mc       K3 and K4 (uint8 predictions) at B = 1 on synthetic_abi_p
              and with 5 % wild MVs, warm and cold (L2 flushed before
              each launch); on the first P and the first B picture of
              the smoke stream, with the DPB that picture's decode reads;
              and at B = 8 (eight streams, each over 4 reference pictures
              of its own: ~330 MB of DPB, far beyond the 50 MB L2), also
              with every cell at one quarter-sample position and with
              one MV and slot for every cell of a list (reads that share
              sectors); MBs split 16x8, 8x16 or 8x8 with one MV and slot
              a part (tools/mc_bench.py's partitions family) at B = 1
              and B = 8; all exact and timed.  K4 takes each slot's
              cross-parity chroma offset (cvoff): zeros as frames pass
              it, and random -2, 0 or +2 a slot at B = 1 and B = 8 (the
              fields phase's part (a))
  6. decode   arrow_h264_tpu_torch.api.Decoder(device="cuda") decodes
              tests/data/smoke_1080p_high.264 twice, with order="phase"
              (kernels K1-K4) and order="raster" (K5, K6, K3, K4); every
              frame's MD5 must equal the committed libavcodec golden, and
              every kernel of each path must have launched in its decode.
              Each timed decode runs with the host library's
              GIL meter on (host/centropy.py gil_meter: the seconds spent
              inside the C++ library's calls, which release the GIL): log
              line `[gil]` with host_parse_s, the released seconds inside
              it (the parse's calls) and in all, and gil_hold_pct =
              100 (host_parse_s - released inside it) / host_parse_s
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
              device_dispatch_s and emit_sync_s.  The timed B = 8 runs,
              the B = 32 run and that single-stream run have the GIL
              meter on: `[gil]` lines with the single stream's
              gil_hold_pct and GIL-held ms a frame over the four streams,
              and for each B the lanes' summed host_parse_s, the released
              seconds a round, and the GIL's serial floor for a round (the
              single stream's GIL-held ms a frame times the round's
              frames) beside the round's wall (a pool lane's host_parse_s
              also holds its waits for the GIL, so no share is computed
              from it)
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
  9. features  the committed feature streams (FEATURE_STREAMS,
              tests/data/feat_*.264, made by tools/feature_streams.py):
              lossless bypass (CABAC with I_PCM at QP 0, CAVLC DPCM at
              164x132), CIF configs 2-4, widths 512 and 976, the seven
              FMO map types, ASO, FMO CAVLC pairs at 8 x 6 and 120 x 68
              MBs, concealment of a dropped slice at 64x64 and 1080p,
              dense per-cell weights (18 weighted slices) and a
              table-weighted lane of the same geometry.  (a) each alone
              through Decoder(device="cuda") with each order: MD5s equal
              to the JSON's expected output, the order's intra and
              deblock kernels launched once a picture and K3/K4 once a
              picture with inter MBs (none on the all-I streams),
              `concealed` as in the JSON; (b) BatchDecoder over the lanes
              of FEATURE_BATCHES with each order: MD5s per lane, the
              rounds and one launch a round; (c) the CLI as a subprocess,
              `python -m arrow_h264_tpu_torch decode` of the smoke stream
              with each order (the YUV file's frames equal the golden
              MD5s, exit 0), `info` (exit 0) and `decode --ref` against a
              reference with one byte flipped (exit 1); (d) frames/s of
              every stream and batch, log lines `[features]`
 10. wire     the compact wire upload (ops/wire.py, the default of every
              decode above; phases 7-9 also check that every round went
              through it, but the rounds with a lane of dense per-cell
              weights, which go dense) and the stream sharding
              (parallel/sharding.py): (a) for every picture of the smoke
              stream, upload_wire on the card equal (torch.equal) to the
              dense upload_batch for every key, refid by its equality
              structure, alone and as one merged batch of all six; (b)
              the wire's bytes a picture on the four 1080p streams
              against the dense ABI's, pack_wire_raw's host ms a picture,
              and on the card the wire buffer's copy plus unpack_wire
              against the dense ABI's copies, at B = 1, 8 and 32 (CUDA
              events); (c) Decoder(upload="dense") on the smoke
              stream, MD5-exact, and frames/s of the single stream and
              of BatchDecoder at B = 1, 8 and 32 with each order and
              upload in turns (wire, dense, dense, wire), with the main
              thread's upload ms a round; and after the profiler session
              at the end, one unpack_wire call at B = 1, 8 and 32: its
              device launches (K8's one call for the round's bm8 classes,
              two kernels, and K12's, no other kernel, at most
              MAX_UNPACK_LAUNCHES, 4) and their summed device ms; (d)
              BatchDecoder(8, mesh=("cuda:0",) * 2) over the four 1080p
              streams with each order: MD5-exact, the order's intra and
              deblock kernels
              launched twice a round (once a shard), K3/K4 twice a round
              with an inter lane; frames/s against one shard.  Log lines
              `[wire]`.
 11. conformance  the committed conformance streams
              (tools/conformance_streams.py) through
              tools/gpu_conformance.py's decode, each run twice (a warm-up,
              then the run whose launches are counted), log lines
              `[conformance]` with frames, MD5 verdict, frames/s and the
              peak of torch.cuda.max_memory_allocated: (a) configs 1-6
              (QCIF to 3840x2160, tests/data/conf_cN.264) each alone
              through Decoder with each order, every frame equal to its
              golden MD5, the order's intra and deblock kernels launched
              once a picture and K3/K4 once a P/B picture; (b)
              BatchDecoder(4) over the 4K lanes (conf_c5, batch_2160p_s1,
              twice) with each order, MD5s per lane, one launch a round,
              every round through the wire; (c) BatchDecoder(2) over the
              720p lanes of two GOPs each (gop_720p_s0/s1: IDRs every 6
              and 4 frames, so that a round puts an IDR lane beside a P/B
              lane) with each order and once with upload="dense"; (d)
              K1-K6 at 3840x2160, each against its plain version at B = 4
              (four pictures or streams in one launch, as the 4K
              BatchDecoder launches them) and at B = 1 (K2/K6 also on
              synthetic_abi_p and random tables), timed at B = 1 as
              in phases 3 and 5, with the byte bound and the plain
              versions' seconds; and the chain estimate of K1, K2, K5 and K6
              at 1080p and 4K: the kernel's ms on a one-MB-row strip of
              the picture's width, whose MBs it walks one after another,
              times the picture's 2 (mb_h - 1) + mb_w chain steps over
              mb_w (an estimate, not a floor; log lines only).
In phases 6-11 every decode also launches K7 and K9 once a picture (a
round; twice a round with two shards), K10 with K3/K4, K12 once a wire
upload and K8 once for each wire upload that ships a coefficient class
as bm8 (neither on a dense round) and K11 once for each reference store
with a storing lane (tools/gpu_conformance.py bm8_tally counts them from
the calls of unpack_wire and store_refs_fn).
Then one torch.profiler session counts the device launches of each
kernel's wrapper call and the kernels of one unpack_wire call at each B
of phase 10 with their summed device time (`[kernels]`, `[wire]`
lines), then one JSON line of per-kernel results, the nvidia-smi line,
and the last line {"ok": true, "device": {...}}.

Each kernel's `bound_ms` is the least time the card could take for the
work of the timed call: the larger of its bytes over 3.35 TB/s and its
int32 operations over 67 T/s (the H100's published rates: HBM, and
float32 outside the tensor cores, which no int32 rate exceeds).  Bytes
count each input the work needs read once and each output written once,
from this run's inputs (see the *_need functions).  No single PyTorch
call computes H.264 intra prediction, the deblocking filter, the
quarter-sample MC, the deblocking tables, the bm8 expansion, the
residual stage, the weighted combine, the half-sample planes or the wire
unpack bit-exactly, so `library_ms` is null for every kernel.  K7-K12's
`replaces` name the reference's XLA stage: no pallas_call matches them.
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
cross-parity offsets).  K3 and K4 also get `ms_partitions`,
`bound_ms_partitions`, `ms_b8_partitions` and `bound_ms_b8_partitions`
(MBs split into 16x8, 8x16 or 8x8 parts, at B = 1 and B = 8).
`launches_fields` counts each kernel's launches in the fields phase's
main path: BatchDecoder(4) over the 1080i lanes
with the kernel's order (8 rounds, 6 with an inter lane);
`launches_features` in the features phase's: every feature stream through
Decoder with the kernel's order, one after another; `launches_conformance`
in the conformance phase's: BatchDecoder(4) over the 4K lanes with the
kernel's order (3 rounds, 2 with an inter lane).  `ms_2160p` and
`bound_ms_2160p` are each kernel's time and bound at 3840x2160 (K2/K6
on synthetic_abi, K3/K4 on synthetic_abi_p over 4 random references).
K7 and K8 also get `ms_b4`, `ms_2160p`, `ms_b4_2160p`, the bound and
the plain version's ms of each (`bound_ms_*`, `plain_ms_*`): K7 on
synthetic_abi_p, K8 on all bm8 classes of the wire rounds of smoke
pictures 1-4 as four lanes, of conf_c5's picture 1 and of the uhd round
of four (its `ms` smoke picture 1's round; each bound sums bm8_need over
the round's classes).  K9, K10
and K11 get the same keys: K9 on the wire rounds above (smoke picture 1,
pictures 1-4, conf_c5 picture 1, the uhd round), K10 on the smoke
stream's B picture's wire upload (`ms`: the per-slice table lookup the
main path runs) and random_weighted_abi with tables (the others), K11
storing random pictures into slot 1 of 3.  K12 gets the same keys on
the rounds of K8 (its `ms` K12 alone on smoke picture 1's round; its
`plain_ms` the whole unpack_wire_plain, whose bm8 classes go through K8
as on the path before K12).
The other MC figures (launched back to back from the host without the
device sleep, the smoke stream's pictures, the B = 8 variants) are log
lines only.

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
import tempfile
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
# the committed feature streams (tools/feature_streams.py) and the lanes
# of the features phase's BatchDecoder runs: name -> (lanes, rounds,
# rounds with an inter lane, rounds uploaded dense: those with a lane of
# dense per-cell weights)
FEATURE_STREAMS = (
    "feat_lossless_qcif", "feat_lossless_164x132", "feat_cif_cfg2",
    "feat_cif_cfg3", "feat_cif_cfg4", "feat_w512", "feat_w976",
    "feat_w512_high", "feat_fmo_boxout_t3", "feat_fmo_dispersed_t1",
    "feat_fmo_explicit_t6", "feat_fmo_fg_bg_t2", "feat_fmo_interleave_t0",
    "feat_fmo_raster_t4", "feat_fmo_wipe_t5", "feat_aso",
    "feat_fmo_cavlc_interleave", "feat_fmo_cavlc_explicit",
    "feat_fmo1080_interleave", "feat_fmo1080_explicit", "feat_conceal64",
    "feat_conceal1080", "feat_qcif_cfg2", "feat_wp18", "feat_wp_table")
FEATURE_BATCHES = {
    "dense weights": (("feat_wp18", "feat_wp18"), 3, 2, 2),
    "dense beside table weights": (("feat_wp18", "feat_wp_table"), 3, 2, 2),
    "CIF configs 2-4": (("feat_cif_cfg2", "feat_cif_cfg3", "feat_cif_cfg4"),
                        4, 3, 0),
    "1080p FMO": (("feat_fmo1080_interleave", "feat_fmo1080_explicit"),
                  3, 2, 0),
    "lossless QCIF": (("feat_lossless_qcif", "feat_lossless_qcif"), 5, 4, 0),
    "DPB of 2 and 5 slots": (("feat_qcif_cfg2", "batch_qcif_s3"), 5, 4, 0),
}
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
WIRE_BATCHES = (1, 8, 32)      # lanes of the wire phase's upload timings
MAX_UNPACK_LAUNCHES = 4        # device launches of one unpack_wire call
SHARDS = 2                     # shards on the one card of the wire phase
CONF_CONFIGS = (1, 2, 3, 4, 5, 6)   # the conformance phase's configs
CONF_BATCH = 4                 # lanes of the 4K BatchDecoder
GOP_LANES = ("gop_720p_s0", "gop_720p_s1")
MB_W_4K, MB_H_4K = 240, 135    # 3840x2160
HBM_BYTES_S = 3.35e12          # H100 SXM device memory
CORE_OPS_S = 67e12             # H100 SXM, outside the tensor cores


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def metered(fn):
    """fn() with the host library's GIL meter on: (fn's result, released
    seconds, {C function: released seconds})."""
    from arrow_h264_tpu_torch.host.centropy import gil_meter
    gil_meter.reset()
    gil_meter.enabled = True
    try:
        out = fn()
    finally:
        gil_meter.enabled = False
    return out, gil_meter.released_s, dict(gil_meter.calls)


# the library's calls made inside a decode's host_parse_s (the parse); the
# wire pack's scans run in the upload, h264e_build_col in the DPB commit
PARSE_CALLS = ("h264e_parse_slice", "h264e_reset_pic")


def per_unit(calls: dict, n: int) -> dict:
    """{C function: released ms} over n frames or rounds."""
    return {k: round(1e3 * v / n, 4) for k, v in sorted(calls.items())}


def gil_line(what: str, frames: int, wall: float, parse_s: float,
             released: float, calls: dict, smi: str) -> float:
    """Log a single-stream decode's [gil] line: gil_hold_pct = 100
    (host_parse_s - released inside it) / host_parse_s, exact on one
    thread.  Returns the GIL-held ms a frame."""
    inside = sum(calls.get(k, 0.0) for k in PARSE_CALLS)
    held_ms = 1e3 * (parse_s - inside) / frames
    log("gil", f"{what}: {frames} frames in {wall:.4f} s; host_parse_s "
        f"{parse_s:.4f} s, of it {inside:.4f} s inside the library's parse "
        f"calls; gil_hold_pct {100 * (parse_s - inside) / parse_s:.2f}; GIL "
        f"held {held_ms:.3f} ms a frame; released_s {released:.4f} s in all,"
        f" ms a frame by call {per_unit(calls, frames)}; on {smi}")
    return held_ms


def cuda_ms(fn, reps: int, rounds: int = 1, queued: bool = False) -> float:
    """Median over `rounds` of the mean ms per call of `reps` calls, from
    CUDA events, after one warm-up call.  queued: each round is enqueued
    behind a device sleep, so the events time the calls' kernels back to
    back; a round the host did not finish enqueueing within the sleep is
    made again with twice the sleep, up to 2**8 times SLEEP_CYCLES (a
    call that waits for the device is never done first: that exits).
    Without it this is the calls' wall time (for host-bound plain
    versions, the host's)."""
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
            if sleep > SLEEP_CYCLES << 8:
                sys.exit(f"cuda_ms: {reps} calls were not enqueued within "
                         f"{sleep // 2} cycles of device sleep; a call "
                         "waits for the device")
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
    packed prediction tables, the residual of the intra MBs and the init
    samples of the other MBs read once, the uint8 planes written once;
    per intra luma sample 2 ops per directional tap (3 taps, and the 8x8
    reference filter) plus the clip and residual add, and a few per
    chroma sample."""
    from arrow_h264_tpu_torch.ops.kernels.intra_phase import intra_tables
    kind = a["kind"]
    counts = [int((kind == k).sum()) for k in range(4)]
    n, n_intra = kind.numel(), sum(counts)
    byts = 4 * (n + sum(c * w for c, w in zip(counts, ABI_WORDS))) \
        + intra_tables().nbytes \
        + nbytes(*res) * n_intra / n \
        + (0 if init is None else nbytes(*init) * (n - n_intra) / n) \
        + sum(r.numel() for r in res)           # uint8 planes out
    ops = 256 * (counts[0] * 8 + counts[1] * 10 + counts[2] * 6 + counts[3]) \
        + 128 * 6 * n_intra
    return byts, ops


def random_deblock_case(mb_w: int, mb_h: int, B: int, seed: int):
    """(planes, tables) on the card: random uint8 planes (0..255) and
    random_deblock_tables (bS 0..4, tc0 0..25, alpha and beta 0..255)."""
    from arrow_h264_tpu_torch.ops.synthetic import random_deblock_tables
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, W = mb_h * 16, mb_w * 16
    planes = tuple(torch.randint(0, 256, s, generator=g, device="cuda",
                                 dtype=torch.uint8)
                   for s in ((B, H, W), (B, H // 2, W // 2),
                             (B, H // 2, W // 2)))
    return planes, {k: torch.from_numpy(v).to("cuda") for k, v in
                    random_deblock_tables(mb_w, mb_h, B, seed).items()}


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
    """{"P": ..., "B": ...}: the (dpb_y, dpb_c, mv, refslot, (abi, dense))
    [1, ...] that K3/K4 (and K9, K10: abi) get for the first P and the
    first B picture of a decode of `data`, each DPB as it stood when that
    picture was decoded; abi is the picture's upload as the main path
    makes it (the wire, unless the picture carries dense weights), dense
    its dense upload (upload_abi).  The loop is Decoder.decode_annexb's,
    with the inputs taken on the way."""
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.models.pipeline import upload_abi, upload_wire
    from arrow_h264_tpu_torch.ops.wire import pack_wire_raw
    dec = Decoder(device=dev)
    found = {}
    for pic, poc in dec.parse_pictures(data):
        abi = dec.pack_abi(pic, poc)
        pipe = dec._pipeline(pic.sps, pic.pps)
        hdr = pic.headers[0]
        kind = "P" if hdr.is_p else "B" if hdr.is_b else None
        if kind is not None and kind not in found:
            dense = {k: v[None] for k, v in upload_abi(abi, dev).items()}
            a = dense
            if "wp" not in abi:
                raw, spec = pack_wire_raw(abi, pipe.mb_w, pipe.mb_h)
                a = upload_wire([(raw, spec)], spec, pipe.mb_w, pipe.mb_h,
                                dev, pipe.n_slots, [abi.get("cvoff")])
            found[kind] = (pipe.dpb_y[None].clone(), pipe.dpb_c[None].clone(),
                           a["mv"], a["refslot"], (a, dense))
        planes = pipe.decode_frame(abi)
        for _ in dec.commit(pic, poc, *planes, pipe.n_slots, pipe.store_ref):
            pass
    return found


def device_launches(calls: dict, regions: dict) -> dict:
    """{key: kernels named `key`_kernel that one call of calls[key] puts
    on the card} and {name: (the device activities that one call of
    regions[name] puts on the card, whatever their names, their summed
    device ms and their names)}, from one torch.profiler session that
    makes each call once (a region's under a record_function range of its
    name)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in calls.values():
            call()
            torch.cuda.synchronize()
        for name, call in regions.items():
            with record_function(name):
                call()
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof.key_averages() if e.device_type == cuda]
    out = {key: sum(e.count for e in dev_events if f"{key}_kernel" in e.key)
           for key in calls}
    # a region's device activities are those that start between its range
    # and the next one's (each call ends in a synchronize): kernels that
    # ctypes launches belong to no torch operator, so the range's own
    # event lists none of them (the device's copy of each range is left
    # out by its name)
    starts = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.name in regions and e.device_type != cuda)
    for k, (start, name) in enumerate(starts):
        end = starts[k + 1][0] if k + 1 < len(starts) else float("inf")
        ks = [e for e in prof.events() if e.device_type == cuda
              and e.name not in regions and start <= e.time_range.start < end]
        out[name] = (len(ks), sum(e.time_range.elapsed_us() for e in ks)
                     / 1e3, {e.name for e in ks})
    return out


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


def compare_tables(name: str, got: dict, want: dict) -> int:
    """compare() of the twelve deblocking tables, key by key."""
    if list(got) != list(want):
        sys.exit(f"{name}: keys {list(got)} != {list(want)}")
    return max(compare(f"{name} {k}", got[k], want[k]) for k in want)


def tables_need(a: dict, tables: dict) -> tuple[float, float]:
    """Bytes and operations of the deblocking tables: the ABI fields that
    K7 reads (ops/kernels/deblock_tables.py ABI_FIELDS) and the four
    constant tables read once, the twelve tables written once; ~1500
    int32 ops an MB (32 edge segments of ~40, and the table lookups)."""
    from arrow_h264_tpu_torch.ops.kernels.deblock_tables import ABI_FIELDS
    n_mb = a["kind"].numel()
    return nbytes(*(a[k] for k, _ in ABI_FIELDS), *tables.values()) \
        + 4 * (52 + 52 + 3 * 52 + 52), 1500 * n_mb


def bm8_need(idx, bm, vals, out) -> tuple[float, float]:
    """Bytes and operations of a bm8 expansion: the indices, bitmaps and
    values of every lane read once (views of the wire: their own bytes),
    the dense output written once; ~4 int32 ops an output word."""
    return nbytes(idx, bm, vals, out), 4 * out.numel()


def wire_round(abis: list, mb_w: int, mb_h: int, dev) -> tuple:
    """One wire round of the host ABIs `abis` (one a lane) on the card:
    (its [B, total] buffer, its spec, and its bm8 sections as unpack_wire
    hands them to K8: [(class, idx, bm, vals, grid, w)], views of the
    buffer)."""
    from arrow_h264_tpu_torch.ops import wire
    n = mb_w * mb_h
    packs = [wire.pack_wire_raw(a, mb_w, mb_h) for a in abis]
    target = wire.merge_specs([sp for _, sp in packs])
    buf = torch.from_numpy(np.stack([wire.emit_wire(r, sp, target, n)
                                     for r, sp in packs])).to(dev)
    table, _ = wire._offsets(target, n)
    sd = {f: sch for f, sch, _ in target}
    return buf, target, [
        (f, *(wire._read(buf, table, f + sfx)
              for sfx in ("_idx", "_bm", "_val")), n * cpm, w)
        for f, _, cpm, w in wire._COEFF_FIELDS if sd[f] == "bm8"]


def unpack_need(buf, n: int, spec, out: dict) -> tuple[float, float]:
    """Bytes and operations of K12's work on a wire round: the sections it
    reads once (all but the bm8 classes'; of a sparse section's rows only
    those whose index lies in the picture, whose values a thread reads),
    each of its outputs written once (neither the bm8 classes nor an
    identity wtab, an expanded view, are its); ~4 int32 ops an output
    word."""
    from arrow_h264_tpu_torch.ops import wire
    table, _ = wire._offsets(spec, n)
    sd = {f: sch for f, sch, _ in spec}
    bm8 = {f + sfx for f, sch in sd.items() if sch == "bm8"
           for sfx in ("_idx", "_bm", "_val")}
    rows_of = {"in_ext": ("in_idx", n), "nu_mv": ("nu_idx", n),
               "nu_ref": ("nu_idx", n), "pcm_val": ("pcm_idx", n),
               "wt_val": ("wt_idx", 16)}
    read = 0
    for name, (_, dt, shape) in table.items():
        if name in bm8:
            continue
        size = int(np.prod(shape)) * np.dtype(dt).itemsize
        idx, lim = rows_of.get(name, (None, 0))
        if idx in table:
            i = wire._read(buf, table, idx)
            read += int(((i >= 0) & (i < lim)).sum()) * size // shape[0]
        else:
            read += buf.shape[0] * size
    words = sum(v.numel() for k, v in out.items()
                if k != "wtab" or sd["wtab"] != "zero")
    return read + 4 * words, 4 * words


def tables_and_wire(record, results: dict, smi: str) -> int:
    """Phase 3's K7 (deblock_tables), K8 (unpack_bm8) and K12
    (unpack_wire), against their plain versions (module docstring);
    returns the device launches of the K12 call recorded for the
    profiler session (one, two with sparse rows)."""
    from arrow_h264_tpu_torch.ops.deblock import (
        deblock_tables as tables_plain,
    )
    from arrow_h264_tpu_torch.ops.kernels.deblock_tables import (
        deblock_tables,
    )
    from arrow_h264_tpu_torch.ops.kernels.unpack_bm8 import unpack_bm8
    from arrow_h264_tpu_torch.ops.kernels.unpack_wire import (
        device_launches as k12_launches, unpack_bm8_round,
        unpack_wire as unpack_wire_k12,
    )
    from arrow_h264_tpu_torch.ops.synthetic import (
        WIRE_CASES, forced_wire_round, random_deblock_abi, synthetic_batch,
    )
    from arrow_h264_tpu_torch.ops.wire import (
        _COEFF_FIELDS, _scatter_bm8, unpack_wire_plain,
    )
    dev = torch.device("cuda")
    cqp = (2, -3)
    key = {f: k for f, k, *_ in _COEFF_FIELDS}     # class -> ABI key
    k7 = ("deblock_tables", "deblock_tables (K7)",
          "arrow_h264_tpu_torch/csrc/deblock_tables.cu",
          "arrow_h264_tpu/ops/deblock.py:354 (XLA; no pallas_call)")
    k8 = ("unpack_bm8", "unpack_bm8 (K8)",
          "arrow_h264_tpu_torch/csrc/unpack_bm8.cu",
          "arrow_h264_tpu/ops/wire.py:1057 (XLA; no pallas_call)")
    k12 = ("unpack_wire", "unpack_wire (K12)",
           "arrow_h264_tpu_torch/csrc/unpack_wire.cu",
           "arrow_h264_tpu/ops/wire.py:1072 (XLA; no pallas_call)")

    # K7 at 1080p and 3840x2160, B = 1 and 4: synthetic_abi_p frames (the
    # JSON's figures), random_deblock_abi, and synthetic_abi_p as fields
    for (mb_w, mb_h), size in (((MB_W, MB_H), ""),
                               ((MB_W_4K, MB_H_4K), "_2160p")):
        for B in (1, B4):
            lanes = [synthetic_batch(mb_w, mb_h, SEED + 50 + i, dev,
                                     inter=True, bi_frac=0.3)[1]
                     for i in range(B)]
            ap = {k: torch.cat([x[k] for x in lanes]) for k in lanes[0]}
            ar = {k: torch.from_numpy(v).to(dev) for k, v in
                  random_deblock_abi(mb_w, mb_h, B, SEED + 51).items()}
            del lanes
            for note, a, field in (("synthetic_abi_p", ap, False),
                                   ("random_deblock_abi", ar, False),
                                   ("synthetic_abi_p field", ap, True)):
                what = f"{note} {16 * mb_w}x{16 * mb_h} B={B}"
                want = tables_plain(a, mb_w, mb_h, cqp, field)
                got = deblock_tables(a, mb_w, mb_h, cqp, field)
                torch.cuda.synchronize()
                err = compare_tables(f"deblock_tables {what}", got, want)
                call = partial(deblock_tables, a, mb_w, mb_h, cqp, field)
                ms = kernel_ms(call)
                plain = cuda_ms(partial(tables_plain, a, mb_w, mb_h, cqp,
                                        field), KERNEL_REPS)
                need = tables_need(a, got)
                if note != "synthetic_abi_p":
                    log("kernels", f"{k7[1]} {what}: equal, kernel {ms:.4f}"
                        f" ms, plain {plain:.4f} ms, bound "
                        f"{bound(*need)[0]:.4f} ms")
                elif B == 1 and not size:
                    record(*k7, err, ms, plain, need, what, call)
                else:
                    tag = ("_b4" if B > 1 else "") + size
                    results["deblock_tables"].update(
                        {f"ms{tag}": ms, f"bound_ms{tag}": bound(*need)[0],
                         f"plain_ms{tag}": plain})
                    log("kernels", f"{k7[1]} {what}: equal, kernel {ms:.4f}"
                        f" ms, plain {plain:.4f} ms, bound "
                        f"{bound(*need)[0]:.4f} ms")
            del ap, ar
    log("kernels", f"{k7[1]}: the twelve tables torch.equal to the plain "
        f"version at 1080p and 3840x2160, B = 1 and {B4}, frames and "
        "fields")

    # K8 on the wire of real pictures: the smoke stream's, each alone and
    # pictures 1-4 as one round of four lanes, then the uhd lanes' (four
    # conf_c5 lanes: picture 1 alone and round 1 of the four)
    smoke, _ = stream_abis(STREAM.read_bytes(), dev)
    uhd, _ = stream_abis((STREAM.parent / "conf_c5.264").read_bytes(), dev)
    rounds = [(f"smoke picture {i}", [a], MB_W, MB_H, "" if i == 1 else None)
              for i, a in enumerate(smoke)] + [
        (f"smoke pictures 1-{B4} as {B4} lanes", smoke[1:1 + B4], MB_W, MB_H,
         "_b4"),
        ("conf_c5 picture 1", [uhd[1]], MB_W_4K, MB_H_4K, "_2160p"),
        (f"uhd round 1 ({B4} conf_c5 lanes)", [uhd[1]] * B4, MB_W_4K,
         MB_H_4K, "_b4_2160p")]
    checked = 0
    k12_rounds, k12_want = 0, 0

    def unpack_round(what, buf, mb_w, mb_h, spec, tag=None):
        """K12 (with K8 for the bm8 classes) against unpack_wire_plain on
        one round, every key torch.equal; timed where `tag` is a str (K12
        alone: bm8=False)."""
        nonlocal k12_rounds, k12_want
        want = unpack_wire_plain(buf, mb_w, mb_h, spec)
        got = unpack_wire_k12(buf, mb_w, mb_h, spec)
        torch.cuda.synchronize()
        err = compare_tables(f"unpack_wire {what}", got, want)
        k12_rounds += 1
        if tag is None:
            return
        call = partial(unpack_wire_k12, buf, mb_w, mb_h, spec, bm8=False)
        ms = kernel_ms(call)
        plain = cuda_ms(partial(unpack_wire_plain, buf, mb_w, mb_h, spec),
                        KERNEL_REPS)
        need = unpack_need(buf, mb_w * mb_h, spec, call())
        if not tag:
            record(*k12, err, ms, plain, need, what, call)
            k12_want = k12_launches(spec, mb_w * mb_h)
        else:
            results["unpack_wire"].update(
                {f"ms{tag}": ms, f"bound_ms{tag}": bound(*need)[0],
                 f"plain_ms{tag}": plain})
            log("kernels", f"{k12[1]} {what}: equal, kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, bound {bound(*need)[0]:.4f} ms")

    for what, abis, mb_w, mb_h, tag in rounds:
        buf, spec, classes = wire_round(abis, mb_w, mb_h, dev)
        unpack_round(what, buf, mb_w, mb_h, spec, tag)
        # K8's one call over the round's bm8 classes, then its one-class
        # form on each class
        got = unpack_bm8_round(buf, mb_w, mb_h, spec)
        torch.cuda.synchronize()
        if set(got) != {key[f] for f, *_ in classes}:
            sys.exit(f"unpack_bm8 {what}: classes {sorted(got)}, expected "
                     f"{sorted(key[f] for f, *_ in classes)}")
        err = 0
        for f, idx, bm, vals, grid, w in classes:
            want = _scatter_bm8(idx, bm, vals, grid, w)
            err = max(err, compare(f"unpack_bm8 {what} {f} (round)",
                                   got[key[f]].view(want.shape), want))
            compare(f"unpack_bm8 {what} {f}",
                    unpack_bm8(idx, bm, vals, grid, w), want)
            checked += 1
        if tag is None or not classes:
            continue
        call = partial(unpack_bm8_round, buf, mb_w, mb_h, spec)
        ms = kernel_ms(call)
        plain = cuda_ms(lambda: [_scatter_bm8(*c[1:]) for c in classes],
                        KERNEL_REPS)
        need = [sum(x) for x in zip(*(bm8_need(idx, bm, vals, got[key[f]])
                                      for f, idx, bm, vals, _, _ in
                                      classes))]
        note = f"{what}, its {len(classes)} bm8 classes"
        if not tag:
            record(*k8, err, ms, plain, need, note, call)
        else:
            results["unpack_bm8"].update(
                {f"ms{tag}": ms, f"bound_ms{tag}": bound(*need)[0],
                 f"plain_ms{tag}": plain})
            log("kernels", f"{k8[1]} {note}: equal, kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, bound {bound(*need)[0]:.4f} ms")
    del smoke, uhd
    if "unpack_bm8" not in results:
        sys.exit("unpack_bm8: the smoke stream's picture 1 shipped no class "
                 "as bm8")
    log("kernels", f"{k8[1]}: {checked} bm8 classes of the smoke stream's "
        f"and the uhd lanes' wire rounds torch.equal to the plain version, "
        f"from the round's one call and from the one-class form; on {smi}")

    # K12 also on the rounds of a feature stream that ships I_PCM and one
    # that ships weight-table rows (each picture alone, then all of them
    # as one round), and on rounds of random lanes forced to every scheme
    t = time.perf_counter()
    shipped = set()
    for name, need in (("feat_lossless_qcif", ("pcm", "sparse")),
                       ("feat_wp_table", ("wtab", "sparse"))):
        abis, _ = stream_abis((STREAM.parent / f"{name}.264").read_bytes(),
                              dev)
        mb_w, mb_h = abis[0]["mb_w"], abis[0]["mb_h"]
        for i, a in enumerate(abis + [None]):
            lanes = abis if a is None else [a]
            buf, spec, _ = wire_round(lanes, mb_w, mb_h, dev)
            shipped |= {(f, sch) for f, sch, _ in spec}
            unpack_round(f"{name} " + (f"picture {i}" if a is not None else
                                       f"pictures 0-{i - 1} as {i} lanes"),
                         buf, mb_w, mb_h, spec)
        if need not in shipped:
            sys.exit(f"unpack_wire: {name} shipped no {need[0]} section as "
                     f"{need[1]}")
    for case in WIRE_CASES:
        wide, spec = forced_wire_round(case, MB_W, MB_H, B4, SEED + 60,
                                       distinct=2)
        buf = torch.from_numpy(wide.base).to(dev)[:, :wide.shape[1]]
        shipped |= {(f, sch) for f, sch, _ in spec}
        unpack_round(f"forced {case} {B4} lanes", buf, MB_W, MB_H, spec)
    schemes = {("intra", s) for s in ("zero", "sparse", "dense")} | {
        ("inter", s) for s in ("zero", "base", "dense")} | {
        ("pcm", s) for s in ("zero", "sparse", "dense")} | {
        ("wtab", s) for s in ("zero", "sparse")}
    if not schemes <= shipped or not {"dense", "dense16"} <= {
            sch for _, sch in shipped}:
        sys.exit(f"unpack_wire: the rounds missed schemes "
                 f"{sorted(schemes - shipped)}")
    log("kernels", f"{k12[1]}: {k12_rounds} wire rounds (the smoke "
        f"stream's, the uhd lanes', feat_lossless_qcif's and "
        f"feat_wp_table's, and {len(WIRE_CASES)} forced to every scheme) "
        f"torch.equal to unpack_wire_plain for every key; the feature and "
        f"forced rounds in {time.perf_counter() - t:.1f} s; on {smi}")
    return k12_want


def residual_need(a: dict, bypass: bool, out) -> tuple[float, float]:
    """Bytes and operations of the residual stage (K9), counted per MB
    from what that MB needs: kind and qp (and tr8 where luma8 is
    present) of every MB; a PCM MB's 384 samples and nothing else; of
    every other MB luma8 where tr8 is set, else luma4 (and luma_dc for
    I16), chroma_dc and chroma_ac, each where present; with bypass, the
    DPCM modes of the QP' = 0 intra MBs; the three int32 planes written
    once.  ~10 int32 ops an output sample (dequant, transform, select)."""
    from arrow_h264_tpu_torch.ops.abi import (
        KIND_I4x4, KIND_I8x8, KIND_I16, KIND_IPCM,
    )
    kind = a["kind"]
    count = lambda m: int(m.sum())
    pcm = (kind == KIND_IPCM) & ("pcm" in a)
    use8 = (a["tr8"] > 0) & ~pcm & ("luma8" in a)
    use4 = ~pcm & ~use8
    words = (2 + ("luma8" in a)) * kind.numel() + 384 * count(pcm) \
        + 256 * count(use8) + 256 * ("luma4" in a) * count(use4) \
        + 16 * ("luma_dc" in a) * count(use4 & (kind == KIND_I16)) \
        + (128 * ("chroma_ac" in a) + 8 * ("chroma_dc" in a)) * count(~pcm)
    if bypass:
        dpcm = ~pcm & (a["qp"] == 0)
        words += sum(w * count(dpcm & (kind == k)) for k, w in
                     ((KIND_I4x4, 16), (KIND_I8x8, 4), (KIND_I16, 1)))
        if "chroma_ac" in a or "chroma_dc" in a:
            words += count(dpcm & (kind <= KIND_I16))
    return 4 * words + nbytes(*out), 10 * sum(o.numel() for o in out)


def combine_need(a: dict, pred_y, pred_c, res, out) -> tuple[float, float]:
    """Bytes and operations of the inter combine (K10), counted per 4x4
    cell: kind of every MB read once; of each inter MB's cells the
    refslots, the residual samples and the predictions of the lists the
    cell combines (one for a unidirectional cell, two for a bi-predicted
    one), and the weights: each inter cell's refidx and each inter MB's
    slice_id with the distinct per-slice table rows its cells look up,
    or the dense wp of each inter cell and logwd of each inter MB; the
    three int32 planes written once; ~12 int32 ops a sample and list."""
    kind = a["kind"]
    inter = (kind >= 4)[..., None, None].expand(a["refslot"].shape[:-1])
    used = (a["refslot"] >= 0)[inter]                   # [cells, 2]
    cells, mbs = used.shape[0], int((kind >= 4).sum())
    lists = cells + int(used.all(1).sum())              # (cell, list) pairs
    per_cell = pred_y[0, 0].numel() // inter[0].numel()  # luma samples
    per_list = per_cell * pred_y.element_size() \
        + 2 * per_cell // 4 * pred_c.element_size()
    res_cell = sum(r[0].numel() * r.element_size() for r in res) \
        // inter[0].numel()
    byts = nbytes(kind, *out) + cells * (8 + res_cell) + lists * per_list
    if "wp" in a or "wtab" not in a:
        byts += cells * 48 + mbs * 8                    # wp, logwd
    else:
        byts += cells * 8 + mbs * 4                     # refidx, slice_id
        r = (a["refidx"].clamp(-1, 31) + 1)[inter]
        sid = a["slice_id"][..., None, None].expand(inter.shape)[inter]
        lane = torch.arange(kind.shape[0], device=kind.device)[
            :, None, None, None].expand(inter.shape)[inter]
        rows = torch.unique(((lane * 16 + sid) * 33 + r[:, 0]) * 33 + r[:, 1])
        byts += 48 * rows.numel() + 8 * torch.unique(lane * 16 + sid).numel()
    return byts, 12 * (per_list // pred_y.element_size()) * lists


def store_need(pics, dpbs, lanes) -> tuple[float, float]:
    """Bytes and operations of the reference store (K11): the storing
    lanes' pictures read once, their slots' four padded luma planes and
    two padded chroma planes written once; ~40 int32 ops a padded luma
    sample (three 6-taps and the rounding)."""
    k = len(lanes)
    per_lane = lambda t: t[0].numel() * t.element_size()
    slot = dpbs[0][0, 0].numel() + dpbs[1][0, 0].numel()
    return k * (sum(per_lane(p) for p in pics) + slot), \
        40 * k * dpbs[0][0, 0, 0].numel()


def checked_stage_kernels():
    """A context manager under which every K9, K10 and K11 call of the
    decode pipeline (models/pipeline.py's residual_planes, inter_combine
    and store_refs) is also made by its plain version on the same
    inputs and must give the same tensors (K11's DPBs compared whole,
    the plain version's on clones).  Yields {key: calls compared}."""
    import contextlib

    from arrow_h264_tpu_torch.models import pipeline
    from arrow_h264_tpu_torch.ops.inter import (
        inter_init_plain, store_refs_plain,
    )
    from arrow_h264_tpu_torch.ops.transforms import (
        residual_planes as residual_plain,
    )

    @contextlib.contextmanager
    def patched():
        seen = {"residual": 0, "inter_combine": 0, "store_refs": 0}
        orig = {k: getattr(pipeline, k) for k in
                ("residual_planes", "inter_combine", "store_refs")}

        def residual(*args, **kw):
            got = orig["residual_planes"](*args, **kw)
            compare("residual (real round)", got,
                    residual_plain(*args, **kw))
            seen["residual"] += 1
            return got

        def combine(*args):
            got = orig["inter_combine"](*args)
            compare("inter_combine (real round)", got,
                    inter_init_plain(*args))
            seen["inter_combine"] += 1
            return got

        def store(dpb_y, dpb_c, *rest):
            want = (dpb_y.clone(), dpb_c.clone())
            store_refs_plain(*want, *rest)
            orig["store_refs"](dpb_y, dpb_c, *rest)
            compare("store_refs (real round)", (dpb_y, dpb_c), want)
            seen["store_refs"] += 1

        pipeline.residual_planes = residual
        pipeline.inter_combine = combine
        pipeline.store_refs = store
        try:
            yield seen
        finally:
            for k, fn in orig.items():
                setattr(pipeline, k, fn)

    return patched()


def stage_kernels(record, results: dict, smi: str) -> None:
    """Phase 3's K9 (residual), K10 (inter_combine) and K11 (store_refs),
    against their plain versions (module docstring)."""
    t0 = time.perf_counter()
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.models.pipeline import (
        dpb_alloc, upload_wire,
    )
    from arrow_h264_tpu_torch.ops.inter import (
        inter_init_plain, store_refs_plain,
    )
    from arrow_h264_tpu_torch.ops.kernels.inter_combine import (
        inter_combine,
    )
    from arrow_h264_tpu_torch.ops.kernels.mc import mc_chroma, mc_luma
    from arrow_h264_tpu_torch.ops.kernels.residual import residual_planes
    from arrow_h264_tpu_torch.ops.kernels.store_ref import store_refs
    from arrow_h264_tpu_torch.ops.synthetic import (
        random_residual_abi, random_weighted_abi,
    )
    from arrow_h264_tpu_torch.ops.transforms import (
        make_ws_consts, residual_planes as residual_plain,
    )
    from arrow_h264_tpu_torch.ops.wire import merge_specs, pack_wire_raw
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    dev = torch.device("cuda")
    ws = tuple(t.to(dev) for t in make_ws_consts([[16] * 16] * 6,
                                                 [[16] * 64] * 2))
    k9 = ("residual", "residual (K9)", "arrow_h264_tpu_torch/csrc/residual.cu",
          "arrow_h264_tpu/ops/transforms.py:182 (XLA; no pallas_call)")
    k10 = ("inter_combine", "inter_combine (K10)",
           "arrow_h264_tpu_torch/csrc/inter_combine.cu",
           "arrow_h264_tpu/ops/pallas/mc_kernel.py:565 _mc_combine, with "
           "models/pipeline.py:81 resolve_weights and :184-189 (XLA; no "
           "pallas_call)")
    k11 = ("store_refs", "store_refs (K11)",
           "arrow_h264_tpu_torch/csrc/store_ref.cu",
           "arrow_h264_tpu/models/pipeline.py:298 store_ref_fn, with "
           "ops/inter.py:36 halfpel_planes and :59 pad_chroma (XLA; no "
           "pallas_call)")
    sizes = {"": (MB_W, MB_H), "_2160p": (MB_W_4K, MB_H_4K)}

    def figure(spec, tag, what, call, plain_call, got, want, need):
        """Compare, time the kernel and its plain version; the JSON's
        figures for the untagged case, `tag`'s keys for the others."""
        torch.cuda.synchronize()
        err = compare(f"{spec[0]} {what}", got, want)
        ms = kernel_ms(call)
        big = "2160p" in (tag or "") or "3840x" in what
        plain = cuda_ms(plain_call, 5 if big else KERNEL_REPS)
        if tag is None:
            log("kernels", f"{spec[1]} {what}: equal, kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, bound {bound(*need)[0]:.4f} ms")
        elif not tag:
            record(*spec, err, ms, plain, need, what, call)
        else:
            results[spec[0]].update(
                {f"ms{tag}": ms, f"bound_ms{tag}": bound(*need)[0],
                 f"plain_ms{tag}": plain})
            log("kernels", f"{spec[1]} {what}: equal, kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, bound {bound(*need)[0]:.4f} ms")

    # K9 on real rounds: the smoke stream's picture 1 (B = 1), pictures
    # 1-4 as four lanes of one wire round, conf_c5's picture 1 and four
    # lanes of it (the JSON's figures); then random_residual_abi (every
    # class, MB kind and qp; lossy and bypass) at both sizes
    smoke, _ = stream_abis(STREAM.read_bytes(), dev)
    uhd, _ = stream_abis((STREAM.parent / "conf_c5.264").read_bytes(), dev)
    rounds = (("smoke picture 1", [smoke[1]], "", ""),
              (f"smoke pictures 1-{B4} as {B4} lanes", smoke[1:1 + B4], "",
               "_b4"),
              ("conf_c5 picture 1", [uhd[1]], "_2160p", "_2160p"),
              (f"uhd round 1 ({B4} conf_c5 lanes)", [uhd[1]] * B4, "_2160p",
               "_b4_2160p"))
    for what, abis, size, tag in rounds:
        mb_w, mb_h = sizes[size]
        packs = [pack_wire_raw(x, mb_w, mb_h) for x in abis]
        a = upload_wire(packs, merge_specs([sp for _, sp in packs]), mb_w,
                        mb_h, dev)
        args = (a, mb_w, mb_h, *ws)
        got = residual_planes(*args)
        figure(k9, tag, what, partial(residual_planes, *args),
               partial(residual_plain, *args), got, residual_plain(*args),
               residual_need(a, False, got))
    del smoke, uhd
    for size, (mb_w, mb_h) in sizes.items():
        for bypass in (False, True):
            a = {k: torch.from_numpy(v).to(dev) for k, v in
                 random_residual_abi(mb_w, mb_h, 1, SEED + 60).items()}
            args = (a, mb_w, mb_h, *ws, (2, -3), bypass)
            got = residual_planes(*args)
            figure(k9, None, f"random_residual_abi {16 * mb_w}x"
                   f"{16 * mb_h} bypass={bypass}",
                   partial(residual_planes, *args),
                   partial(residual_plain, *args), got,
                   residual_plain(*args), residual_need(a, bypass, got))
            del a, got

    # K10 on the smoke stream's first B picture (K3's and K4's predictions
    # over the DPB its decode reads, its own residual): its wire upload
    # with the per-slice weight tables, as the main path gives it (the
    # JSON's `ms`), and its dense upload; then random_weighted_abi with
    # tables, one shared table and dense weights over random predictions
    # and residuals
    def combine_case(what, tag, a, pred_y, pred_c, res, mb_w, mb_h):
        args = (a, pred_y, pred_c, *res, mb_w, mb_h)
        got = inter_combine(*args)
        figure(k10, tag, what, partial(inter_combine, *args),
               partial(inter_init_plain, *args), got, inter_init_plain(*args),
               combine_need(a, pred_y, pred_c, res, got))

    dpb_y, dpb_c, *_, (a, dense) = stream_mc_inputs(STREAM.read_bytes(),
                                                    dev)["B"]
    if "wtab" not in a:
        sys.exit("inter_combine: the smoke stream's B picture did not "
                 "upload per-slice weight tables")
    zero = torch.zeros(dpb_c.shape[:2], dtype=torch.int32, device=dev)
    pred = (mc_luma(dpb_y, a["mv"], a["refslot"], MB_W, MB_H),
            mc_chroma(dpb_c, a["mv"], a["refslot"], zero, MB_W, MB_H))
    for what, tag, up in (("smoke stream B picture, wire upload", "", a),
                          ("smoke stream B picture, dense upload", None,
                           dense)):
        combine_case(what, tag, up, *pred,
                     residual_planes(up, MB_W, MB_H, *ws), MB_W, MB_H)
    del dpb_y, dpb_c, a, dense, pred
    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    for size, (mb_w, mb_h) in sizes.items():
        H, W = 16 * mb_h, 16 * mb_w
        for B, weights in ((1, "tables"), (1, "dense"), (B4, "tables"),
                           (B4, "shared")):
            a = {k: torch.from_numpy(v).to(dev) for k, v in
                 random_weighted_abi(mb_w, mb_h, B, SEED + 62,
                                     weights == "dense").items()}
            if weights == "shared":
                a["wtab"] = a["wtab"][:1].expand_as(a["wtab"])
            pred = [torch.randint(0, 256, s, generator=g, device=dev,
                                  dtype=torch.uint8)
                    for s in ((B, 2, H, W), (B, 2, 2, H // 2, W // 2))]
            res = [torch.randint(-300, 300, s, generator=g, device=dev,
                                 dtype=torch.int32)
                   for s in ((B, H, W), (B, H // 2, W // 2),
                             (B, H // 2, W // 2))]
            tag = None if weights != "tables" else \
                ("_b4" if B > 1 else "") + size
            if tag == "":
                tag = None                        # `ms` is the B picture's
            combine_case(f"random_weighted_abi {W}x{H} B={B} {weights}",
                         tag, a, *pred, res, mb_w, mb_h)
            del a, pred, res

    # K11: random pictures into slot 1 of B-lane DPBs of 3 slots full of
    # random bytes, B = 1 and B4, at both sizes
    for size, (mb_w, mb_h) in sizes.items():
        H, W = 16 * mb_h, 16 * mb_w
        for B in (1, B4):
            dpbs = [t.view((B, 3) + t.shape[1:]) for t in
                    dpb_alloc(mb_w, mb_h, 3 * B, dev)]
            for t in dpbs:
                t.random_(0, 256, generator=g)
            pics = [torch.randint(0, 256, s, generator=g, device=dev,
                                  dtype=torch.uint8)
                    for s in ((B, H, W), (B, H // 2, W // 2),
                              (B, H // 2, W // 2))]
            lanes, slots = list(range(B)), [1] * B
            want = [t.clone() for t in dpbs]
            store_refs_plain(*want, lanes, slots, *pics)
            store_refs(*dpbs, lanes, slots, *pics)
            figure(k11, ("_b4" if B > 1 else "") + size,
                   f"{W}x{H} B={B} into slot 1 of 3",
                   partial(store_refs, *dpbs, lanes, slots, *pics),
                   partial(store_refs_plain, *[t.clone() for t in dpbs],
                           lanes, slots, *pics),
                   tuple(dpbs), tuple(want), store_need(pics, dpbs, lanes))
            del dpbs, pics, want

    # real rounds of the decode paths: every K9/K10/K11 call compared with
    # its plain version on the streams whose branches the random ABIs do
    # not reach: the smoke stream, four 1080p lanes in lockstep, the
    # lossless stream (bypass, DPCM, PCM) and the weighted-prediction
    # lanes (dense wp beside tables).  The 4K and field decodes are held
    # to their goldens by the decode phases.
    data = STREAM.parent
    t_real = time.perf_counter()
    with checked_stage_kernels() as seen:
        for name in ("smoke_1080p_high", "feat_lossless_qcif"):
            list(Decoder(device="cuda").decode_annexb(
                (data / f"{name}.264").read_bytes()))
        for names in ([p.stem for p in BATCH_STREAMS],
                      ["feat_wp18", "feat_wp_table"]):
            with BatchDecoder(len(names), device="cuda") as bd:
                bd.decode([(data / f"{n}.264").read_bytes() for n in names])
            if any(e is not None for e in bd.errors):
                sys.exit(f"stage kernels, real rounds {names}: {bd.errors}")
    if not all(seen.values()):
        sys.exit(f"stage kernels: real rounds compared {seen}")
    log("kernels", f"{k9[1]}, {k10[1]}, {k11[1]}: torch.equal to the plain "
        f"versions at 1080p and 3840x2160, B = 1 and {B4}, on random ABIs "
        f"and on every call of real decodes ({seen}, "
        f"{time.perf_counter() - t_real:.1f} s); on {smi}")
    log("kernels", f"stage kernels (K9-K11) in {time.perf_counter() - t0:.1f}"
        " s")


def batch_phase(paths: dict, smi: str) -> dict:
    """The batch phase (module docstring); returns {order: LAUNCHES of the
    main path's run, BatchDecoder(BATCH_LANES) with that order}."""
    from arrow_h264_tpu_torch.api import Decoder, PendingFrame
    from arrow_h264_tpu_torch.ops import kernels
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    from tools.gpu_conformance import bm8_tally, want_launches
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
        with bm8_tally() as tally, BatchDecoder(
                n, device="cuda", order=order, materialize=materialize) as bd:
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
        want = want_launches(got, order, bd.rounds, bd.inter_rounds,
                             tally["bm8"], stores=tally["stores"],
                             unpacks=tally["unpacks"])
        if got != want or not 0 < bd.inter_rounds <= bd.rounds or \
                not 0 < tally["bm8"] or tally["unpacks"] != bd.wire_rounds \
                or not 0 < tally["stores"] <= bd.rounds:
            sys.exit(f"{what}: launches {got}, expected {want} (one a round; "
                     f"{bd.rounds} rounds, {bd.inter_rounds} with an inter "
                     f"lane; unpack_bm8 once a wire round of the "
                     f"{tally['unpacks']} that ships a bm8 class)")
        if bd.rounds != max(len(golden[i % len(data)]) for i in range(n)
                            if i != corrupt):
            sys.exit(f"{what}: {bd.rounds} rounds")
        if (bd.wire_rounds, bd.dense_rounds) != (bd.rounds, 0):
            sys.exit(f"{what}: {bd.wire_rounds} wire and {bd.dense_rounds} "
                     f"dense rounds of {bd.rounds}; every round ships the "
                     "wire")
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
    pool = {}              # (B, order) -> (bd, wall, released, calls)
    for order in paths:
        (bd, _, wall, launches[order]), *meter = metered(
            partial(run, BATCH_LANES, order))
        pool[BATCH_LANES, order] = bd, wall, *meter
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
    (bd, _, wall, _), *meter = metered(partial(run, BATCH_WIDE))
    pool[BATCH_WIDE, "phase"] = bd, wall, *meter
    report(f"B={BATCH_WIDE} order=phase", bd, wall)

    # the single-stream Decoder over the same four streams, one after
    # another, in the same process
    def single():
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
        return frames, wall, stats

    (frames, wall, stats), released, calls = metered(single)
    sums = {k: round(sum(s[k] for s in stats), 4)
            for k in ("host_parse_s", "device_dispatch_s", "emit_sync_s")}
    log("batch", f"single-stream Decoder over the {len(data)} streams: "
        f"{frames} frames in {wall:.4f} s, {frames / wall:.3f} frames/s; "
        f"summed {sums}; on {smi}")
    held_ms = gil_line(
        f"single-stream Decoder order=phase upload=wire over the "
        f"{len(data)} streams", frames, wall,
        sum(s["host_parse_s"] for s in stats), released, calls, smi)
    # the pool's lanes run the same mix of pictures (lanes cycle the four
    # streams), so the single stream's GIL-held time a frame times a
    # round's frames is the time a round holds the GIL at least
    for (B, order), (bd, wall, released, calls) in pool.items():
        frames = sum(s["frames"] for s in bd.stats)
        floor = held_ms * frames / bd.rounds
        round_ms = 1e3 * wall / bd.rounds
        log("gil", f"BatchDecoder({B}) order={order} upload=wire: {frames} "
            f"frames, {bd.rounds} rounds in {wall:.4f} s ({round_ms:.3f} ms "
            f"a round); lanes' summed host_parse_s "
            f"{sum(s['host_parse_s'] for s in bd.stats):.4f} s; released_s "
            f"{released:.4f} s, {1e3 * released / bd.rounds:.3f} ms a round,"
            f" ms a round by call {per_unit(calls, bd.rounds)}; GIL floor "
            f"{floor:.3f} ms a round (single stream's {held_ms:.3f} ms a "
            f"frame x {frames / bd.rounds:.3f} frames a round), "
            f"{100 * floor / round_ms:.2f} % of the round's wall; on {smi}")
    return launches


def fields_phase(paths: dict, smi: str) -> dict:
    """The fields phase (module docstring), parts (b)-(d); returns {order:
    LAUNCHES of its main path's run, BatchDecoder(FIELD_LANES) over the
    1080i streams with that order}."""
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.ops import kernels
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    from tools.gpu_conformance import bm8_tally, want_launches
    data = [p.read_bytes() for p in FIELD_STREAMS]
    meta = [json.loads(p.with_suffix(".json").read_text())
            for p in FIELD_STREAMS]

    def want(order, fields, inter_fields, tally):
        """want_launches of `fields` fields (rounds) through the wire."""
        w = want_launches(kernels.LAUNCHES, order, fields, inter_fields,
                          tally["bm8"], stores=tally["stores"],
                          unpacks=tally["unpacks"])
        return w if tally["unpacks"] == fields else {**w, "unpacks": fields}

    def decode(order, d):
        dec = Decoder(device="cuda", order=order)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with bm8_tally() as tally:
            md5 = [hashlib.md5(f.planar()).hexdigest()
                   for f in dec.decode_annexb(d)]
        torch.cuda.synchronize()
        return dec, md5, time.perf_counter() - t, tally

    # (b) each stream alone, with each order
    for order in paths:
        frames, wall = 0, 0.0
        for p, d, m in zip(FIELD_STREAMS, data, meta):
            decode(order, d)                     # warm-up: first-call costs
            kernels.reset_launches()
            dec, md5, wall_s, tally = decode(order, d)
            got = dict(kernels.LAUNCHES)
            if md5 != m["md5"]:
                bad = [i for i, (a, b) in enumerate(zip(md5, m["md5"]))
                       if a != b]
                sys.exit(f"fields {p.name} {order}: {len(md5)} frames, "
                         f"golden {len(m['md5'])}; MD5 mismatch at {bad}")
            fields = 2 * len(m["structure"])
            inter = 2 * sum(k != "I" for k in m["structure"])
            if got != want(order, fields, inter, tally) or \
                    dec.stats.frames != fields:
                sys.exit(f"fields {p.name} {order}: launches {got}, "
                         f"expected {want(order, fields, inter, tally)} (a "
                         f"field picture each; K3/K4 for {inter} P/B "
                         "fields; unpack_bm8 once a wire upload that "
                         "ships a bm8 class)")
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
            with bm8_tally() as tally, BatchDecoder(
                    FIELD_LANES, device="cuda", order=order) as bd:
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
        if (bd.rounds, bd.inter_rounds, bd.wire_rounds, bd.dense_rounds) \
                != (rounds, inter, rounds, 0) or \
                got != want(order, bd.rounds, bd.inter_rounds, tally):
            sys.exit(f"fields batch {order}: launches {got} in {bd.rounds} "
                     f"rounds ({bd.inter_rounds} inter, {bd.wire_rounds} "
                     f"wire, {bd.dense_rounds} dense), expected "
                     f"{want(order, rounds, inter, tally)} in {rounds} wire "
                     "rounds")
        n = sum(len(f) for f in outs)
        log("fields", f"BatchDecoder({FIELD_LANES}) order={order}: every lane "
            f"MD5 == golden; launches {got} in {bd.rounds} rounds "
            f"({bd.inter_rounds} inter); {n} frames in {wall:.4f} s, "
            f"{n / wall:.3f} frames/s of the batch; on {smi}")
    return launches


def features_phase(paths: dict, smi: str) -> dict:
    """The features phase (module docstring), parts (a)-(d); returns
    {order: LAUNCHES of its main path's run, every feature stream through
    Decoder with that order}."""
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.ops import kernels
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    from tools.gpu_conformance import bm8_tally, want_launches
    data = STREAM.parent
    meta = {n: json.loads((data / f"{n}.json").read_text())
            for n in FEATURE_STREAMS}

    def want(order, pictures, mc_pictures, tally):
        return want_launches(kernels.LAUNCHES, order, pictures, mc_pictures,
                             tally["bm8"], stores=tally["stores"],
                             unpacks=tally["unpacks"])

    # (a), (d) each stream alone, with each order
    launches = {}
    for order in paths:
        total = dict.fromkeys(kernels.LAUNCHES, 0)
        for name, m in meta.items():
            stream = (data / f"{name}.264").read_bytes()
            dec = Decoder(device="cuda", order=order,
                          conceal="concealed" in m)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t = time.perf_counter()
            with bm8_tally() as tally:
                md5 = [hashlib.md5(f.planar()).hexdigest()
                       for f in dec.decode_annexb(stream)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = dict(kernels.LAUNCHES)
            for k, v in got.items():
                total[k] += v
            if md5 != m["md5"]:
                bad = [i for i, (a, b) in enumerate(zip(md5, m["md5"]))
                       if a != b]
                sys.exit(f"features {name} {order}: {len(md5)} frames, "
                         f"expected {len(m['md5'])} ({m['expected']}); MD5 "
                         f"mismatch at {bad}")
            pictures = len(m["structure"])
            w = want(order, pictures, m["mc_pictures"], tally)
            if got != w or dec.stats.frames != pictures:
                sys.exit(f"features {name} {order}: launches {got}, "
                         f"expected {w} (a picture each; K3/K4 for the "
                         f"{m['mc_pictures']} with inter MBs; unpack_bm8 "
                         f"once a wire upload of the {tally['unpacks']} "
                         "that ships a bm8 class)")
            if "concealed" in m and \
                    [list(c) for c in dec.concealed] != m["concealed"]:
                sys.exit(f"features {name} {order}: concealed "
                         f"{dec.concealed}, expected {m['concealed']}")
            log("features", f"{name} order={order}: {len(md5)} frames "
                f"{m['width']}x{m['height']} ({m['structure']}) MD5 == "
                f"{m['expected']}; launches {got}; {wall:.4f} s, "
                f"{len(md5) / wall:.3f} frames/s; on {smi}")
        launches[order] = total

    # (b) lockstep lanes, one launch a round
    for what, (names, rounds, inter, dense) in FEATURE_BATCHES.items():
        datas = [(data / f"{n}.264").read_bytes() for n in names]
        golden = [json.loads((data / f"{n}.json").read_text())["md5"]
                  for n in names]
        for order in paths:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t = time.perf_counter()
            with bm8_tally() as tally, BatchDecoder(
                    len(names), device="cuda", order=order) as bd:
                outs = bd.decode(datas)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = dict(kernels.LAUNCHES)
            for i, (frames, md5) in enumerate(zip(outs, golden)):
                if bd.errors[i] is not None:
                    sys.exit(f"features batch {what} {order}: lane {i} "
                             f"failed: {bd.errors[i]!r}")
                if [hashlib.md5(f.planar()).hexdigest()
                        for f in frames] != md5:
                    sys.exit(f"features batch {what} {order}: lane {i} "
                             f"({names[i]}) MD5s differ")
            w = want(order, rounds, inter, tally)
            if (bd.rounds, bd.inter_rounds, bd.dense_rounds,
                    bd.wire_rounds, tally["unpacks"]) != (
                    rounds, inter, dense, rounds - dense, rounds - dense) \
                    or got != w:
                sys.exit(f"features batch {what} {order}: launches {got} in "
                         f"{bd.rounds} rounds ({bd.inter_rounds} inter, "
                         f"{bd.dense_rounds} dense, {bd.wire_rounds} wire, "
                         f"{tally['unpacks']} unpacked), expected {w} in "
                         f"{rounds} rounds, {dense} of them dense")
            n = sum(len(f) for f in outs)
            log("features", f"BatchDecoder({len(names)}) {what} {names} "
                f"order={order}: every lane MD5 == expected; launches {got} "
                f"in {bd.rounds} rounds ({bd.inter_rounds} inter, "
                f"{bd.dense_rounds} dense); {n} "
                f"frames in {wall:.4f} s, {n / wall:.3f} frames/s of the "
                f"batch; on {smi}")

    # (c) the CLI, as a subprocess
    golden = json.loads(STREAM.with_suffix(".json").read_text())
    size = golden["width"] * golden["height"] * 3 // 2

    def cli(*args):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "arrow_h264_tpu_torch",
                            *args], cwd=REPO, capture_output=True, text=True,
                           timeout=600)
        return r, time.perf_counter() - t

    with tempfile.TemporaryDirectory() as tmp:
        out, ref = Path(tmp) / "out.yuv", Path(tmp) / "ref.yuv"
        for order in paths:
            r, wall = cli("decode", str(STREAM), str(out), "--order", order)
            yuv = out.read_bytes()
            md5 = [hashlib.md5(yuv[i:i + size]).hexdigest()
                   for i in range(0, len(yuv), size)]
            if r.returncode != 0 or md5 != golden["md5"]:
                sys.exit(f"features CLI decode --order {order}: exit "
                         f"{r.returncode}, {len(md5)} frames, MD5s == golden: "
                         f"{md5 == golden['md5']}\n{r.stdout}{r.stderr}")
            log("features", f"CLI decode {STREAM.name} --order {order}: exit "
                f"0, {len(md5)} frames MD5 == golden; {wall:.3f} s with the "
                f"process start; said {r.stdout.strip()!r}; on {smi}")
        r, _ = cli("info", str(STREAM))
        if r.returncode != 0:
            sys.exit(f"features CLI info: exit {r.returncode}\n{r.stderr}")
        flipped = bytearray(out.read_bytes())
        flipped[len(flipped) // 3] ^= 0x10
        ref.write_bytes(flipped)
        r, _ = cli("decode", str(STREAM), str(out), "--ref", str(ref))
        if r.returncode != 1:
            sys.exit(f"features CLI decode --ref (one byte flipped): exit "
                     f"{r.returncode}, expected 1\n{r.stderr}")
        log("features", f"CLI info: exit 0; decode --ref with one byte "
            f"flipped: exit 1 ({r.stderr.strip()!r})")
    return launches


def stream_abis(data: bytes, dev) -> tuple[list, int]:
    """(host ABI of every picture of a decode of `data` on `dev`, the
    stream's DPB slots).  The loop is Decoder.decode_annexb's; the ABIs
    stay referenced, so the parse buffers they view are not recycled."""
    from arrow_h264_tpu_torch.api import Decoder
    dec = Decoder(device=dev)
    abis = []
    for pic, poc in dec.parse_pictures(data):
        abi = dec.pack_abi(pic, poc)
        pipe = dec._pipeline(pic.sps, pic.pps)
        abis.append(abi)
        planes = pipe.decode_frame(abi)
        for _ in dec.commit(pic, poc, *planes, pipe.n_slots, pipe.store_ref):
            pass
    return abis, pipe.n_slots


def check_abi(what: str, got: dict, want: dict) -> None:
    """The wire's device ABI against the dense upload's: the same keys,
    every tensor torch.equal but refid, which must map one to one onto
    the dense refid in each lane (ops.wire.unpack_wire ships the slot)."""
    if set(got) != set(want):
        sys.exit(f"{what}: keys {sorted(got)} != {sorted(want)}")
    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape or g.device != w.device:
            sys.exit(f"{what} {k}: {g.dtype} {tuple(g.shape)} {g.device} "
                     f"!= {w.dtype} {tuple(w.shape)} {w.device}")
        if k != "refid":
            if not torch.equal(g, w):
                sys.exit(f"{what} {k}: the wire's tensor differs")
            continue
        for i in range(w.shape[0]):
            pairs = torch.unique(torch.stack([w[i].flatten(),
                                              g[i].flatten()]), dim=1)
            if not (len(torch.unique(pairs[0])) == pairs.shape[1]
                    == len(torch.unique(pairs[1]))) or \
                    not torch.equal(g[i] < 0, w[i] < 0):
                sys.exit(f"{what} refid, lane {i}: not one to one with the "
                         "dense refid")


def wire_phase(paths: dict, smi: str) -> tuple[dict, dict]:
    """The wire phase (module docstring); returns ({"unpack_wire B=...":
    one call of unpack_wire on the card at that B}, {the same name: (K8's
    device launches in the call, K12's)}) for the profiler session."""
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.models.pipeline import (
        ABI_DEVICE_KEYS, upload_batch, upload_nbytes, upload_wire,
        wire_staging,
    )
    from arrow_h264_tpu_torch.ops import kernels
    from arrow_h264_tpu_torch.ops.kernels.unpack_wire import (
        bm8_launches, device_launches as k12_launches,
    )
    from arrow_h264_tpu_torch.ops.transforms import COEFF_KEYS
    from arrow_h264_tpu_torch.ops.wire import (
        emit_wire, merge_specs, pack_wire_raw, unpack_wire, wire_total,
    )
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    from tools.gpu_conformance import bm8_tally, want_launches
    dev = torch.device("cuda")
    n = MB_W * MB_H
    data = [p.read_bytes() for p in BATCH_STREAMS]
    golden = [json.loads(p.with_suffix(".json").read_text())["md5"]
              for p in BATCH_STREAMS]
    streams = [stream_abis(d, dev) for d in data]

    # (a) every picture of the smoke stream, alone and as one batch
    smoke, n_slots = streams[0]
    packs = [pack_wire_raw(a, MB_W, MB_H) for a in smoke]
    for i, (a, (raw, spec)) in enumerate(zip(smoke, packs)):
        check_abi(f"wire smoke picture {i}",
                  upload_wire([(raw, spec)], spec, MB_W, MB_H, dev, n_slots),
                  upload_batch([a], dev, n_slots))
    target = merge_specs([sp for _, sp in packs])
    check_abi(f"wire smoke B={len(smoke)}",
              upload_wire(packs, target, MB_W, MB_H, dev, n_slots),
              upload_batch(smoke, dev, n_slots))
    log("wire", f"every picture of {STREAM.name}: upload_wire on the card "
        f"== upload_batch for every key (refid one to one), alone and as "
        f"one batch of {len(smoke)}")

    # (b) bytes, the host pack, and the device side of each upload
    wire_b, dense_b, pack_s = [], [], []
    for abis, slots in streams:
        for a in abis:
            t = time.perf_counter()
            raw, spec = pack_wire_raw(a, MB_W, MB_H)
            pack_s.append(time.perf_counter() - t)
            wire_b.append(wire_total(spec, n))
            dense_b.append(upload_nbytes(upload_batch([a], dev, slots)))
    mean_w, mean_d = statistics.mean(wire_b), statistics.mean(dense_b)
    log("wire", f"bytes a 1080p picture over the {len(wire_b)} pictures of "
        f"the four streams: wire mean {mean_w:.0f} (min {min(wire_b)}, max "
        f"{max(wire_b)}), dense mean {mean_d:.0f} (min {min(dense_b)}, max "
        f"{max(dense_b)}), {mean_d / mean_w:.2f}x; pack_wire_raw {1e3 * statistics.mean(pack_s):.3f} ms a picture "
        f"(min {1e3 * min(pack_s):.3f}, max {1e3 * max(pack_s):.3f}), one "
        f"host thread; on {smi}")
    regions, region_launches = {}, {}
    for B in WIRE_BATCHES:
        # round 1 of B lanes cycling the four streams (P pictures)
        abis = [streams[i % len(streams)][0][1] for i in range(B)]
        packs = [pack_wire_raw(a, MB_W, MB_H) for a in abis]
        target = merge_specs([sp for _, sp in packs])
        buf = wire_staging(B, wire_total(target, n), dev)
        for row, (raw, spec) in zip(buf.numpy(), packs):
            emit_wire(raw, spec, target, n, out=row)
        dbuf = buf.to(dev)
        check_abi(f"wire B={B}", unpack_wire(dbuf, MB_W, MB_H, target),
                  upload_batch(abis, dev, n_slots))
        # unqueued: these copies could not be queued behind a device sleep
        # (cuda_ms exited), so each figure is the longer of a call's host
        # enqueue and its device time; unpack_wire's kernels' own device
        # time comes from the profiler session at the end
        copy_ms = cuda_ms(lambda: buf.to(dev, non_blocking=True),
                          KERNEL_REPS, ROUNDS)
        call = partial(unpack_wire, dbuf, MB_W, MB_H, target)
        unpack_ms = cuda_ms(call, KERNEL_REPS, ROUNDS)
        regions[f"unpack_wire B={B}"] = call
        region_launches[f"unpack_wire B={B}"] = (
            bm8_launches(target, n), k12_launches(target, n))
        staged = [torch.from_numpy(np.stack(
            [np.asarray(a[k]) for a in abis]).astype(np.int32)).pin_memory()
            for k in ABI_DEVICE_KEYS
            if k not in COEFF_KEYS or any(np.asarray(a[k]).any()
                                          for a in abis)]
        dense_ms = cuda_ms(lambda: [t.to(dev, non_blocking=True)
                                    for t in staged], KERNEL_REPS, ROUNDS)
        log("wire", f"B={B} (round 1 of lanes cycling the four streams): "
            f"wire {buf.numel()} bytes, copy {copy_ms:.4f} ms + unpack_wire "
            f"{unpack_ms:.4f} ms = {copy_ms + unpack_ms:.4f} ms; dense "
            f"{nbytes(*staged)} bytes in {len(staged)} copies, "
            f"{dense_ms:.4f} ms (CUDA events, unqueued: a call's host "
            f"enqueue or device time, the longer); on {smi}")
        del staged

    # (c) frames/s, wire against dense, in turns
    def single(order, upload):
        frames, wall, up = 0, 0.0, 0
        for d, md5 in zip(data, golden):
            dec = Decoder(device="cuda", order=order, upload=upload)
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = [hashlib.md5(f.planar()).hexdigest()
                   for f in dec.decode_annexb(d)]
            torch.cuda.synchronize()
            wall += time.perf_counter() - t
            if got != md5:
                sys.exit(f"wire single {order} upload={upload}: MD5s differ "
                         "from the golden")
            frames += len(got)
            up += dec.stats.upload_bytes
        return (f"{frames} frames in {wall:.4f} s, {frames / wall:.3f} "
                f"frames/s, {up / frames:.0f} upload bytes a frame")

    def batch(B, order, upload, mesh=None):
        datas = [data[i % len(data)] for i in range(B)]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.perf_counter()
        with bm8_tally() as tally, BatchDecoder(
                B, device="cuda", mesh=mesh, order=order,
                upload=upload) as bd:
            outs = bd.decode(datas)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        what = f"wire BatchDecoder({B}) order={order} upload={upload}" + (
            "" if mesh is None else f" mesh={len(mesh)} shards")
        for i, frames in enumerate(outs):
            if bd.errors[i] is not None or \
                    [hashlib.md5(f.planar()).hexdigest() for f in frames] \
                    != golden[i % len(data)]:
                sys.exit(f"{what}: lane {i} failed or differs from the "
                         f"golden: {bd.errors[i]!r}")
        k = 1 if mesh is None else len(mesh)
        want = want_launches(kernels.LAUNCHES, order, bd.rounds,
                             bd.inter_rounds, tally["bm8"], shards=k,
                             stores=tally["stores"], unpacks=tally["unpacks"])
        rounds = (bd.wire_rounds, bd.dense_rounds, tally["unpacks"])
        if dict(kernels.LAUNCHES) != want or rounds != (
                (bd.rounds, 0, k * bd.rounds) if upload == "wire"
                else (0, bd.rounds, 0)):
            sys.exit(f"{what}: launches {dict(kernels.LAUNCHES)}, expected "
                     f"{want}; {rounds} wire/dense rounds of {bd.rounds} and"
                     " wire uploads unpacked")
        frames = sum(s["frames"] for s in bd.stats)
        parse_s = sum(s["host_parse_s"] for s in bd.stats)
        return (f"{frames} frames in {wall:.4f} s, {frames / wall:.3f} "
                f"frames/s of the batch; main thread's upload "
                f"{1e3 * bd.upload_s / bd.rounds:.3f} ms a round; lanes' "
                f"host_parse_s (parse and pack) {1e3 * parse_s / frames:.3f}"
                f" ms a frame; "
                f"{sum(s['upload_bytes'] for s in bd.stats) / frames:.0f} "
                f"upload bytes a frame; launches {dict(kernels.LAUNCHES)} in "
                f"{bd.rounds} rounds")

    for order in paths:
        single(order, "wire")                    # warm-up
        for upload in ("wire", "dense", "dense", "wire"):
            log("wire", f"single-stream Decoder order={order} upload="
                f"{upload} over the four streams: {single(order, upload)}; "
                f"on {smi}")
        for B in WIRE_BATCHES:
            batch(B, order, "wire")              # warm-up
            for upload in ("wire", "dense", "dense", "wire"):
                log("wire", f"BatchDecoder({B}) order={order} upload="
                    f"{upload}: {batch(B, order, upload)}; on {smi}")

    # (d) two shards on the one card against one shard, in turns
    mesh = (dev,) * SHARDS
    for order in paths:
        batch(BATCH_LANES, order, "wire", mesh)  # warm-up
        for shards in (None, mesh, mesh, None):
            log("wire", f"BatchDecoder({BATCH_LANES}) order={order} "
                f"{1 if shards is None else SHARDS} shard(s) on one card: "
                f"every lane MD5 == golden; "
                f"{batch(BATCH_LANES, order, 'wire', shards)}; on {smi}")
    return regions, region_launches


def conformance_phase(paths: dict, smi: str) -> dict:
    """The conformance phase (module docstring), parts (a)-(c); returns
    {order: LAUNCHES of its main path's run, BatchDecoder(CONF_BATCH)
    over the 4K lanes with that order}."""
    from arrow_h264_tpu_torch.ops import kernels
    from tools.gpu_conformance import (
        check_counts, config_label, decode, lanes, report, rounds_of,
    )

    def run(label, names, order, batch, upload="wire"):
        """Decode `names` (as a batch or alone) twice, the second time
        with the launches counted; exits unless every frame equals its
        golden MD5, the kernels launched once a picture (a round) and the
        host entropy is the C++ library."""
        decode(names, order, "cuda", batch, upload)   # warm-up
        kernels.reset_launches()
        r = decode(names, order, "cuda", batch, upload)
        got = dict(kernels.LAUNCHES)
        line = report(label, r)
        dec = r["decoder"]
        miss = check_counts(r, names, order, batch, upload, got)
        if r["bad"] or miss or any(
                d.entropy != "cpp" for d in
                (dec.decoders if batch else [dec])):
            sys.exit(f"conformance: {line}; {miss or 'entropy not cpp'}")
        log("conformance", f"{line}; launches {got}; on {smi}")
        return got

    # (a) every config alone, with each order
    for order in paths:
        for cfg in CONF_CONFIGS:
            run(config_label(cfg), lanes(cfg, None), order, False)
    # (b) the 4K lanes in lockstep, with each order
    launches = {order: run(config_label(5), lanes(5, CONF_BATCH), order,
                           True) for order in paths}
    # (c) the 720p lanes of two GOPs each, with each order and dense once
    rounds, inter, mixed = rounds_of(GOP_LANES)
    if not mixed:
        sys.exit(f"conformance: no round of {GOP_LANES} has an IDR lane "
                 "beside a P/B lane")
    for order, upload in (("phase", "wire"), ("raster", "wire"),
                          ("phase", "dense")):
        run(f"720p GOP lanes {'+'.join(GOP_LANES)} ({rounds} rounds, an "
            f"IDR beside a P/B lane in rounds {mixed})", list(GOP_LANES),
            order, True, upload)
    return launches


def kernels_2160p(results: dict, smi: str) -> None:
    """Part (d) of the conformance phase: K1-K6 at 3840x2160 exact against
    their plain versions, at B = 4 as the 4K BatchDecoder launches them
    (K1/K5 and then K2/K6 on four synthetic_abi pictures, K3/K4 on four
    synthetic_abi_p streams over 4 random references each, also with 5 %
    wild MVs) and at B = 1 (lane 0 of those, K1/K5 on random_intra_abi,
    K2/K6 on synthetic_abi_p tables over random planes); adds ms_2160p
    and bound_ms_2160p, timed at B = 1, to each kernel's result (K2/K6:
    synthetic_abi, K3/K4: synthetic_abi_p) and logs the plain versions'
    seconds and the chain estimates (module docstring)."""
    from arrow_h264_tpu_torch.models.pipeline import dpb_alloc, store_ref_fn
    from arrow_h264_tpu_torch.ops.deblock import (
        deblock_filter_planes, deblock_tables,
    )
    from arrow_h264_tpu_torch.ops.inter import (
        mc_chroma_plain, mc_luma_plain,
    )
    from arrow_h264_tpu_torch.ops.intra import intra_reconstruct
    from arrow_h264_tpu_torch.ops.kernels.deblock_phase import deblock_phase
    from arrow_h264_tpu_torch.ops.kernels.deblock_raster import (
        deblock_raster,
    )
    from arrow_h264_tpu_torch.ops.kernels.intra_phase import intra_phase
    from arrow_h264_tpu_torch.ops.kernels.intra_raster import intra_raster
    from arrow_h264_tpu_torch.ops.kernels.mc import mc_chroma, mc_luma
    from arrow_h264_tpu_torch.ops.synthetic import (
        random_intra_abi, synthetic_batch,
    )
    from arrow_h264_tpu_torch.ops.transforms import (
        make_ws_consts, residual_planes,
    )
    dev = torch.device("cuda")
    ws4, ws8 = (t.to(dev) for t in make_ws_consts([[16] * 16] * 6,
                                                  [[16] * 64] * 2))
    intra = {"intra_phase": intra_phase, "intra_raster": intra_raster}
    deblock = {"deblock_phase": deblock_phase,
               "deblock_raster": deblock_raster}
    mc = {"mc_luma": (mc_luma, mc_luma_plain),
          "mc_chroma": (mc_chroma, mc_chroma_plain)}
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    mw, mh = MB_W_4K, MB_H_4K
    H, W = mh * 16, mw * 16
    shapes = ((1, H, W), (1, H // 2, W // 2), (1, H // 2, W // 2))

    def rand_planes(lo, hi, dtype):
        return tuple(torch.randint(lo, hi, s, generator=g, device=dev,
                                   dtype=dtype) for s in shapes)

    def plain(what, fn, *args):
        """fn(*args) as uint8, its seconds logged."""
        t = time.perf_counter()
        out = fn(*args)
        out = out.to(torch.uint8) if isinstance(out, torch.Tensor) \
            else tuple(p.to(torch.uint8) for p in out)
        torch.cuda.synchronize()
        log("conformance", f"plain {what} 3840x2160: "
            f"{time.perf_counter() - t:.3f} s")
        return out

    def lane0(planes):
        return tuple(p[:1] for p in planes)

    # K1/K5, then K2/K6 on K1's output with its tables: four synthetic_abi
    # pictures in one launch, then lane 0 alone, timed
    batch = [synthetic_batch(mw, mh, SEED + i, dev)[1] for i in range(B4)]
    a4 = {k: torch.cat([x[k] for x in batch]) for k in batch[0]}
    del batch
    res4 = residual_planes(a4, mw, mh, ws4, ws8)
    want = plain(f"intra_reconstruct B={B4}", intra_reconstruct, a4, *res4,
                 mw, mh)
    tables4 = deblock_tables(a4, mw, mh)
    want_d = plain(f"deblock_filter_planes B={B4}", deblock_filter_planes,
                   *want, tables4, mw, mh)
    a, res = {k: v[:1] for k, v in a4.items()}, lane0(res4)
    for key, fn in intra.items():
        compare(f"{key} 3840x2160 B={B4}",
                fn(a4, *res4, None, None, None, mw, mh), want)
        call = partial(fn, a, *res, None, None, None, mw, mh)
        compare(f"{key} 3840x2160", call(), lane0(want))
        results[key].update(ms_2160p=kernel_ms(call),
                            bound_ms_2160p=bound(*intra_need(a, res))[0])
    for key, fn in deblock.items():
        compare(f"{key} 3840x2160 B={B4}",
                fn(*(p.clone() for p in want), tables4, mw, mh), want_d)
    del a4, res4, tables4

    # K1/K5 on a random intra ABI of every MB kind over random init planes
    ra = {k: torch.from_numpy(v).to(dev)[None]
          for k, v in random_intra_abi(mw, mh, SEED + 4).items()}
    pcm = (ra["kind"].view(1, mh, mw) == 3) \
        .repeat_interleave(16, 1).repeat_interleave(16, 2)
    res_r = [torch.where(m, r.remainder(256), r) for r, m in zip(
        rand_planes(-300, 300, torch.int32),
        (pcm, pcm[:, ::2, ::2], pcm[:, ::2, ::2]))]
    init = rand_planes(0, 256, torch.int32)
    want_r = plain("intra_reconstruct random_intra_abi", intra_reconstruct,
                   ra, *res_r, mw, mh, *init)
    for key, fn in intra.items():
        compare(f"{key} 3840x2160 random_intra_abi",
                fn(ra, *res_r, *init, mw, mh), want_r)
    del ra, pcm, res_r, init, want_r

    # K2/K6 at B = 1, timed: on lane 0 of K1's output with its tables, on
    # textured planes with synthetic_abi_p tables, and on random planes
    # with random tables
    _, ap = synthetic_batch(mw, mh, SEED, dev, inter=True, bi_frac=0.3)
    planes_p, tables_p = rand_planes(96, 160, torch.uint8), \
        deblock_tables(ap, mw, mh)
    planes_r, tables_r = random_deblock_case(mw, mh, 1, SEED + 44)
    cases = (("synthetic_abi", lane0(want), deblock_tables(a, mw, mh),
              lane0(want_d)),
             ("synthetic_abi_p", planes_p, tables_p,
              plain("deblock_filter_planes synthetic_abi_p",
                    deblock_filter_planes, *planes_p, tables_p, mw, mh)),
             ("random_tables", planes_r, tables_r,
              plain("deblock_filter_planes random_tables",
                    deblock_filter_planes, *planes_r, tables_r, mw, mh)))
    for note, planes, tables, want_n in cases:
        for key, fn in deblock.items():
            compare(f"{key} 3840x2160 {note}",
                    fn(*(p.clone() for p in planes), tables, mw, mh), want_n)
            work = tuple(p.clone() for p in planes)
            ms = kernel_ms(partial(fn, *work, tables, mw, mh))
            bound_ms = bound(*deblock_need(tables, planes))[0]
            if note == "synthetic_abi":
                results[key].update(ms_2160p=ms, bound_ms_2160p=bound_ms)
            log("conformance", f"{results[key]['name']} 3840x2160 {note}: "
                f"kernel {ms:.4f} ms, bound {bound_ms:.4f} ms")
    del want, want_d, cases, planes_p, tables_p, planes_r, tables_r

    # K3/K4: four synthetic_abi_p streams, each over 4 random reference
    # pictures of its own, then with 5 % wild MVs (+-512 quarter samples);
    # then lane 0 alone, timed
    n_slots = 4
    rng = np.random.default_rng(SEED + 41)
    dpbs = [dpb_alloc(mw, mh, n_slots, dev) for _ in range(B4)]
    for dy, dc in dpbs:
        for s in range(n_slots):
            store_ref_fn(dy, dc, s, *(
                torch.randint(0, 256, shp[1:], generator=g, device=dev,
                              dtype=torch.uint8) for shp in shapes))
    dy, dc = (torch.stack(t) for t in zip(*dpbs))
    del dpbs
    abis = [synthetic_batch(mw, mh, SEED + 42 + b, dev, inter=True,
                            n_slots=n_slots, bi_frac=0.3)[0]
            for b in range(B4)]
    mv_h = np.stack([x["mv"] for x in abis])
    rs = torch.from_numpy(np.stack([x["refslot"] for x in abis])).to(dev)
    del abis
    cvoff = torch.zeros((B4, n_slots), dtype=torch.int32, device=dev)
    wild = rng.random(mv_h.shape[:4]) < 0.05
    wmv = rng.integers(-512, 513, mv_h.shape).astype(np.int32)
    for note, mvs in (("synthetic_abi_p", mv_h),
                      ("wild mv", np.where(wild[..., None, None], wmv,
                                           mv_h))):
        mv = torch.from_numpy(np.ascontiguousarray(mvs)).to(dev)
        args = {"mc_luma": (dy, mv, rs), "mc_chroma": (dc, mv, rs, cvoff)}
        for key, (kern, plain_fn) in mc.items():
            want = plain(f"{key} B={B4} {note}", plain_fn, *args[key],
                         mw, mh)
            compare(f"{key} 3840x2160 B={B4} {note}",
                    kern(*args[key], mw, mh), want)
            one = lane0(args[key])
            got = kern(*one, mw, mh)
            compare(f"{key} 3840x2160 {note}", got, want[:1])
            ms = kernel_ms(partial(kern, *one, mw, mh))
            bound_ms = bound(*mc_need(got, *one[1:]))[0]
            if note == "synthetic_abi_p":
                results[key].update(ms_2160p=ms, bound_ms_2160p=bound_ms)
            log("conformance", f"{results[key]['name']} 3840x2160 {note}: "
                f"kernel {ms:.4f} ms, bound {bound_ms:.4f} ms")
    del dy, dc, mv, rs, want, args
    for key in (*intra, *deblock):
        r = results[key]
        log("conformance", f"{r['name']} 3840x2160: kernel "
            f"{r['ms_2160p']:.4f} ms ({r['ms_2160p'] / r['ms']:.3f}x its "
            f"1080p {r['ms']:.4f}), bound {r['bound_ms_2160p']:.4f} ms")
    log("conformance", f"3840x2160: K1-K6 equal to their plain versions at "
        f"B = {B4} and B = 1")

    # chain estimates: each wavefront kernel on a one-MB-row strip walks
    # its MBs one after another; the picture's chain is 2 (mb_h - 1) +
    # mb_w such steps
    for mb_w, mb_h in ((MB_W, MB_H), (MB_W_4K, MB_H_4K)):
        _, a = synthetic_batch(mb_w, 1, SEED + 43, dev)
        res = residual_planes(a, mb_w, 1, ws4, ws8)
        row = intra_phase(a, *res, None, None, None, mb_w, 1)
        tables = deblock_tables(a, mb_w, 1)
        steps = 2 * (mb_h - 1) + mb_w
        est = {}
        for key, fn in intra.items():
            est[key] = kernel_ms(partial(fn, a, *res, None, None, None,
                                         mb_w, 1))
        for key, fn in deblock.items():
            work = tuple(p.clone() for p in row)
            est[key] = kernel_ms(partial(fn, *work, tables, mb_w, 1))
        log("conformance", f"chain estimate at {16 * mb_w}x{16 * mb_h} "
            f"({steps} steps; one-row strip of {mb_w} MBs ms x {steps} / "
            f"{mb_w}): " + ", ".join(
                f"{results[k]['name']} {v * steps / mb_w:.4f} ms (row "
                f"{v:.4f})" for k, v in est.items()) + f"; on {smi}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs only on a GPU")
    t_start = time.perf_counter()
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
    from tools.gpu_conformance import bm8_tally

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
    # ABIs, then K2/K6 on random tables over random planes; each pair
    # against the plain version and against each other
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
    for note, inter in (("synthetic_abi", False), ("synthetic_abi_p", True),
                        ("random_tables", None)):
        if inter is None:            # random planes and tables
            planes, tables = random_deblock_case(MB_W, MB_H, 1, SEED + 6)
        else:
            _, a = synthetic_batch(MB_W, MB_H, SEED, dev, inter=inter,
                                   **({"bi_frac": 0.3} if inter else {}))
            tables = deblock_tables(a, MB_W, MB_H)
        if note == "synthetic_abi":
            res = residual_planes(a, MB_W, MB_H, ws4, ws8)
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
        elif inter:                  # mid-grey planes with texture
            g = torch.Generator(device=dev).manual_seed(SEED)
            planes = tuple(torch.randint(96, 160, s, generator=g, device=dev,
                                         dtype=torch.uint8)
                           for s in ((1, H, W), (1, H // 2, W // 2),
                                     (1, H // 2, W // 2)))
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
    # K2, K6 at B = 4 also on synthetic_abi_p tables over textured planes
    # and on random tables over random planes
    batch = [synthetic_batch(MB_W, MB_H, SEED + 20 + i, dev, inter=True,
                             bi_frac=0.3)[1] for i in range(B4)]
    ap4 = {k: torch.cat([x[k] for x in batch]) for k in batch[0]}
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    cases4 = (("synthetic_abi_p", tuple(
        torch.randint(96, 160, p.shape, generator=g, device=dev,
                      dtype=torch.uint8) for p in got),
        deblock_tables(ap4, MB_W, MB_H)),
        ("random_tables", *random_deblock_case(MB_W, MB_H, B4, SEED + 21)))
    for note, planes4, tables4 in cases4:
        want = tuple(p.to(torch.uint8) for p in deblock_filter_planes(
            *planes4, tables4, MB_W, MB_H))
        for key, fn, kid, *_ in deblock_kernels:
            compare(f"{key} B={B4} {note}", fn(*(p.clone() for p in planes4),
                                               tables4, MB_W, MB_H), want)
            work = tuple(p.clone() for p in planes4)
            ms = kernel_ms(partial(fn, *work, tables4, MB_W, MB_H))
            log("wavefront", f"{key} ({kid}) B={B4} {note}: equal, kernel "
                f"{ms:.4f} ms, bound "
                f"{bound(*deblock_need(tables4, planes4))[0]:.4f} ms")
    del batch, ap4, cases4

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

    # K3 + K4 on MBs split 16x8, 8x16 or 8x8, one MV and slot a part
    from tools.mc_bench import motion as mc_motion

    def partitions(B):
        return (torch.from_numpy(a).to(dev) for a in mc_motion(
            "partitions", MB_W, MB_H, B, SEED + 30))

    for key, (ms, bound_ms) in mc_case("partitions", dpbs,
                                       *partitions(1)).items():
        results[key].update(ms_partitions=ms, bound_ms_partitions=bound_ms)
    del dpbs

    # K3 + K4 on the smoke stream's own pictures
    for kind, (*dpbs, mv, rs, _) in stream_mc_inputs(STREAM.read_bytes(),
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
    for key, (ms, bound_ms) in mc_case(f"B={B8} partitions", dpbs,
                                       *partitions(B8)).items():
        results[key].update(ms_b8_partitions=ms,
                            bound_ms_b8_partitions=bound_ms)
    del dpbs

    # K7 and K8, then K9, K10 and K11: the stages the reference computes
    # in XLA
    k12_want = tables_and_wire(record, results, smi)
    stage_kernels(record, results, smi)

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
        with bm8_tally() as tally:
            md5 = [hashlib.md5(f.planar()).hexdigest()
                   for f in dec.decode_annexb(data)]
        torch.cuda.synchronize()
        return dec, md5, time.perf_counter() - t, tally

    launches = {}
    for order, path in paths.items():
        *_, cold_s, _ = decode(order)           # warm-up: first-call costs
        kernels.reset_launches()
        (dec, md5, wall_s, tally), *meter = metered(partial(decode, order))
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
        got = launches[order]
        once = got["deblock_tables"] == got["residual"] == \
            got["unpack_wire"] == tally["unpacks"] == len(md5)
        if ran != set(path) | {"deblock_tables", "unpack_bm8", "residual",
                               "inter_combine", "store_refs", "unpack_wire"} \
                or not once or got["unpack_bm8"] != tally["bm8"] \
                or got["inter_combine"] != got["mc_luma"] \
                or not got["store_refs"] == tally["stores"] > 0:
            sys.exit(f"decode {order}: launched {got}, expected "
                     f"{sorted(path)}, deblock_tables, residual and "
                     f"unpack_wire once a picture, inter_combine with "
                     f"mc_luma, store_refs {tally['stores']} times and "
                     f"unpack_bm8 "
                     f"{tally['bm8']} times ({tally['unpacks']} wire uploads "
                     f"of {len(md5)} pictures)")
        log("decode", f"order={order}: {len(md5)} frames "
            f"{golden['width']}x{golden['height']} MD5 == libavcodec golden; "
            f"{wall_s:.3f} s wall, {len(md5) / wall_s:.3f} fps (first pass "
            f"{cold_s:.3f} s) on {smi}; launches {launches[order]}; stats "
            f"{dec.stats.as_dict()}")
        gil_line(f"single-stream Decoder order={order} upload=wire, "
                 f"{STREAM.name}", len(md5), wall_s, dec.stats.host_parse_s,
                 *meter, smi)

    batch_launches = batch_phase(paths, smi)
    field_launches = fields_phase(paths, smi)
    feature_launches = features_phase(paths, smi)
    regions, region_launches = wire_phase(paths, smi)
    t = time.perf_counter()
    conformance_launches = conformance_phase(paths, smi)
    kernels_2160p(results, smi)
    log("conformance", f"phase 11 in {time.perf_counter() - t:.1f} s")

    # device launches per wrapper call (every kernel must launch once, K8
    # its DEVICE_LAUNCHES, K12 one or two) and per unpack_wire call, in the
    # process's one profiler session
    from arrow_h264_tpu_torch.ops.kernels.unpack_bm8 import DEVICE_LAUNCHES
    counted = device_launches(calls, regions)
    # the unpack_wire regions' K8 and K12 calls put their kernels in the
    # same session, under the same names
    counted["unpack_bm8"] -= sum(b for b, _ in region_launches.values())
    counted["unpack_wire"] -= sum(k for _, k in region_launches.values())
    for key in results:
        n_dev = results[key]["device_launches"] = counted[key]
        want = {"unpack_bm8": DEVICE_LAUNCHES,
                "unpack_wire": k12_want}.get(key, 1)
        log("kernels", f"{results[key]['name']}: {n_dev} device launch(es) "
            f"per wrapper call")
        if n_dev != want:
            sys.exit(f"{key}: {n_dev} device launches per call, not {want}")
    for name in regions:
        k, ms, names = counted[name]
        bm8, k12 = region_launches[name]
        log("wire", f"{name} (round 1 of lanes cycling the four streams): "
            f"{k} device launches per call ({bm8}, K8's one call for the "
            f"round's bm8 classes, + {k12}, K12), {ms:.4f} ms of kernel time "
            f"summed (torch.profiler); on {smi}")
        if k != bm8 + k12 or k > MAX_UNPACK_LAUNCHES or not all(
                "unpack_bm8_kernel" in s or "unpack_wire_kernel" in s
                for s in names):
            sys.exit(f"{name}: {k} device launches {sorted(names)}, "
                     f"expected only K8's ({bm8}) and K12's ({k12}), at most "
                     f"{MAX_UNPACK_LAUNCHES}")

    if "jax" in sys.modules or any(m.split(".")[0] == "arrow_h264_tpu"
                                   for m in sys.modules):
        sys.exit("the port imported jax or the JAX package")
    for key, r in results.items():
        order = "raster" if key.endswith("_raster") else "phase"
        r["launches"] = batch_launches[order][key]
        r["launches_decode"] = launches[order][key]
        r["launches_fields"] = field_launches[order][key]
        r["launches_features"] = feature_launches[order][key]
        r["launches_conformance"] = conformance_launches[order][key]
    log("done", f"chip_smoke in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
