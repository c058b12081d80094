"""Where the time goes in the PyTorch port's decode on one GPU.

    python tools/profile_torch.py [STREAM ...] [--order phase|raster]
                                  [--upload wire|dense] [--batch N]
                                  [--out FILE.json]

Without --batch, the first STREAM (default
tests/data/smoke_1080p_high.264) is decoded with
arrow_h264_tpu_torch.api.Decoder(device="cuda", order=ORDER).  With
--batch N, arrow_h264_tpu_torch.parallel.batch.BatchDecoder(N) decodes N
lanes that cycle through the STREAMs (default: the four committed 1080p
streams of chip_smoke.py's batch phase) in lockstep rounds.  The intra
and deblock kernels are the knight-move wavefront ones (phase, the
default) or the raster-order ones; --upload ships each picture's ABI as a
wire buffer (the default) or dense.  The decode runs four times:
  1. warm-up (first-call costs: library loads, allocator growth);
  2. free-running: wall time and frames per second (of all lanes);
  3. staged: each pipeline stage is timed on the host clock between
     torch.cuda.synchronize() calls, so a stage's time holds its host work
     and its device work (the syncs serialise the two, and with --batch the
     parse pool's overlap with the device, so the stages add up to more
     than pass 2's wall time); host parse (with --batch also the wire
     pack, which runs in the pool) and the output copy are the lanes'
     summed DecodeStats.  The upload is `_upload`, the round's main-thread
     upload, with --batch; without, `pack_wire_raw` and `upload_wire`, or
     `upload_batch` for dense; a wire upload's device half, `unpack_wire`,
     is also timed on its own (inside the upload's time);
  4. profiled: torch.profiler's device time per kernel, and the device's
     busy share of the pass's wall time.
Prints a table (ms per frame, and per round with --batch), and writes the
numbers as JSON to FILE if --out is given.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from arrow_h264_tpu_torch import api  # noqa: E402
from arrow_h264_tpu_torch.models import pipeline  # noqa: E402
from arrow_h264_tpu_torch.parallel import batch as batchmod  # noqa: E402
from arrow_h264_tpu_torch.parallel import sharding as shardmod  # noqa: E402

DATA = REPO / "tests" / "data"
BATCH_STREAMS = [DATA / f"{n}.264" for n in (
    "smoke_1080p_high", "batch_1080p_s1", "batch_1080p_s2", "batch_1080p_s3")]
# (module or class, name) of the pipeline stages that are timed, by
# (batch, upload); the intra and deblock kernels are timed through
# pipeline.ORDERS, under the wrappers' names; `deblock_tables` is the
# name under which the pipeline calls K7's wrapper
# (ops/kernels/deblock_tables.py).  The store of a batch is timed where
# parallel.sharding calls it.  `unpack_wire` (the device half of a wire
# upload, K8 among it) is also part of `upload_wire` / `_upload`.
SHARED = [(pipeline, s) for s in ("residual_planes", "_mc_pred",
                                  "deblock_tables")]
STAGES = {
    (False, "wire"): [(pipeline, "pack_wire_raw"), (pipeline, "upload_wire"),
                      (pipeline, "unpack_wire"),
                      (pipeline, "store_ref_fn")] + SHARED,
    (False, "dense"): [(pipeline, "upload_batch"),
                       (pipeline, "store_ref_fn")] + SHARED,
}
for _up in ("wire", "dense"):
    STAGES[True, _up] = [(batchmod.BatchDecoder, "_upload"),
                         (shardmod, "store_refs_fn")] + SHARED + (
        [(pipeline, "unpack_wire")] if _up == "wire" else [])


def decode(datas: list, order: str, batch: int, upload: str):
    """(frames, rounds, wall seconds, per-lane DecodeStats dicts)."""
    t0 = time.perf_counter()
    if batch:
        with batchmod.BatchDecoder(batch, device="cuda", order=order,
                                   upload=upload) as bd:
            outs = bd.decode([datas[i % len(datas)] for i in range(batch)])
        if any(e is not None for e in bd.errors):
            sys.exit(f"profile_torch: lanes failed: {bd.errors}")
        n, rounds, stats = sum(map(len, outs)), bd.rounds, bd.stats
    else:
        dec = api.Decoder(device="cuda", order=order, upload=upload)
        n = sum(1 for _ in dec.decode_annexb(datas[0]))
        rounds, stats = n, [dec.stats.as_dict()]
    torch.cuda.synchronize()
    return n, rounds, time.perf_counter() - t0, stats


def staged(datas: list, order: str, batch: int, upload: str) -> dict:
    """Seconds per stage (host clock between device syncs)."""
    acc = defaultdict(float)
    orig = [(m, s, getattr(m, s)) for m, s in STAGES[bool(batch), upload]]

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            return out
        return run

    orders = pipeline.ORDERS
    for m, s, fn in orig:
        setattr(m, s, timed(s, fn))
    pipeline.ORDERS = {o: tuple(timed(f.__name__, f) for f in fns)
                       for o, fns in orders.items()}
    try:
        n, rounds, wall, stats = decode(datas, order, batch, upload)
    finally:
        for m, s, fn in orig:
            setattr(m, s, fn)
        pipeline.ORDERS = orders
    acc["host_parse"] = sum(st["host_parse_s"] for st in stats)
    acc["emit_d2h"] = sum(st["emit_sync_s"] for st in stats)
    return {"frames": n, "rounds": rounds, "wall_s": wall,
            "stage_s": dict(acc),
            "upload_bytes": sum(st["upload_bytes"] for st in stats)}


def profiled(datas: list, order: str, batch: int, upload: str) -> dict:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n, _, wall, _ = decode(datas, order, batch, upload)
    # device activities only (kernels, copies): the CPU ops that launched
    # them report the same device time again
    kernels = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] += e.self_device_time_total
    busy_s = sum(kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    return {"frames": n, "wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall,
            "top_kernels_ms": {k: v / 1e3 for k, v in top}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("streams", nargs="*", type=Path)
    ap.add_argument("--order", default="phase", choices=("phase", "raster"))
    ap.add_argument("--upload", default="wire", choices=pipeline.UPLOADS)
    ap.add_argument("--batch", type=int, default=0,
                    help="decode N lanes with BatchDecoder (0: Decoder)")
    ap.add_argument("--out", help="write the numbers as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch: needs a CUDA device")
    paths = args.streams or (BATCH_STREAMS if args.batch else BATCH_STREAMS[:1])
    datas = [p.read_bytes() for p in paths]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    run = (datas, args.order, args.batch, args.upload)
    decode(*run)
    n, rounds, wall, _ = decode(*run)
    out = {"streams": [p.name for p in paths], "gpu": smi,
           "order": args.order, "upload": args.upload, "batch": args.batch,
           "free_running": {"frames": n, "rounds": rounds, "wall_s": wall,
                            "fps": n / wall},
           "staged": staged(*run),
           "profiled": profiled(*run)}
    what = f"batch={args.batch} " if args.batch else ""
    print(f"{','.join(out['streams'])} {what}order={args.order} "
          f"upload={args.upload} on {smi}: {n} frames in {rounds} rounds, "
          f"{wall:.4f} s, {n / wall:.3f} fps; "
          f"{out['staged']['upload_bytes'] / n:.0f} upload bytes/frame")
    st = out["staged"]
    for k, v in sorted(st["stage_s"].items(), key=lambda kv: -kv[1]):
        print(f"  {k:16s} {1e3 * v / st['frames']:9.3f} ms/frame "
              f"{1e3 * v / st['rounds']:10.3f} ms/round")
    pr = out["profiled"]
    print(f"  device busy {pr['device_busy_s']:.4f} s of {pr['wall_s']:.4f} s"
          f" ({100 * pr['device_busy_share']:.1f} %)")
    for k, v in pr["top_kernels_ms"].items():
        print(f"  {v / pr['frames']:9.3f} ms/frame  {k[:90]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
