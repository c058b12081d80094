"""Where the time goes in the PyTorch port's decode on one GPU.

    python tools/profile_torch.py [STREAM] [--order phase|raster]
                                  [--out FILE.json]

STREAM defaults to tests/data/smoke_1080p_high.264.  The stream is decoded
four times with arrow_h264_tpu_torch.api.Decoder(device="cuda",
order=ORDER), whose intra and deblock kernels are the knight-move
wavefront ones (phase, the default) or the raster-order ones:
  1. warm-up (first-call costs: library loads, allocator growth);
  2. free-running: wall time and frames per second;
  3. staged: each pipeline stage is timed on the host clock between
     torch.cuda.synchronize() calls, so a stage's time holds its host work
     and its device work (the syncs serialise the two, so the stages add
     up to more than pass 2's wall time);
  4. profiled: torch.profiler's device time per kernel, and the device's
     busy share of the pass's wall time.
Prints a table, and writes the numbers as JSON to FILE if --out is
given.  Needs a CUDA device.
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

# pipeline stages, as names in models/pipeline.py; the intra and deblock
# kernels are timed through pipeline.ORDERS, under the wrappers' names
STAGES = ("upload_abi", "residual_planes", "_mc_pred", "deblock_tables",
          "store_ref_fn")


def decode(data: bytes, order: str) -> tuple[int, float, api.Decoder]:
    dec = api.Decoder(device="cuda", order=order)
    t0 = time.perf_counter()
    n = sum(1 for _ in dec.decode_annexb(data))
    torch.cuda.synchronize()
    return n, time.perf_counter() - t0, dec


def staged(data: bytes, order: str) -> dict:
    """Seconds per stage (host clock between device syncs)."""
    acc = defaultdict(float)
    orig = {s: getattr(pipeline, s) for s in STAGES}

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
    for s, fn in orig.items():
        setattr(pipeline, s, timed(s, fn))
    pipeline.ORDERS = {o: tuple(timed(f.__name__, f) for f in fns)
                       for o, fns in orders.items()}
    try:
        n, wall, dec = decode(data, order)
    finally:
        for s, fn in orig.items():
            setattr(pipeline, s, fn)
        pipeline.ORDERS = orders
    acc["host_parse"] = dec.stats.host_parse_s
    acc["emit_d2h"] = dec.stats.emit_sync_s
    return {"frames": n, "wall_s": wall, "stage_s": dict(acc)}


def profiled(data: bytes, order: str) -> dict:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n, wall, _ = decode(data, order)
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
    ap.add_argument("stream", nargs="?",
                    default=str(REPO / "tests/data/smoke_1080p_high.264"))
    ap.add_argument("--order", default="phase", choices=("phase", "raster"))
    ap.add_argument("--out", help="write the numbers as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch: needs a CUDA device")
    data = Path(args.stream).read_bytes()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    decode(data, args.order)
    n, wall, _ = decode(data, args.order)
    out = {"stream": Path(args.stream).name, "gpu": smi,
           "order": args.order,
           "free_running": {"frames": n, "wall_s": wall, "fps": n / wall},
           "staged": staged(data, args.order),
           "profiled": profiled(data, args.order)}
    print(f"{out['stream']} order={args.order} on {smi}: {n} frames, "
          f"{wall:.4f} s, {n / wall:.3f} fps")
    st = out["staged"]
    for k, v in sorted(st["stage_s"].items(), key=lambda kv: -kv[1]):
        print(f"  {k:16s} {1e3 * v / st['frames']:9.3f} ms/frame")
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
