"""Host times of the wire pack alone: ops/wire.py's pack_wire_raw (one
GIL-released call of the host library, host/cpp/entropy_wire.inc) and
its numpy twin pack_wire_raw_numpy, in turns, on 1 and on 8 threads.

    python tools/pack_bench.py [--streams NAME ...] [--lanes 32]
        [--repeat 2] [--out FILE.json]

The pictures are those of the committed streams (default: the
benchmark's broadcast stream bench_broadcast_s0, 12 1080p pictures, and
conf_c5, 3 2160p ones), parsed by the port's Decoder on the CPU with the
device step left out, each copied out of the parser's buffers with its
decode-time row hints.  A run packs every picture of a stream `lanes`
times (a lockstep round's worth of lanes a picture) through a pool of T
threads (T = 1, 8), in the order numpy, C, C, numpy, `repeat` times, and
reads:

- `ms_per_picture`: the run's wall over the pictures packed;
- `released_pct`: the share of the threads' pack seconds spent inside
  the library's GIL-releasing calls (centropy.gil_meter), the part that
  runs on several threads at once;
- the C pack's `full_scans`: the pictures whose row hints were unusable.

Every C pack's spec and emitted bytes are checked equal to the numpy
twin's first (the script exits non-zero otherwise).  Prints one JSON
line (the host's CPU, its core count and, where nvidia-smi answers, the
card's name and power limit) and writes it to FILE if --out is given.
Needs no GPU; on the card's machine it times that machine's host.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from arrow_h264_tpu_torch.api import Decoder  # noqa: E402
from arrow_h264_tpu_torch.host.centropy import gil_meter  # noqa: E402
from arrow_h264_tpu_torch.models import pipeline  # noqa: E402
from arrow_h264_tpu_torch.ops import wire  # noqa: E402

DATA = REPO / "tests" / "data"
# the ABI keys the pack reads (ops/wire.py)
KEYS = ("kind", "qp", "slice_id", "deblock_off", "mb_avail", "tr8",
        "i16_mode", "chroma_mode", "nz", "disable_idc", "alpha_off",
        "beta_off", "slogwd", "i4_modes", "i4_avail", "i8_modes", "i8_avail",
        "mv", "refidx", "refslot", "refid", "nx_uids", "pcm", "wtab",
        "luma4", "luma8", "chroma_ac", "luma_dc", "chroma_dc")
PACKS = {"numpy": wire.pack_wire_raw_numpy, "c": wire.pack_wire_raw}


def pictures(name: str) -> list:
    """(ABI copy, mb_w, mb_h) of each wire-uploaded picture of a stream."""
    out = []

    def step(self, abi):
        if "wp" not in abi:
            a = {k: np.copy(abi[k]) for k in KEYS if k in abi}
            a["_nzr"] = {f: np.copy(h) for f, h in abi["_nzr"].items()}
            out.append((a, self.mb_w, self.mb_h))
        self.last_upload = ("wire", 0)
        self.last_full_scans = 0
        h, w = 16 * self.mb_h, 16 * self.mb_w
        return (torch.zeros((h, w), dtype=torch.uint8),
                torch.zeros((h // 2, w // 2), dtype=torch.uint8),
                torch.zeros((h // 2, w // 2), dtype=torch.uint8))

    orig = pipeline.DevicePipeline.decode_frame
    pipeline.DevicePipeline.decode_frame = step
    try:
        list(Decoder(device="cpu").decode_annexb(
            (DATA / f"{name}.264").read_bytes()))
    finally:
        pipeline.DevicePipeline.decode_frame = orig
    return out


def check(pics: list) -> int:
    """Holds the C pack byte-equal to the numpy twin on every picture;
    returns the pictures whose row hints were unusable."""
    full = 0
    for abi, mb_w, mb_h in pics:
        n = mb_w * mb_h
        raw, spec = wire.pack_wire_raw(abi, mb_w, mb_h)
        oraw, ospec = wire.pack_wire_raw_numpy(abi, mb_w, mb_h)
        if spec != ospec or not np.array_equal(
                wire.emit_wire(raw, spec, spec, n),
                wire.emit_wire(oraw, ospec, ospec, n)):
            sys.exit("pack_bench: the C pack differs from the numpy twin")
        full += raw["full_scans"] > 0
    return full


def run(pics: list, pack, threads: int, lanes: int) -> dict:
    """Every picture packed `lanes` times through `threads` threads."""
    work = [p for p in pics for _ in range(lanes)]
    busy = []

    def one(p):
        t0 = time.perf_counter()
        pack(*p)
        busy.append(time.perf_counter() - t0)

    gil_meter.reset()
    gil_meter.enabled = True
    with ThreadPoolExecutor(threads) as pool:
        t0 = time.perf_counter()
        list(pool.map(one, work))
        wall = time.perf_counter() - t0
    gil_meter.enabled = False
    return {"ms_per_picture": 1e3 * wall / len(work),
            "released_pct": 100.0 * gil_meter.released_s / sum(busy)}


def host() -> dict:
    cpu = next((ln.split(":", 1)[1].strip() for ln in
                Path("/proc/cpuinfo").read_text().splitlines()
                if ln.startswith("model name")), "unknown")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = None
    return {"cpu": cpu, "cores": os.cpu_count(), "card": smi}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", nargs="+",
                    default=["bench_broadcast_s0", "conf_c5"])
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    torch.set_num_threads(1)
    result = {"host": host(), "lanes": args.lanes, "streams": {}}
    for name in args.streams:
        pics = pictures(name)
        rows = {"pictures": len(pics), "full_scans": check(pics)}
        for threads in (1, 8):
            for _ in range(args.repeat):
                for impl in ("numpy", "c", "c", "numpy"):
                    rows.setdefault(f"{impl}_t{threads}", []).append(
                        run(pics, PACKS[impl], threads, args.lanes))
        result["streams"][name] = rows
        del pics
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
