"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything a cell is made of is found by name under the benchmark's root
(`root`, this directory unless a test gives another):

- `BENCHMARK.json`, beside the root, names the cell's configuration and
  traffic, and which metrics the cell reports;
- `configs/CONFIG.json`: the deployment (stream format) the cell decodes;
- `workloads/TRAFFIC.json`: its traffic: the stream set (names of
  `data/NAME.json` goldens), the lanes, how many streams a lane decodes
  back to back in one call (`streams_per_call`), and where frames go
  (`output`: "device", kept on the card, or "host", copied out as numpy);
- `metrics/METRIC.py`: a reader, `read(window) -> float | None`, of one
  metric from the run's `Window` record; None leaves it out of the line.

The run drives the port's public entry, `BatchDecoder.decode`, over one
lane a stream, closed loop: every access unit of a call is there at its
start.  In each call a lane decodes `streams_per_call` whole streams of
the set joined into one byte string, in the seed's order
(lanes.lane_orders), each a coded video sequence of its own.  A call
cannot be stopped part way, so the window is a run of calls, until the
next call would end further past `seconds` than stopping now ends short
of it.  The clock runs inside the calls only: after each call's device
sync it stops, the call's frames are hashed for the check, and it starts
again with the next call, so the window is the sum of the calls' times.
The device cells gather a call's frames into one buffer on the card,
made at set-up and reused by every call.
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from . import devtrace, golden, lanes, roofline

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "arrow_h264_tpu")
OUTPUTS = ("device", "host")
# the host library's GIL-releasing calls made inside a lane's timed parse
# and pack (DecodeStats.host_parse_s): the slice parse and the wire scans
PARSE_CALLS = ("h264e_parse_slice", "h264e_reset_pic", "h264e_scan_rows32",
               "h264e_scan_blocks8", "h264e_gather_blocks8",
               "h264e_scan_inter")
STAT_KEYS = ("host_parse_s", "device_dispatch_s", "emit_sync_s")


class BenchError(RuntimeError):
    """The cell cannot be run as its files describe it."""


@dataclass
class Window:
    """What one measured window recorded; the metric readers' input."""
    output: str                 # "device" or "host"
    seconds: float              # the calls' summed wall time, host clock
    setup_s: float              # process start to the window's start
    attempted: int              # golden frames due in the window
    frames: int                 # frames the lanes produced
    frames_ok: int              # ... equal to their goldens
    rounds: int
    host_parse_s: float         # summed over lanes (lane-seconds)
    device_dispatch_s: float    # summed over lanes: the batch's
    emit_sync_s: float          # summed over lanes
    upload_s: float             # the main thread's
    parse_released_s: float | None   # traced: parse seconds inside C
    gaps_s: list | None         # device output: lanes' frame gaps in a call
    picture_bytes: int          # roofline.picture_bytes over the window
    trace: dict | None          # traced: devtrace.reduce_events + window


# ---- files ------------------------------------------------------------------

def load_spec(root: Path = BENCH) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def load_part(root: Path, kind: str, name: str) -> dict:
    """`root`/kind/name.json: a configuration or a traffic mix."""
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1]} file {path}")
    return json.loads(path.read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of `workload` reports: end-to-end ones with
    trace off, per-layer ones with it on."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key]
            if "workloads" not in m or workload in m["workloads"]]


def reader(root: Path, name: str):
    """The `read` function of `root`/metrics/name.py."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no reader {path} for metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not hold, each
    compared whole (arrow_h264_tpu_torch is not arrow_h264_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---- the frames' consumer on the card -------------------------------------

class DeviceConsumer:
    """`on_frame` of a device cell, as a model's input stage: it gathers
    each frame's display planes into the frame's row of a device buffer
    (every byte read on the card), notes the host time, and at the first
    frame of each round waits for the previous round's gathers, so the
    host never queues rounds ahead of the card without bound.  Returns
    None, so the decoder keeps no frame."""

    def __init__(self, width: int, height: int, device):
        import torch
        self.w, self.h = width, height
        self.nbytes = width * height * 3 // 2
        self.cuda = torch.device(device).type == "cuda"
        self.event = torch.cuda.Event() if self.cuda else None
        self.bd = None
        self.round = -1
        self.warm = torch.empty((1, self.nbytes), dtype=torch.uint8,
                                device=device)
        self.set_window(None, [])

    def set_window(self, arena, caps) -> None:
        """Gather the next decode call's frames into `arena` ([len(caps) *
        rows, nbytes]; lane i's first `caps[i]` frames from row i * rows),
        or into one scratch row when None (warm-up).  The frames' times
        start anew: a lane's gaps are taken within a call."""
        self.arena, self.caps = arena, list(caps)
        rows = 0 if arena is None else arena.shape[0] // max(1, len(caps))
        self.bases = [i * rows for i in range(len(self.caps))]
        self.counts = [0] * len(self.caps)
        self.extra = [0] * len(self.caps)
        self.times: list[list[float]] = [[] for _ in self.caps]

    def __call__(self, lane: int, frame):
        now = time.perf_counter()
        if self.cuda and self.bd.rounds != self.round:
            self.event.synchronize()        # the previous round's gathers
        self.round = self.bd.rounds
        if self.arena is None:
            row = self.warm[0]
        else:
            self.times[lane].append(now)
            if self.counts[lane] >= self.caps[lane]:
                self.extra[lane] += 1
                return None
            row = self.arena[self.bases[lane] + self.counts[lane]]
            self.counts[lane] += 1
        w, h = self.w, self.h
        n = w * h
        row[:n].view(h, w).copy_(frame.y[:h, :w])
        row[n:n + n // 4].view(h // 2, w // 2).copy_(frame.cb[:h // 2,
                                                             :w // 2])
        row[n + n // 4:].view(h // 2, w // 2).copy_(frame.cr[:h // 2,
                                                            :w // 2])
        if self.cuda:
            self.event.record()
        return None


# ---- one run ----------------------------------------------------------------

def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _stat_sums(bd) -> dict:
    return {k: sum(s[k] for s in bd.stats) for k in STAT_KEYS}


def card_info() -> dict:
    """nvidia-smi's name and power limit of the first card, if it runs."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"power_limit": "not read"}
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda:0", root: Path = BENCH,
             control: bool = False) -> tuple[dict, dict]:
    """Run `workload` once: (the result line's object, the numbers
    compared).  control: each output sample's lowest bit cleared before
    the comparison (the check's control; never in the benchmark's own
    runs)."""
    spec = load_spec(root)
    entry = cell(spec, workload)
    traffic = load_part(root, "workloads", entry["traffic"])
    config = load_part(root, "configs", entry["config"])
    if traffic["config"] != entry["config"]:
        raise BenchError(f"traffic {entry['traffic']!r} is for config "
                         f"{traffic['config']!r}, not {entry['config']!r}")
    if traffic["output"] not in OUTPUTS:
        raise BenchError(f"output {traffic['output']!r}: one of {OUTPUTS}")
    streams = [lanes.load_stream(n, root) for n in traffic["streams"]]
    # the set's display size; its MB grid is the configuration's
    width, height = streams[0].width, streams[0].height
    for s in streams:
        if (s.width, s.height) != (width, height) or \
                (-(-s.width // 16), -(-s.height // 16)) != \
                (config["mb_width"], config["mb_height"]):
            raise BenchError(f"{s.name}: {s.width}x{s.height}, not the set's "
                             f"{width}x{height} on config {entry['config']}'s "
                             f"{config['mb_width']}x{config['mb_height']} MBs")
    n_lanes, host = traffic["lanes"], traffic["output"] == "host"
    per_call = traffic["streams_per_call"]
    wanted = metrics_for(spec, workload, trace)
    readers = {m["name"]: reader(root, m["name"]) for m in wanted}
    spans = {}

    t = time.perf_counter()
    import torch
    from arrow_h264_tpu_torch.host.centropy import gil_meter
    from arrow_h264_tpu_torch.ops.kernels import build
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    spans["import_s"] = time.perf_counter() - t

    t = time.perf_counter()
    consumer = None if host else DeviceConsumer(width, height, device)
    bd = BatchDecoder(n_lanes, device=device, materialize=host,
                      on_frame=consumer)
    if consumer is not None:
        consumer.bd = bd
    if any(d.entropy != "cpp" for d in bd.decoders):
        raise BenchError("the host entropy library did not load")
    spans["lanes_s"] = time.perf_counter() - t

    # the buffer that a device cell's calls gather their frames into
    arena = None
    if consumer is not None:
        rows = per_call * max(s.frames for s in streams)
        arena = torch.empty((n_lanes * rows, consumer.nbytes),
                            dtype=torch.uint8, device=device)

    # warm-up: every lane two streams of the set joined, each cut to the
    # shortest prefix that holds every picture kind of the stream: the
    # kernels' build and first launches, and a lane's switch to a new
    # coded video sequence
    m = len(streams)

    def prefix(k):
        return lanes.truncate(streams[k % m].data,
                              lanes.warm_pictures(streams[k % m]))

    t = time.perf_counter()
    bd.decode([prefix(i) + prefix(i + 1) for i in range(n_lanes)])
    _sync(device)
    spans["warm_s"] = time.perf_counter() - t

    orders = lanes.lane_orders(m, n_lanes, seed)
    cuda = torch.device(device).type == "cuda"
    stats0 = _stat_sums(bd)
    if trace:
        gil_meter.reset()

    # the window: decode calls, each lane its next streams in the seed's
    # order, timed from a synced card to a synced card; each call's frames
    # are hashed off the clock
    got, want = [[] for _ in range(n_lanes)], [[] for _ in range(n_lanes)]
    extra, failed = [0] * n_lanes, [False] * n_lanes
    kinds, gaps, sessions, call_s, cpu_s = [], [], [], [], []
    rounds, upload_s, window_s, check_s = 0, 0.0, 0.0, 0.0
    setup_s = None
    while True:
        call = [lanes.call_streams(streams, o, len(call_s), per_call)
                for o in orders]
        data = [b"".join(s.data for s in c) for c in call]
        due = [sum(s.frames for s in c) for c in call]
        for i, c in enumerate(call):
            want[i] += [x for s in c for x in s.md5]
        kinds.append("".join(s.structure for c in call for s in c))
        if consumer is not None:
            consumer.set_window(arena, due)
        prof = None
        if trace:
            gil_meter.enabled = True
            if cuda:
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
        try:
            _sync(device)
            t0 = time.perf_counter()
            c0 = time.process_time()
            if setup_s is None:
                setup_s = t0 - t_start
            frames = bd.decode(data)
            _sync(device)
            call_s.append(time.perf_counter() - t0)
            cpu_s.append(time.process_time() - c0)
        finally:
            gil_meter.enabled = False
            if prof is not None:
                prof.__exit__(None, None, None)
        t = time.perf_counter()
        if prof is not None:
            sessions.append(devtrace.device_events(prof))
        window_s += call_s[-1]
        rounds += bd.rounds
        upload_s += bd.upload_s
        failed = [f or e is not None for f, e in zip(failed, bd.errors)]
        if host:
            for i, (f, n) in enumerate(zip(frames, due)):
                extra[i] += max(0, len(f) - n)
            md5 = golden.host_md5s([f[:n] for f, n in zip(frames, due)],
                                   control)
        else:
            for i, e in enumerate(consumer.extra):
                extra[i] += e
            gaps += [b - a for ts in consumer.times
                     for a, b in zip(ts, ts[1:])]
            md5 = golden.arena_md5s(arena, consumer.counts, consumer.bases,
                                    control)
        del frames
        for i in range(n_lanes):
            got[i] += md5[i]
        check_s += time.perf_counter() - t
        if window_s * (1 + 0.5 / len(call_s)) >= seconds:
            break

    # after the window: the peak, the program's state freed, the tally
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    arena_bytes = 0 if arena is None else arena.numel()
    stats1 = _stat_sums(bd)
    bd.close()
    del bd, arena
    produced = sum(map(len, got)) + sum(extra)
    compared = golden.compare(got, want, failed, extra)
    ok = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))

    reduced = None
    if trace and cuda:
        spans["device_events"] = sum(map(len, sessions))
        reduced = devtrace.reduce_events(sessions)
        if reduced is not None:
            reduced["window_s"] = window_s
    win = Window(
        output=traffic["output"], seconds=window_s, setup_s=setup_s,
        attempted=sum(map(len, want)), frames=produced,
        frames_ok=ok, rounds=rounds,
        **{k: stats1[k] - stats0[k] for k in STAT_KEYS}, upload_s=upload_s,
        parse_released_s=(sum(gil_meter.calls.get(c, 0.0)
                              for c in PARSE_CALLS) if trace else None),
        gaps_s=gaps if consumer is not None else None,
        picture_bytes=sum(roofline.picture_bytes(width, height, k)
                          for k in "".join(kinds)),
        trace=reduced)
    units = {m["name"]: m["unit"] for m in wanted}
    metrics = {}
    for name, read in readers.items():
        v = read(win)
        if v is not None:
            metrics[name] = {"value": v, "unit": units[name]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = reduced["busy_s"] if reduced else 0.0
        dev["window_s"] = window_s
    result = {"correct": golden.correct(compared),
              "attempted": win.attempted,
              "failed": win.attempted - ok, "metrics": metrics,
              "device": dev}
    if reduced is not None:
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["run"] = {
        "workload": workload, "seed": seed, "trace": int(trace),
        "lanes": n_lanes, "calls": len(kinds), "rounds": rounds,
        "frames": produced, "window_s": window_s, "call_s": call_s,
        "call_cpu_s": cpu_s, "check_s": check_s, "arena_bytes": arena_bytes,
        "program_peak_bytes": peak - arena_bytes,
        "nvcc_build_s": build.build_seconds, **spans,
        "card": card_info() if cuda else {}}
    result["compared"] = compared
    return result, compared
