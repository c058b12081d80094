"""Throughput bench of the PyTorch port on one GPU.

    python -m arrow_h264_tpu_torch.bench [--stage NAME ...] [--batch B]
        [--streams qp26|broadcast|adversarial|uhd] [--order phase|raster]
        [--upload wire|dense] [--repeats R] [--out FILE.json]

The port's counterpart of the JAX package's `bench.py` and
`bench_host.py`, in one process.

--streams picks the committed streams (tests/data) that the lanes of
host_parse_fps, e2e_fps and e2e_device_resident_fps cycle through:

  qp26         (default) smoke_1080p_high, batch_1080p_s1..s3: 1920x1080,
               High/CABAC, qp 26, noise 3, 6/6/5/4 frames
               (tools/smoke_stream.py).
  broadcast    bench_broadcast_s0..s3: the JAX package's bench.py streams,
               1920x1088, High/CABAC, qp 30, noise 3, 12 frames, one IDR
               and 11 P/B pictures with 4 references (tools/bench_streams.py).
  adversarial  bench_adversarial as every lane: bench_host.py's worst-case
               bin density, 1920x1088, qp 26, noise 12, 8 frames.
  uhd          conf_c5 as every lane: 3840x2160, qp 26, 3 frames
               (tools/conformance_streams.py); run it with --batch 4.

Stages, in this order (default: all):

  host_parse_fps           the lanes' host pipeline with no device work:
                           parse, ABI pack, wire pack, spec merge and emit
                           (not with --upload dense), DPB commit with zero
                           planes, frames/s on one host thread; with the host library's GIL meter
                           on, gil_hold_pct (wall less the seconds inside
                           the library, over the wall) and
                           projected_fps_at_cores = min(cores x fps,
                           1 / GIL-held seconds a frame) for the cores of
                           the host that runs it.  A host metric.
  host_parse_adversarial_fps
                           the same over bench_adversarial alone, whatever
                           --streams says (bench_host.py's adversarial_*
                           numbers).  A host metric.
  d2h_link_GBps            one [B, 1088, 1920] uint8 tensor copied from the
                           card to pageable and to pinned host memory.
  e2e_fps                  BatchDecoder(B) over lanes that cycle through
                           the set's streams, frames out as numpy, host
                           clock; every frame's MD5 must equal the
                           stream's golden, and the frame count must be
                           exact.  The line also holds ms a round and the
                           last pass's lane stats a round (the lanes' sum
                           of host parse, device dispatch and output-copy
                           seconds, the main thread's upload).
  e2e_device_resident_fps  the same lanes with materialize=False: on_frame
                           takes each frame's int64 plane sums on the
                           device and drops the planes, with a sync every
                           B frames; the sums must equal those of the
                           frames that e2e_fps checked (or of one untimed
                           materialized pass).
  device_recon_fps         models.pipeline.decode_frames_batch_fn, inter,
                           on synthetic 1080p P ABIs (B lanes, 2 random
                           reference slots each);
  device_wildmv_fps        the same at min(8, B) lanes with 5 % of cells
                           given MVs in +-512 quarter samples, far outside
                           the picture;
  device_intra_fps         the same, intra only, on synthetic I ABIs.
                           The device stages time each of R calls with
                           CUDA events (the fps) and the host clock (both
                           printed: the plain stages are host-bound, and
                           the events then hold the host's enqueue gaps);
                           every call's output MD5 must equal the first's.

Before the timed passes each e2e stage decodes a prefix of every lane
(kernel builds), WARM_AUS pictures or one fewer than the shortest lane
has, so that it never decodes a whole stream (uhd's 3-picture lanes warm
up on 2); its pictures and seconds are in the line.

Each stage prints one JSON line (median, min and max over R, R, frames and
rounds where they apply, the stream set, its streams and kbit a frame,
order, upload, B and the card's nvidia-smi name and power limit); the
last line holds every stage's median by name (the host stages' GIL share
and projection too, the adversarial one's prefixed adversarial_), the
stream set, the card, the host's cores and the run's wall seconds.  Without a CUDA device every
stage but the two host stages exits non-zero: no device metric is
computed on the CPU.
A golden mismatch, a failed lane or a wrong frame count exits non-zero.
The stage functions take `device`, so the tests run them on the CPU at
small sizes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import platform
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .api import Decoder, crop_planes
from .bitstream.nal import split_annexb
from .host.centropy import gil_meter
from .models.pipeline import (
    ORDERS, UPLOADS, decode_frames_batch_fn, dpb_alloc, dpb_slots,
    store_refs_fn, upload_batch,
)
from .ops.synthetic import synthetic_abi, synthetic_abi_p
from .ops.transforms import make_ws_consts
from .ops.wire import emit_wire, merge_specs, pack_wire_raw
from .parallel.batch import BatchDecoder

DATA = Path(__file__).resolve().parent.parent / "tests" / "data"
# --streams: the set's streams (module docstring), each DATA/NAME.264 with
# its golden DATA/NAME.json
STREAM_SETS = {
    "qp26": ("smoke_1080p_high", "batch_1080p_s1", "batch_1080p_s2",
             "batch_1080p_s3"),
    "broadcast": tuple(f"bench_broadcast_s{s}" for s in range(4)),
    "adversarial": ("bench_adversarial",),
    "uhd": ("conf_c5",) * 4,
}
DEFAULT_STREAMS = "qp26"
STAGES = ("host_parse_fps", "host_parse_adversarial_fps", "d2h_link_GBps",
          "e2e_fps", "e2e_device_resident_fps", "device_recon_fps",
          "device_wildmv_fps", "device_intra_fps")
HOST_STAGES = ("host_parse_fps", "host_parse_adversarial_fps")
# the stages whose lanes cycle through the --streams set
LANE_STAGES = ("host_parse_fps", "e2e_fps", "e2e_device_resident_fps")
# the summary's prefix of each host stage's gil_hold_pct and
# projected_fps_at_cores (bench_host.py's adversarial_* names)
HOST_PREFIX = {"host_parse_fps": "", "host_parse_adversarial_fps":
               "adversarial_"}
BATCH = 32
WILDMV_BATCH = 8
REPEATS = 5
WARM_AUS = 3            # warm-up prefix: an I, a P and a B picture
MB_W, MB_H = 120, 68    # the synthetic stages' 1080p
N_SLOTS = 2             # reference slots of the synthetic inter stages
REF_SEED = 1


class BenchError(RuntimeError):
    """A stage's output is wrong: a golden mismatch, a failed lane, a wrong
    frame count or repeats that disagree."""


class Lane(NamedTuple):
    name: str
    data: bytes
    md5: list           # the golden MD5 of each frame, in output order


def load_lanes(paths) -> list[Lane]:
    """Streams and their committed goldens (STREAM.json `md5`)."""
    return [Lane(p.stem, p.read_bytes(),
                 json.loads(p.with_suffix(".json").read_text())["md5"])
            for p in map(Path, paths)]


def set_paths(name: str) -> list[Path]:
    """The stream files of the --streams set `name`."""
    return [DATA / f"{n}.264" for n in STREAM_SETS[name]]


def cycle_lanes(lanes, batch: int) -> list[Lane]:
    """`batch` lanes that cycle through `lanes`."""
    return [lanes[i % len(lanes)] for i in range(batch)]


def kbit_per_frame(lanes, frames: int) -> float:
    """The lanes' coded kbit over the frames they decode to."""
    return sum(8 * len(lane.data) for lane in lanes) / frames / 1e3


def truncate_aus(data: bytes, k: int) -> bytes:
    """The stream's first k access units (single-slice pictures): every
    NAL before the (k+1)-th slice NAL."""
    out, vcl = [], 0
    for ebsp in split_annexb(data):
        if ebsp[0] & 0x1F in (1, 5):
            vcl += 1
            if vcl > k:
                break
        out.append(b"\x00\x00\x00\x01" + ebsp)
    return b"".join(out)


def spread(values) -> dict:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values)}


def _sync(devices) -> None:
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def _release(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def gpu_info() -> dict:
    """The card as nvidia-smi names it: {"name", "power_limit"}."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def host_info() -> dict:
    """The host's CPU model and logical cores."""
    cpu = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next(ln.split(":", 1)[1].strip() for ln in f
                       if ln.startswith("model name"))
    except (OSError, StopIteration):
        pass
    return {"cpu": cpu, "cores": os.cpu_count()}


# ---- host ------------------------------------------------------------------

def _host_pass(lanes, upload: str) -> tuple[int, float, float]:
    """One pass of the lanes' host pipeline: (pictures, wall seconds,
    seconds inside the host library's calls)."""
    zeros: dict = {}
    n = 0
    gil_meter.reset()
    gil_meter.enabled = True
    try:
        t0 = time.perf_counter()
        for lane in lanes:
            dec = Decoder(device="cpu", entropy="cpp")
            if dec.entropy != "cpp":
                raise BenchError("the host entropy library did not load")
            dec.deferred_emit = True      # as a BatchDecoder lane
            for pic, poc in dec.parse_pictures(lane.data):
                mb_w = pic.sps.pic_width_in_mbs
                mb_h = pic.sps.pic_height_in_map_units
                abi = dec.pack_abi(pic, poc)
                if upload == "wire" and "wp" not in abi:
                    raw, spec = pack_wire_raw(abi, mb_w, mb_h)
                    # a batch merges its lanes' specs; one lane's is its own
                    emit_wire(raw, spec, merge_specs([spec]), mb_w * mb_h)
                if (mb_w, mb_h) not in zeros:
                    zeros[mb_w, mb_h] = (
                        torch.zeros((16 * mb_h, 16 * mb_w), dtype=torch.uint8),
                        *(torch.zeros((8 * mb_h, 8 * mb_w), dtype=torch.uint8)
                          for _ in range(2)))
                list(dec.commit(pic, poc, *zeros[mb_w, mb_h],
                                dpb_slots(pic.sps), lambda *a: None))
                n += 1
        wall = time.perf_counter() - t0
    finally:
        gil_meter.enabled = False
    return n, wall, gil_meter.released_s


def host_parse_fps(lanes, repeats: int = REPEATS,
                   upload: str = "wire") -> dict:
    """Stage host_parse_fps (module docstring) over `lanes`, one after
    another on this thread; upload="dense" leaves out the wire pack, as a
    BatchDecoder lane does."""
    host = host_info()
    fps, gil, proj = [], [], []
    for _ in range(repeats):
        n, wall, released = _host_pass(lanes, upload)
        held = max(wall - released, 1e-9)
        fps.append(n / wall)
        gil.append(100 * held / wall)
        proj.append(min(host["cores"] * n / wall, n / held))
    return {"stage": "host_parse_fps", "metric": "host_parse_fps",
            "unit": "frames/s on one host thread", **spread(fps),
            "repeats": repeats, "frames": n,
            "gil_hold_pct": spread(gil),
            "projected_fps_at_cores": spread(proj), "upload": upload,
            "streams": [lane.name for lane in lanes],
            "kbit_per_frame": kbit_per_frame(lanes, n), "host": host}


def host_parse_adversarial_fps(repeats: int = REPEATS, upload: str = "wire",
                               lanes=None) -> dict:
    """Stage host_parse_adversarial_fps: host_parse_fps over the adversarial
    set (`lanes`, default its committed stream)."""
    if lanes is None:
        lanes = load_lanes(set_paths("adversarial"))
    res = host_parse_fps(lanes, repeats, upload)
    return {**res, "stage": "host_parse_adversarial_fps",
            "metric": "host_parse_adversarial_fps",
            "stream_set": "adversarial"}


# ---- device->host link -----------------------------------------------------

def d2h_link_GBps(batch: int = BATCH, repeats: int = REPEATS,
                  device="cuda") -> dict:
    """Stage d2h_link_GBps: GB/s of one [batch, 1088, 1920] uint8 copy from
    the card, to pageable and to pinned host memory."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("d2h_link_GBps measures a CUDA device's link")
    x = torch.ones((batch, 1088, 1920), dtype=torch.uint8, device=device)
    pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    rates = {}
    for kind, copy in (("pageable", lambda: x.cpu()),
                       ("pinned", lambda: pinned.copy_(x))):
        copy()
        got = []
        for _ in range(repeats):
            _sync([device])
            t0 = time.perf_counter()
            copy()
            _sync([device])
            got.append(x.nbytes / (time.perf_counter() - t0) / 1e9)
        rates[kind] = spread(got)
    return {"stage": "d2h_link_GBps", "metric": "d2h_link_GBps",
            "unit": "GB/s, pinned", **rates["pinned"],
            "pageable": rates["pageable"], "repeats": repeats,
            "bytes": x.nbytes, "batch": batch}


# ---- end to end ------------------------------------------------------------

def _batch_pass(datas, device, order, upload, on_frame=None):
    """One BatchDecoder pass over `datas`, host-clocked from the call to
    the device's last work: (per-lane frames, seconds, rounds, the lanes'
    stats summed).  Raises on a failed lane."""
    materialize = on_frame is None
    with BatchDecoder(len(datas), device=device, order=order, upload=upload,
                      materialize=materialize, on_frame=on_frame) as bd:
        if any(d.entropy != "cpp" for d in bd.decoders):
            raise BenchError("the host entropy library did not load")
        _sync(bd.mesh)
        t0 = time.perf_counter()
        frames = bd.decode(datas)
        _sync(bd.mesh)
        dt = time.perf_counter() - t0
    for i, e in enumerate(bd.errors):
        if e is not None:
            raise BenchError(f"lane {i} failed: {e!r}")
    stats = {k: sum(st[k] for st in bd.stats) for k in (
        "host_parse_s", "device_dispatch_s", "emit_sync_s")}
    stats["upload_s"] = bd.upload_s
    return frames, dt, bd.rounds, stats


def _check_golden(lanes, frames) -> None:
    for i, (lane, fr) in enumerate(zip(lanes, frames)):
        md5 = [hashlib.md5(f.planar()).hexdigest() for f in fr]
        if len(md5) != len(lane.md5):
            raise BenchError(f"lane {i} ({lane.name}): {len(md5)} frames, "
                             f"golden {len(lane.md5)}")
        bad = [j for j, (a, b) in enumerate(zip(md5, lane.md5)) if a != b]
        if bad:
            raise BenchError(f"lane {i} ({lane.name}): MD5 differs from the "
                             f"golden at frames {bad}")


def plane_sums(frames) -> list[list[tuple]]:
    """Per lane, each materialized frame's int64 (y, cb, cr) sums."""
    return [[tuple(int(p.sum(dtype=np.int64)) for p in (f.y, f.cb, f.cr))
             for f in fr] for fr in frames]


def warm_aus(lanes) -> int:
    """The warm-up's prefix: WARM_AUS pictures, or one fewer than the
    shortest lane's frames (at least one), so that it never decodes a
    whole stream."""
    return max(1, min(WARM_AUS, min(len(lane.md5) for lane in lanes) - 1))


def _warm_up(lanes, device, order, upload, on_frame=None) -> dict:
    """A pass over each lane's first warm_aus(lanes) pictures (kernel
    builds), whose decoder is gone before the caller's allocates:
    {"aus", "frames", "seconds"}."""
    k = warm_aus(lanes)
    t0 = time.perf_counter()
    frames, _, _, _ = _batch_pass([truncate_aus(lane.data, k)
                                   for lane in lanes], device, order, upload,
                                  on_frame)
    secs = time.perf_counter() - t0
    n = sum(map(len, frames))
    want = sum(min(k, len(lane.md5)) for lane in lanes)
    if n != want:
        raise BenchError(f"warm-up: {n} frames, expected {want}")
    del frames
    _release(device)
    return {"aus": k, "frames": n, "seconds": secs}


def _e2e_result(stage, secs, n, rounds, lanes, order, upload, warm,
                stats) -> dict:
    return {"stage": stage, "metric": stage, "unit": "frames/s",
            **spread([n / s for s in secs]), "repeats": len(secs),
            "frames": n, "rounds": rounds, "seconds": spread(secs),
            "ms_per_round": spread([1e3 * s / rounds for s in secs]),
            "streams": sorted({lane.name for lane in lanes}),
            "kbit_per_frame": kbit_per_frame(lanes, n), "batch": len(lanes),
            "order": order, "upload": upload, "warm_up": warm,
            # the last pass's lane stats a round: host parse and pack (the
            # lanes' sum, run on pool_threads at once), device dispatch,
            # output copies, and the main thread's upload
            "stats_ms_per_round": {k.removesuffix("_s") + "_ms":
                                   1e3 * v / rounds for k, v in stats.items()},
            "pool_threads": max(1, min(len(lanes), os.cpu_count() or 1))}


def e2e_fps(lanes, batch: int = BATCH, repeats: int = REPEATS,
            device="cuda", order: str = "phase",
            upload: str = "wire") -> tuple[dict, list]:
    """Stage e2e_fps over `batch` lanes cycling through `lanes`: (result,
    the frames' plane_sums of the last pass)."""
    lanes = cycle_lanes(lanes, batch)
    warm = _warm_up(lanes, device, order, upload)
    secs = []
    for _ in range(repeats):
        frames, dt, rounds, stats = _batch_pass(
            [lane.data for lane in lanes], device, order, upload)
        secs.append(dt)
        _check_golden(lanes, frames)
        sums = plane_sums(frames)
        n = sum(map(len, frames))
        del frames
        _release(device)
    return _e2e_result("e2e_fps", secs, n, rounds, lanes, order, upload,
                       warm, stats), sums


def e2e_device_resident_fps(lanes, batch: int = BATCH,
                            repeats: int = REPEATS, device="cuda",
                            order: str = "phase", upload: str = "wire",
                            expect: list | None = None) -> dict:
    """Stage e2e_device_resident_fps.  expect: the plane_sums of the same
    lanes' materialized frames (e2e_fps's); None makes one untimed
    materialized pass, checked against the goldens, for them."""
    lanes = cycle_lanes(lanes, batch)
    sums: list = []

    def consume(lane, f):
        y, cb, cr = crop_planes(f.sps, f.y, f.cb, f.cr)
        s = torch.stack([p.sum(dtype=torch.int64) for p in (y, cb, cr)])
        sums.append(s)
        if len(sums) % batch == 0:
            # back-pressure: without the copies the host would queue
            # rounds ahead of the device without bound
            _sync([s.device])
        return s

    warm = _warm_up(lanes, device, order, upload, consume)
    if expect is None:
        frames, _, _, _ = _batch_pass([lane.data for lane in lanes], device,
                                      order, upload)
        _check_golden(lanes, frames)
        expect = plane_sums(frames)
        del frames
        _release(device)
    secs = []
    for _ in range(repeats):
        sums.clear()
        frames, dt, rounds, stats = _batch_pass(
            [lane.data for lane in lanes], device, order, upload, consume)
        secs.append(dt)
        got = [[tuple(s.tolist()) for s in fr] for fr in frames]
        if got != expect:
            bad = [i for i, (a, b) in enumerate(zip(got, expect)) if a != b]
            raise BenchError(f"device-resident plane sums differ from the "
                             f"materialized frames' in lanes {bad}")
        n = sum(map(len, frames))
        del frames
        _release(device)
    return _e2e_result("e2e_device_resident_fps", secs, n, rounds, lanes,
                       order, upload, warm, stats)


# ---- device reconstruction on synthetic pictures -----------------------------

def synthetic_lanes(kind: str, batch: int, mb_w: int = MB_W,
                    mb_h: int = MB_H) -> list[dict]:
    """Host ABIs of a device stage: "recon" synthetic_abi_p(seed=i), "intra"
    synthetic_abi(seed=i), "wildmv" synthetic_abi_p(seed=50+i) with 5 % of
    cells given MVs in [-512, 512) quarter samples (the JAX package's
    bench.py device_patch_fps inputs)."""
    if kind == "intra":
        return [synthetic_abi(mb_w, mb_h, seed=i) for i in range(batch)]
    if kind == "recon":
        return [synthetic_abi_p(mb_w, mb_h, seed=i, n_slots=N_SLOTS)
                for i in range(batch)]
    if kind != "wildmv":
        raise ValueError(f"synthetic lanes {kind!r}")
    out = []
    for i in range(batch):
        abi = synthetic_abi_p(mb_w, mb_h, seed=50 + i, n_slots=N_SLOTS)
        rng = np.random.default_rng(77 + i)
        n = mb_w * mb_h
        wild = rng.random((n, 4, 4)) < 0.05
        wmv = rng.integers(-512, 512, (n, 4, 4, 2, 2)).astype(np.int32)
        abi["mv"] = np.where(wild[..., None, None], wmv, abi["mv"])
        out.append(abi)
    return out


def reference_planes(batch: int, mb_w: int, mb_h: int,
                     seed: int = REF_SEED) -> tuple:
    """Random reference pictures of the synthetic inter stages: y [B,
    N_SLOTS, H, W], cb, cr [B, N_SLOTS, H/2, W/2] uint8 (numpy)."""
    rng = np.random.default_rng(seed)
    H, W = 16 * mb_h, 16 * mb_w
    return (rng.integers(0, 256, (batch, N_SLOTS, H, W), np.uint8),
            *(rng.integers(0, 256, (batch, N_SLOTS, H // 2, W // 2),
                           np.uint8) for _ in range(2)))


def reference_dpb(planes, mb_w: int, mb_h: int, device):
    """The DPBs [B, N_SLOTS, ...] holding reference_planes, stored slot by
    slot with store_refs_fn."""
    y, cb, cr = (torch.from_numpy(p).to(device) for p in planes)
    B = y.shape[0]
    dy, dc = dpb_alloc(mb_w, mb_h, B * N_SLOTS, device)
    dy, dc = (t.view((B, N_SLOTS) + t.shape[1:]) for t in (dy, dc))
    for s in range(N_SLOTS):
        store_refs_fn(dy, dc, list(range(B)), [s] * B, y[:, s], cb[:, s],
                      cr[:, s])
    return dy, dc


def _timed_call(fn, device):
    """(fn's result, CUDA-event ms or None off the card, host ms) of one
    call, started on an idle device and ended when its work is done."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, None, 1e3 * (time.perf_counter() - t0)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        host = 1e3 * (time.perf_counter() - t0)
    return out, start.elapsed_time(end), host


def _planes_md5(planes) -> str:
    h = hashlib.md5()
    for p in planes:
        h.update(p.cpu().numpy().tobytes())
    return h.hexdigest()


def device_fps(kind: str, batch: int = BATCH, repeats: int = REPEATS,
               device="cuda", order: str = "phase", mb_w: int = MB_W,
               mb_h: int = MB_H) -> dict:
    """Stage device_{kind}_fps (kind: recon, wildmv, intra): R calls of
    decode_frames_batch_fn on synthetic_lanes after one warm-up call; the
    fps is from the CUDA events of each call."""
    device = torch.device(device)
    inter = kind != "intra"
    abi = upload_batch(synthetic_lanes(kind, batch, mb_w, mb_h), device)
    if inter:
        dpb_y, dpb_c = reference_dpb(reference_planes(batch, mb_w, mb_h),
                                     mb_w, mb_h, device)
    else:
        dpb_y, dpb_c = (t[None].expand((batch,) + t.shape)
                        for t in dpb_alloc(mb_w, mb_h, 1, device))
    ws4, ws8 = (t.to(device) for t in make_ws_consts([[16] * 16] * 6,
                                                     [[16] * 64] * 2))

    def call():
        return decode_frames_batch_fn(abi, dpb_y, dpb_c, mb_w=mb_w,
                                      mb_h=mb_h, ws4=ws4, ws8=ws8,
                                      cqp_off=(0, 0), inter=inter,
                                      order=order)

    first, _, _ = _timed_call(call, device)
    want = _planes_md5(first)
    del first
    ev_ms, host_ms = [], []
    for r in range(repeats):
        out, ev, host = _timed_call(call, device)
        if _planes_md5(out) != want:
            raise BenchError(f"device_{kind}_fps: repeat {r}'s output "
                             "differs from the first call's")
        del out
        ev_ms.append(ev)
        host_ms.append(host)
    del abi, dpb_y, dpb_c
    _release(device)
    stage = f"device_{kind}_fps"
    res = {"stage": stage, "metric": stage, "unit": "frames/s",
           "fps_from": "CUDA events around each call" if ev_ms[0] is not None
           else "host clock (no CUDA device)", "repeats": repeats,
           "batch": batch, "mb": [mb_w, mb_h], "order": order,
           "upload": "dense, untimed (upload_batch)",
           "host_ms": spread(host_ms), "output_md5": want}
    ms = host_ms if ev_ms[0] is None else ev_ms
    res.update(spread([1e3 * batch / m for m in ms]))
    if ev_ms[0] is not None:
        res["event_ms"] = spread(ev_ms)
    return res


# ---- command line ------------------------------------------------------------

def run(stages, stream_set: str, batch: int, repeats: int, order: str,
        upload: str, gpu: dict | None) -> list[dict]:
    """Run `stages` (in STAGES order) over the --streams set `stream_set`
    on the card `gpu` (of gpu_info) and print each one's result line."""
    lanes = load_lanes(set_paths(stream_set))
    results, sums = [], None
    for name in (s for s in STAGES if s in stages):
        if name == "host_parse_fps":
            res = host_parse_fps(lanes, repeats, upload)
        elif name == "host_parse_adversarial_fps":
            res = host_parse_adversarial_fps(repeats, upload)
        elif name == "d2h_link_GBps":
            res = d2h_link_GBps(batch, repeats)
        elif name == "e2e_fps":
            res, sums = e2e_fps(lanes, batch, repeats, "cuda", order, upload)
        elif name == "e2e_device_resident_fps":
            res = e2e_device_resident_fps(lanes, batch, repeats, "cuda",
                                          order, upload, sums)
        else:
            kind = name[len("device_"):-len("_fps")]
            res = device_fps(kind, min(batch, WILDMV_BATCH)
                             if kind == "wildmv" else batch, repeats,
                             "cuda", order)
        if name in LANE_STAGES:
            res["stream_set"] = stream_set
        if name not in HOST_STAGES:
            res["device"] = gpu
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


def summary(results, order: str, upload: str, batch: int, repeats: int,
            stream_set: str = DEFAULT_STREAMS) -> dict:
    """The last line: each stage's median by name (each host stage's three
    metrics, the adversarial one's prefixed adversarial_), the stream set,
    the card and the host."""
    med = {}
    for r in results:
        med[r["metric"]] = r["median"]
        for k in ("gil_hold_pct", "projected_fps_at_cores"):
            if k in r:
                med[HOST_PREFIX[r["metric"]] + k] = r[k]["median"]
    return {"medians": med, "stream_set": stream_set, "order": order,
            "upload": upload, "batch": batch, "repeats": repeats,
            "device": next((r["device"] for r in results if "device" in r),
                           None),
            "host_cores": os.cpu_count()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m arrow_h264_tpu_torch.bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", action="append", choices=STAGES,
                    help="a stage to run (repeatable; default all)")
    ap.add_argument("--batch", type=int, default=BATCH, metavar="B")
    ap.add_argument("--streams", choices=STREAM_SETS, default=DEFAULT_STREAMS,
                    help="the stream set the lanes cycle through (default "
                    f"{DEFAULT_STREAMS})")
    ap.add_argument("--order", choices=sorted(ORDERS), default="phase")
    ap.add_argument("--upload", choices=UPLOADS, default="wire")
    ap.add_argument("--repeats", type=int, default=REPEATS, metavar="R")
    ap.add_argument("--out", type=Path, help="write every line as JSON here")
    args = ap.parse_args(argv)
    if args.batch < 1 or args.repeats < 1:
        ap.error("--batch and --repeats must be at least 1")
    stages = args.stage or list(STAGES)
    need = [s for s in stages if s not in HOST_STAGES]
    if need and not torch.cuda.is_available():
        sys.exit(f"bench: {', '.join(need)} need a CUDA device, and "
                 "torch.cuda.is_available() is False; only "
                 f"{' and '.join(HOST_STAGES)} run without one")
    t0 = time.perf_counter()
    try:
        results = run(stages, args.streams, args.batch, args.repeats,
                      args.order, args.upload, gpu_info() if need else None)
    except BenchError as e:
        sys.exit(f"bench: {e}")
    last = summary(results, args.order, args.upload, args.batch,
                   args.repeats, args.streams)
    # the stages' wall seconds, kernel builds included: what a cell costs
    last["run_s"] = time.perf_counter() - t0
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"stages": results, "summary": last},
                                       indent=1) + "\n")
    print(json.dumps(last))


if __name__ == "__main__":
    main()
