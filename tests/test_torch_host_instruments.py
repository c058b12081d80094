"""The instruments of the port's host entropy library (host/centropy.py):
the GIL meter, the stats build (ARROW_H264_STATS=1) and the sanitizer
build (ARROW_H264_SANITIZE=1).

The builds are chosen by environment variables that load_lib reads, and
a process keeps the library it loaded, so each build other than the
normal one runs in a subprocess of its own; the module's fixture starts
them together.  The stats build's counters are held to the JAX package's
stats build on the same stream; the sanitizer build decodes a stream
under the ASAN runtime with no report.
"""

import hashlib
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from arrow_h264_tpu_torch.api import Decoder
from arrow_h264_tpu_torch.host import centropy
from arrow_h264_tpu_torch.parallel.batch import BatchDecoder

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "arrow_h264_tpu_torch"
DATA = REPO / "tests" / "data"
# High profile, CABAC, B pictures and weighted prediction: every section
# of the stats build's counters runs
STREAM = DATA / "batch_qcif_s3.264"
BATCH = [DATA / f"batch_qcif_s{i}.264" for i in (1, 2, 3, 4)]
ASAN_OPTIONS = ("detect_leaks=0:detect_odr_violation=0:"
                "detect_container_overflow=0")
# the t_* section timers that the C sources add to (t_scatter is declared
# but nothing adds to it, in either package's copy)
TIMED = ("t_resid", "t_motion", "t_total", "t_skip", "t_tail", "t_imb",
         "t_presid")


def _golden(path: Path) -> list:
    return json.loads(path.with_suffix(".json").read_text())["md5"]


@pytest.fixture
def meter():
    """gil_meter, left disabled and cleared afterwards."""
    m = centropy.gil_meter
    m.reset()
    yield m
    m.enabled = False
    m.reset()


def test_gil_meter_single_stream(meter):
    """Disabled, the meter adds nothing across a decode; enabled, it sums
    the library's calls, and those of the parse lie within the decode's
    host_parse_s; reset() clears it.  The wire pack's scans run in the
    upload (device_dispatch_s) and h264e_build_col in the DPB commit, so
    released_s in all is held to the decode's wall only: at 1080p on an
    H100's host it came out above host_parse_s."""
    data = STREAM.read_bytes()
    dec = Decoder(device="cpu")
    assert dec.entropy == "cpp"
    assert [hashlib.md5(f.planar()).hexdigest()
            for f in dec.decode_annexb(data)] == _golden(STREAM)
    assert meter.released_s == 0.0 and meter.calls == {}

    meter.enabled = True
    dec = Decoder(device="cpu")
    t = time.perf_counter()
    frames = list(dec.decode_annexb(data))
    wall = time.perf_counter() - t
    assert len(frames) == 5
    calls = dict(meter.calls)
    assert {"h264e_parse_slice", "h264e_reset_pic", "h264e_build_col",
            "h264e_scan_inter"} <= set(calls)
    assert calls.keys() & {"h264e_scan_blocks8", "h264e_gather_blocks8"}
    assert math.isclose(meter.released_s, math.fsum(calls.values()),
                        rel_tol=1e-12)
    parse = calls["h264e_parse_slice"] + calls["h264e_reset_pic"]
    assert 0 < parse <= dec.stats.host_parse_s
    assert parse < meter.released_s < wall
    meter.reset()
    assert meter.released_s == 0.0 and meter.calls == {}


def test_gil_meter_pool_sum_is_whole(meter, monkeypatch):
    """Through BatchDecoder's pool the lock-protected sum equals the sum
    of every call's time, recorded by a wrapper, with the interpreter
    switching threads as often as it can."""
    record = []
    add = centropy.gil_meter.add

    def recording_add(dt, name="other"):
        record.append((dt, name, threading.get_ident()))
        add(dt, name)

    monkeypatch.setattr(centropy.gil_meter, "add", recording_add)
    meter.enabled = True
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with BatchDecoder(4, device="cpu") as bd:
            outs = bd.decode([p.read_bytes() for p in BATCH])
    finally:
        sys.setswitchinterval(interval)
    assert bd.errors == [None] * 4
    for p, frames in zip(BATCH, outs):
        assert [hashlib.md5(f.planar()).hexdigest()
                for f in frames] == _golden(p)
    assert len({tid for *_, tid in record}) > 1      # the pool's threads
    assert math.isclose(meter.released_s, math.fsum(r[0] for r in record),
                        rel_tol=1e-12)
    for name, s in meter.calls.items():
        assert math.isclose(s, math.fsum(r[0] for r in record
                                         if r[1] == name), rel_tol=1e-12)


def test_gil_meter_threaded_stress(meter):
    """More threads than cores add at once: no update is lost (dt is a
    power of two, so every order of the additions gives the exact sum)."""
    n_threads, n_adds, dt = 4 * (os.cpu_count() or 1), 2000, 2.0 ** -20

    def work():
        for _ in range(n_adds):
            meter.add(dt, "stress")

    meter.enabled = True
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert meter.released_s == n_threads * n_adds * dt
    assert meter.calls == {"stress": n_threads * n_adds * dt}


# Host half of a decode on one thread (parse, pack, DPB commit with
# placeholder planes) through the port or the JAX package; prints the
# stats build's counters, the library's file and the shared objects the
# process mapped.
_STATS_RUN = r"""
import json, sys
import numpy as np
data = open(sys.argv[2], "rb").read()
if sys.argv[1] == "port":
    import torch
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.host import centropy
    dec, zeros = Decoder(device="cpu"), lambda s: torch.zeros(
        s, dtype=torch.uint8)
else:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from arrow_h264_tpu.api import Decoder
    from arrow_h264_tpu.host import centropy
    dec, zeros = Decoder(entropy="cpp"), lambda s: np.zeros(s, np.uint8)
assert dec.entropy == "cpp"
n = 0
for pic, poc in dec.parse_pictures(data):
    dec.pack_abi(pic, poc)
    H, W = pic.mb_h * 16, pic.mb_w * 16
    n_slots = max(2, min(pic.sps.max_num_ref_frames, 32) + 1)
    list(dec.commit(pic, poc, zeros((H, W)), zeros((H // 2, W // 2)),
                    zeros((H // 2, W // 2)), n_slots, lambda *a: None))
    n += 1
    mbs = pic.mb_w * pic.mb_h
maps = open("/proc/self/maps").read().split()
print(json.dumps({"stats": centropy.read_stats(), "pictures": n, "mbs": mbs,
                  "lib": centropy.load_lib()._name,
                  "so": sorted({m for m in maps if ".so" in m}),
                  "jax_pkg": [m for m in sys.modules
                              if m.split(".")[0] == "arrow_h264_tpu"]}))
"""

# A whole decode through the port's Decoder on a device (argv[2]) under
# the ASAN runtime: MD5s, to hold against the golden
_ASAN_RUN = r"""
import hashlib, json, sys
from arrow_h264_tpu_torch.api import Decoder
from arrow_h264_tpu_torch.host import centropy
dec = Decoder(device=sys.argv[2])
assert dec.entropy == "cpp", dec.entropy
md5 = [hashlib.md5(f.planar()).hexdigest()
       for f in dec.decode_annexb(open(sys.argv[1], "rb").read())]
maps = open("/proc/self/maps").read().split()
print(json.dumps({"md5": md5, "lib": centropy.load_lib()._name,
                  "so": sorted({m for m in maps if ".so" in m})}))
"""


def _asan_env(options: str = ASAN_OPTIONS) -> dict:
    """The environment of a process under the ASAN runtime that loads the
    sanitizer build."""
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    return _env(LD_PRELOAD=asan, ARROW_H264_SANITIZE="1",
                ASAN_OPTIONS=options)


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "ARROW_H264_"))}
    env["PYTHONPATH"] = str(REPO)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def variants():
    """The stats build through the port and through the JAX package, and
    the sanitizer build through the port, started together (each builds
    its library on first use); {name: (returncode, stdout, stderr)}."""
    runs = {
        "stats_port": ([_STATS_RUN, "port", str(STREAM)],
                       _env(ARROW_H264_STATS="1")),
        "stats_jax": ([_STATS_RUN, "jax", str(STREAM)],
                      _env(ARROW_H264_STATS="1", JAX_PLATFORMS="cpu")),
        "asan": ([_ASAN_RUN, str(STREAM), "cpu"], _asan_env()),
    }
    procs = {k: subprocess.Popen([sys.executable, "-c", *args], cwd=REPO,
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, (args, env) in runs.items()}
    out = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            out[k] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            p.kill()
    return out


def _result(variants, name) -> dict:
    rc, stdout, stderr = variants[name]
    assert rc == 0, (name, stderr[-4000:])
    return json.loads(stdout.strip().splitlines()[-1])


def _built_in_port(out: dict, stem: str) -> None:
    """The variant's library is built in the port's _build/, and nothing
    is loaded from the repository's cpp/."""
    lib = Path(out["lib"])
    assert lib.parent == PORT / "_build" and lib.exists()
    assert lib.name.startswith(stem + "_")
    assert not [s for s in out["so"]
                if Path(s).resolve().parent == REPO / "cpp"]


def test_stats_build_counts_equal_jax_package(variants):
    """read_stats() of the port's stats build equals the JAX package's on
    the same stream, one thread, for every count; mbs is MBs x pictures;
    the section timers ran."""
    port, ref = _result(variants, "stats_port"), _result(variants,
                                                         "stats_jax")
    _built_in_port(port, "libh264entropy_stats")
    assert port["jax_pkg"] == []
    assert list(port["stats"]) == list(centropy._STATS_FIELDS)
    assert port["pictures"] == ref["pictures"] == 5
    counts = ("decisions", "bypasses", "blocks", "coeffs", "mbs",
              "sig_iters")
    for k in counts:
        assert port["stats"][k] == ref["stats"][k], k
    assert port["stats"]["mbs"] == port["mbs"] * port["pictures"] == 99 * 5
    assert all(port["stats"][k] > 0 for k in counts)
    for k in TIMED:
        assert port["stats"][k] > 0, k
    assert port["stats"]["t_scatter"] == ref["stats"]["t_scatter"] == 0


def _clean_asan_decode(variants, name: str, stream: Path) -> None:
    out = _result(variants, name)
    stderr = variants[name][2]
    assert "Sanitizer" not in stderr and "runtime error" not in stderr, \
        stderr[-4000:]
    _built_in_port(out, "libh264entropy_asan")
    assert any(Path(s).name.startswith("libasan") for s in out["so"])
    assert out["md5"] == _golden(stream)


def test_sanitizer_build_decodes_clean(variants):
    """The ASAN/UBSAN build decodes a stream through Decoder(device="cpu")
    with no sanitizer report, every frame equal to the golden."""
    _clean_asan_decode(variants, "asan", STREAM)


@pytest.mark.cuda
def test_sanitizer_build_decodes_clean_cuda():
    """On the card: the ASAN/UBSAN build parses the 1080p High smoke
    stream for Decoder(device="cuda"), with no sanitizer report, every
    frame equal to the golden.  protect_shadow_gap=0 lets CUDA map the
    address range that ASAN would otherwise protect."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    smoke = DATA / "smoke_1080p_high.264"
    r = subprocess.run([sys.executable, "-c", _ASAN_RUN, str(smoke), "cuda"],
                       cwd=REPO, env=_asan_env(ASAN_OPTIONS
                                               + ":protect_shadow_gap=0"),
                       capture_output=True, text=True, timeout=900)
    _clean_asan_decode({"cuda": (r.returncode, r.stdout, r.stderr)}, "cuda",
                       smoke)

