"""CPU tests of the benchmark's files and arithmetic: the specification
against its contract, discovery by name, the lanes a seed makes, the
readers' formulas, the byte counter, and that nothing the benchmark runs
is the JAX package.

    python -m pytest benchmark/test_bench_layout.py
"""

from __future__ import annotations

import ast
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness, lanes, roofline

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# ---- the specification ------------------------------------------------------

def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] == "decode_fps"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    """Each cell's traffic, configuration, streams and metric readers are
    files found by the names in BENCHMARK.json, and agree with it."""
    entry = harness.cell(SPEC, cell)
    traffic = harness.load_part(BENCH, "workloads", entry["traffic"])
    config = harness.load_part(BENCH, "configs", entry["config"])
    assert traffic["config"] == entry["config"] == config["name"]
    assert traffic["chips"] == entry["chips"]
    assert traffic["why"] == entry["why"]
    for name in traffic["streams"]:
        s = lanes.load_stream(name)
        assert s.frames == len(s.structure)
        assert (-(-s.width // 16), -(-s.height // 16)) == \
            (config["mb_width"], config["mb_height"])
    for trace in (False, True):
        for m in harness.metrics_for(SPEC, cell, trace):
            assert callable(harness.reader(BENCH, m["name"]))


def test_new_files_found_without_edits(tmp_path):
    """A configuration, a cell and a metric added as new files, and named
    in BENCHMARK.json, are found; no existing file of the benchmark is
    edited (the copy's files are compared with the originals)."""
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "*.264"))
    before = {p.relative_to(root): p.read_bytes()
              for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "h264-new.json").write_text(json.dumps(
        {"name": "h264-new", "mb_width": 120, "mb_height": 68}))
    (root / "workloads" / "new-cell.json").write_text(json.dumps(
        {"config": "h264-new", "chips": 1, "why": "new",
         "streams": ["bench_broadcast_s0"], "lanes": 2, "output": "host"}))
    (root / "metrics" / "new_metric.py").write_text(
        "def read(w):\n    return 2.0 * w.frames\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "h264-new", "source": "x",
                            "file": "benchmark/configs/h264-new.json",
                            "reduced": [], "why": "new"})
    spec["workloads"].append({"name": "new-cell", "config": "h264-new",
                              "traffic": "new-cell", "chips": 1,
                              "why": "new"})
    spec["per_layer"].append({"name": "new_metric", "unit": "x",
                              "better": "lower", "source": "host_clock",
                              "layer": "new", "moves": "decode_fps",
                              "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    assert all((root / p).read_bytes() == b for p, b in before.items())

    got = harness.load_spec(root)
    assert harness.load_part(root, "workloads",
                             harness.cell(got, "new-cell")["traffic"])
    assert harness.load_part(root, "configs", "h264-new")["mb_width"] == 120
    names = [m["name"] for m in harness.metrics_for(got, "new-cell", True)]
    assert "new_metric" in names and "frame_gap_p95_ms" not in names
    assert "new_metric" not in [
        m["name"] for m in harness.metrics_for(got, SPEC["workloads"][0]
                                               ["name"], True)]
    win = harness.Window(**{**_WINDOW, "frames": 21})
    assert harness.reader(root, "new_metric")(win) == 42.0


# ---- the lanes a seed makes -------------------------------------------------

def _broadcast():
    return [lanes.load_stream(f"bench_broadcast_s{s}") for s in range(4)]


def test_lane_orders_set_by_seed_alone():
    a = lanes.lane_orders(4, 32, 3_000_000_001)
    assert a == lanes.lane_orders(4, 32, 3_000_000_001)
    assert a != lanes.lane_orders(4, 32, 3_000_000_002)
    # each lane takes every stream of the set once in any 4 calls
    assert all(sorted(o) == [0, 1, 2, 3] for o in a)
    # lanes side by side decode different streams, so a round mixes the
    # streams' different picture kinds
    streams = _broadcast()
    kinds = [streams[o[0]].structure for o in a]
    assert any(len(set(r)) > 1 for r in zip(*kinds))
    assert lanes.lane_orders(1, 4, 9) == [[0]] * 4


def test_call_streams_run_a_lane_order_back_to_back():
    streams = _broadcast()
    order = [2, 0, 3, 1]
    calls = [lanes.call_streams(streams, order, j, 2) for j in range(3)]
    assert [[s.name[-2:] for s in c] for c in calls] == \
        [["s2", "s0"], ["s3", "s1"], ["s2", "s0"]]
    # a joined call is the streams' bytes back to back: its pictures are
    # theirs, each stream from its own IDR
    joined = b"".join(s.data for s in calls[0])
    kinds, idr = lanes.structure(joined)
    assert kinds == streams[2].structure + streams[0].structure
    assert idr == [0, streams[2].frames]
    assert [s.name for s in lanes.call_streams([streams[0]], [0], 5, 3)] \
        == ["bench_broadcast_s0"] * 3


def test_warm_prefix_holds_every_kind():
    for s in _broadcast() + [lanes.load_stream("conf_c5")]:
        k = lanes.warm_pictures(s)
        assert set(s.structure[:k]) == set(s.structure)
        assert set(s.structure[:k - 1]) != set(s.structure)
        head = lanes.truncate(s.data, k)
        assert lanes.structure(head)[0] == s.structure[:k]
        assert s.data.startswith(head)


# ---- the readers ------------------------------------------------------------

_WINDOW = dict(output="device", seconds=30.0, setup_s=12.5,
               attempted=100, frames=100, frames_ok=100, rounds=50,
               host_parse_s=20.0, device_dispatch_s=5.0, emit_sync_s=0.0,
               upload_s=2.5, parse_released_s=16.0, gaps_s=None,
               picture_bytes=10 ** 9, trace=None)


def _read(name, **kw):
    return harness.reader(BENCH, name)(harness.Window(**{**_WINDOW, **kw}))


def test_decode_fps_is_all_right_frames_over_the_whole_window():
    assert _read("decode_fps") == 100 / 30.0
    assert _read("decode_fps", frames_ok=97) == 97 / 30.0
    assert _read("decode_fps", seconds=40.0) == 100 / 40.0
    assert _read("setup_s") == 12.5


def test_frame_gap_p95_is_over_all_samples():
    gaps = [0.001 * i for i in range(1, 201)]
    got = _read("frame_gap_p95_ms", gaps_s=gaps)
    assert abs(got - 1e3 * statistics.quantiles(
        gaps, n=20, method="inclusive")[-1]) < 1e-9
    # one far gap among 200 moves the p95 no more than the samples allow
    assert _read("frame_gap_p95_ms", gaps_s=gaps[:-1] + [100.0]) == got
    assert _read("frame_gap_p95_ms", gaps_s=None) is None


def test_per_round_and_per_frame_readers():
    assert _read("dispatch_ms_per_round") == 1e3 * (5.0 - 2.5) / 50
    assert _read("upload_ms_per_round") == 1e3 * 2.5 / 50
    assert _read("parse_ms_per_frame") == 1e3 * 20.0 / 100
    assert _read("gil_hold_pct") == 100.0 * 4.0 / 20.0
    assert _read("gil_hold_pct", parse_released_s=None) is None
    assert _read("emit_sync_ms_per_frame") is None
    assert _read("emit_sync_ms_per_frame", output="host",
                 emit_sync_s=0.3) == 3.0
    for name in ("kernel_ms_per_frame", "kernels_roofline_pct",
                 "device_idle_pct"):
        assert _read(name) is None
    tr = {"kernel_s": 0.5, "busy_s": 0.6, "window_s": 30.0}
    assert _read("kernel_ms_per_frame", trace=tr) == 5.0
    assert _read("device_idle_pct", trace=tr) == 100.0 * (1 - 0.6 / 30.0)
    assert _read("kernels_roofline_pct", trace=tr) == \
        100.0 * 1e9 / roofline.PEAK_BYTES_PER_S / 0.5
    assert _read("kernels_roofline_pct",
                 trace={**tr, "kernel_s": 0.0}) is None


def test_device_trace_reduction():
    from benchmark import devtrace
    ev = [("k1", 0, 10), ("MemcpyHtoD", 5, 20), ("k2", 50, 60),
          ("k1", 100, 130), ("k2", 125, 140)]
    r = devtrace.reduce_events([ev])
    assert r["kernel_s"] == (10 + 10 + 30 + 15) / 1e9
    assert r["busy_s"] == (20 + 10 + 40) / 1e9
    assert r["idle_gaps"] == [["before k1", 40 / 1e9], ["before k2", 30 / 1e9]]
    assert r["device_ops"][0] == ["k1", 40 / 1e9]
    assert devtrace.reduce_events([]) is None
    assert devtrace.reduce_events([[], []]) is None
    # a second session (the next decode call): its events add, and the
    # time between the sessions (the check, off the clock) is no gap
    r2 = devtrace.reduce_events([ev, [("k2", 10 ** 9, 10 ** 9 + 20),
                                      ("k1", 10 ** 9 + 50, 10 ** 9 + 60)]])
    assert r2["kernel_s"] == pytest.approx(r["kernel_s"] + 30 / 1e9)
    assert r2["busy_s"] == pytest.approx(r["busy_s"] + 30 / 1e9)
    assert [k for k, _ in r2["idle_gaps"]] == ["before k1", "before k2"]
    assert [v for _, v in r2["idle_gaps"]] == pytest.approx([70e-9, 30e-9])
    assert devtrace.short_name(
        "(anonymous namespace)::deblock_phase_kernel((anonymous namespace)"
        "::Args)") == "deblock_phase_kernel"
    assert devtrace.short_name(
        "void (anonymous namespace)::mc_luma_kernel<8>(unsigned char const*)"
    ) == "mc_luma_kernel"
    assert devtrace.short_name("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD (Pinned -> Device)"


# ---- the byte counter -------------------------------------------------------

def test_picture_bytes_by_hand():
    """One I, one P and one B picture of bench_broadcast_s0 (1920x1088,
    decode order IPPB...): the planes 1920 * 1088 + 2 * 960 * 544 =
    3,133,440 bytes written; a P or B picture also reads one reference
    area of that size."""
    s = lanes.load_stream("bench_broadcast_s0")
    assert (s.width, s.height) == (1920, 1088) and s.structure[:4] == "IPPB"
    i, p, b = (roofline.picture_bytes(s.width, s.height, k)
               for k in s.structure[0] + s.structure[1] + s.structure[3])
    assert i == 3_133_440
    assert p == 6_266_880
    assert b == 6_266_880
    with pytest.raises(ValueError):
        roofline.picture_bytes(1920, 1088, "S")
    assert roofline.roofline_pct(3_350_000, 1e-6) == pytest.approx(100.0)


# ---- no JAX -----------------------------------------------------------------

def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")))
def test_no_jax_import_by_top_level_name(path):
    found = _imports(BENCH / path) & set(harness.FORBIDDEN)
    assert not found, f"{path} imports {found}"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "arrow_h264_tpu_torch_x", sys)
    assert "arrow_h264_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "arrow_h264_tpu.api", sys)
    assert harness.forbidden_modules() == ["arrow_h264_tpu"]


def test_run_without_a_card_prints_nothing():
    """Without CUDA the command exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         SPEC["workloads"][0]["name"], "--seed", "3000000001", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, cwd=REPO,
        timeout=300)
    assert r.returncode != 0 and r.stdout == ""
