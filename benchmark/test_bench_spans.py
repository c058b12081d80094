"""CPU tests of the span report (benchmark/span_report.py over
benchmark/spanread.py): a traced QCIF cell's report reads the port's
spans, a run of benchmark/run.py's own (traced or not) leaves the
recorder off and empty, a program without the recorder leaves the report
without spans, and the idle attribution, frame gaps, window split, clock
re-anchoring and pool maps by hand.

    python -m pytest benchmark/test_bench_spans.py
"""

from __future__ import annotations

import sys
import time

import pytest

from benchmark import benchkit, devtrace, harness, span_report, spanread
from arrow_h264_tpu_torch.spans import Span, recorder

SPAN_READINGS = {"parse_wait_ms_per_round", "commit_ms_per_round",
                 "frame_out_gap_p95_ms", "idle_in_parse_pct"}
SEED = 2 ** 31 + 29


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    goldens = {n: benchkit.qcif_golden(n) for n in benchkit.QCIF_STREAMS}
    return benchkit.make_root(tmp_path_factory.mktemp("bench"), goldens)


def _run(root, cell, trace):
    res, _ = harness.run_cell(cell, SEED, 1.0, trace, time.perf_counter(),
                              device="cpu", root=root)
    assert res["correct"]
    return res


@pytest.mark.parametrize("cell", [benchkit.QCIF_CELL, benchkit.QCIF_HOST_CELL])
def test_report_reads_the_spans(root, cell):
    inner = devtrace.device_events
    rep = span_report.report(cell, SEED, 1.0, device="cpu", root=root)
    assert rep["correct"]
    got = rep["spans"]
    assert set(got) == SPAN_READINGS | {"idle_in_parse_pct_realigned"}
    # no device trace on the CPU: the idle readings stay silent
    assert got["idle_in_parse_pct"] is None
    assert got["idle_in_parse_pct_realigned"] is None
    assert rep["clock"] is None
    assert 0 < got["commit_ms_per_round"] < got["parse_wait_ms_per_round"]
    assert got["frame_out_gap_p95_ms"] > 0
    assert rep["rounds"] == rep["run"]["rounds"] > 0
    rm = rep["round_ms"]
    assert got["commit_ms_per_round"] > 0 and rm["commit"] > 0
    assert rep["coverage"]["least"] > 0.9
    assert "setup.device_state" in rep["setup_spans"]
    # the harness's own metrics are the traced run's, the spans not among
    assert not SPAN_READINGS & set(rep["metrics"])
    assert "parse_ms_per_frame" in rep["metrics"]
    # the pool's spans under the waits, and the rounds' counters
    pool = rep["pool"]
    assert set(pool) >= {"parse_first", "pack_wait", "parse_wait",
                         "upload.emit"}
    for p in pool.values():
        assert p["longest_lane_ms"] <= p["lanes_ms"]
        assert p["busiest_thread_ms"] <= p["wall_ms"] * 1.001
        assert 0 < p["busy_pct"] <= 100.1
    attrs = rep["round_attrs"]
    assert attrs["live"] == 4 and set(attrs["rounds_by_upload"]) == {"wire"}
    assert attrs["bytes_per_round"] > 0 and attrs["copy_gb_s"] > 0
    assert rep["cost"]["add_ns"] > 0
    # the report leaves the program and the harness as it found them
    assert not recorder.enabled and recorder.drain() == []
    assert devtrace.device_events is inner


@pytest.mark.parametrize("trace", [False, True])
def test_benchmark_runs_record_nothing(root, trace):
    """benchmark/run.py's own runs leave the recorder off, traced or not:
    the per-layer metrics are read from a run without spans."""
    recorder.disable()
    recorder.drain()
    res = _run(root, benchkit.QCIF_CELL, trace)
    assert not SPAN_READINGS & set(res["metrics"])
    if not trace:
        assert set(res["metrics"]) == {"decode_fps", "setup_s"}
    assert not recorder.enabled and recorder.drain() == []


def test_without_the_recorder_the_report_has_no_spans(root, monkeypatch):
    """A program without arrow_h264_tpu_torch.spans (its import fails):
    the run completes, correct, and the report's spans are None."""
    monkeypatch.setitem(sys.modules, "arrow_h264_tpu_torch.spans", None)
    rep = span_report.report(benchkit.QCIF_CELL, SEED, 1.0, device="cpu",
                             root=root)
    assert rep["correct"] and rep["spans"] is None
    assert "parse_ms_per_frame" in rep["metrics"]


def _span(name, sid, parent, t0, t1, call=1, rnd=-1, lane=-1, attrs=None,
          thread=7):
    return Span(name, sid, parent, call, rnd, lane, thread, t0, t1, attrs)


def _trace(sessions):
    spans = [_span("decode", 1, 0, 0, 100),
             _span("round", 2, 1, 0, 100, rnd=0, attrs={"live": 2}),
             _span("pack_wait", 3, 2, 0, 30, rnd=0),
             _span("step", 4, 2, 30, 70, rnd=0),
             _span("parse_wait", 5, 2, 70, 100, rnd=0),
             _span("frame_out", 6, 2, 40, 40, rnd=0, lane=0),
             _span("frame_out", 7, 2, 90, 90, rnd=0, lane=0),
             _span("frame_out", 8, 2, 95, 95, rnd=0, lane=1),
             _span("frame_out", 9, 1, 99, 99, lane=0)]
    return spanread.Trace(spans, [], sessions, main=7)


def test_idle_attribution_by_hand():
    """The card busy at 10-20 (a kernel and a copy inside it) and 50-60:
    idle 0-10, 20-50, 60-100 (80 ns): 20 of them in pack_wait, 30 in
    step, 30 in parse_wait."""
    tr = _trace([[("k", 10, 20), ("Memcpy HtoD", 12, 15), ("k", 50, 60)]])
    assert tr.idle() == [(0, 10), (20, 50), (60, 100)]
    assert tr.idle_in("pack_wait") == 20e-9
    assert tr.idle_in(*spanread.PARSE_WAITS) == 50e-9
    assert tr.idle_in("step") == 30e-9
    assert spanread.idle_in_parse_pct(tr) == pytest.approx(62.5)
    assert tr.rounds == 1
    assert spanread.parse_wait_ms_per_round(tr) == pytest.approx(60e-6)
    assert spanread.overlap([(0, 5), (8, 12)], [(4, 9), (11, 20)]) == 3
    assert _trace(None).idle() is None
    assert spanread.idle_in_parse_pct(_trace(None)) is None


def test_frame_out_gaps_within_a_lane_and_call():
    assert sorted(_trace(None).frame_out_gaps_ms()) == [9e-6, 50e-6]


def test_window_must_match_the_rounds():
    warm = [_span("decode", 20, 0, -50, -10, call=0),
            _span("setup.device_state", 21, 22, -45, -40, call=0)]
    spans = warm + _trace(None).spans
    tr = spanread.split(spans, [], 1)
    assert tr.rounds == 1 and tr.sessions is None
    assert [s.name for s in tr.setup] == ["setup.device_state"]
    assert spanread.split(spans, [], 2) is None
    assert spanread.split(spans[2:], [], 1) is None
    # a device session for each window call, or nothing is read
    assert spanread.split(spans, [[], []], 1) is None


def test_realigned_by_hand():
    """Two rounds whose first copies start 10 and 40 ns after their
    upload.copy spans: the median skew is 25, so the first round's events
    move 15 later and the second's 15 earlier; both then read 25."""
    spans = [_span("decode", 1, 0, 0, 1000),
             _span("round", 2, 1, 0, 500, rnd=0, attrs={"live": 1}),
             _span("upload.copy", 3, 2, 100, 120, rnd=0),
             _span("round", 4, 1, 500, 1000, rnd=1, attrs={"live": 1}),
             _span("upload.copy", 5, 4, 600, 620, rnd=1)]
    tr = spanread.Trace(spans, [], [[("Memcpy HtoD", 110, 130),
                                     ("k", 200, 210),
                                     ("Memcpy HtoD", 640, 650)]], main=7)
    assert spanread.skews(tr) == [(1, 0, 10), (1, 1, 40)]
    moved = spanread.realigned(tr)
    assert moved.sessions == [[("Memcpy HtoD", 125, 145), ("k", 215, 225),
                               ("Memcpy HtoD", 625, 635)]]
    assert spanread.skews(moved) == [(1, 0, 25), (1, 1, 25)]
    assert spanread.realigned(_trace(None)).sessions is None


def test_pool_maps_by_hand():
    """pack_wait 0-30: thread 8 runs lanes 0 (0-10) and 1 (10-20), thread
    9 lane 2 (0-25): 45 lane-ns over 2 threads x 30, busiest thread 25."""
    tr = _trace(None)
    tr.spans += [_span("lane.pack", 10, 3, 0, 10, rnd=0, lane=0, thread=8),
                 _span("lane.pack", 11, 3, 10, 20, rnd=0, lane=1, thread=8),
                 _span("lane.pack", 12, 3, 0, 25, rnd=0, lane=2, thread=9)]
    pool = spanread.pool_maps(tr)
    assert set(pool) == {"pack_wait"}
    assert pool["pack_wait"] == {
        "maps": 1, "wall_ms": 30e-6, "lanes_ms": 45e-6,
        "longest_lane_ms": 25e-6, "busiest_thread_ms": 25e-6,
        "busy_pct": 75.0, "threads": 2}
