"""The span recorder of the port's batched decode
(arrow_h264_tpu_torch.spans, recorded by parallel.batch.BatchDecoder) on
the CPU, over two QCIF lanes of tests/data that end in different rounds:
off, it records nothing and the frames are the same as on; on, each
round's spans form a tree that tiles the round, the pool's spans hang
under the waits that submitted them, the counters are the spans' sums,
a frame_out instant marks every frame returned, and a span's times lie
on the clock of torch.profiler's events."""

import time
from collections import Counter, defaultdict
from pathlib import Path

import pytest
import torch

from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
from arrow_h264_tpu_torch.spans import now, recorder

DATA = Path(__file__).resolve().parent / "data"
# 3 and 4 pictures: lane 0 leaves the rounds before lane 1
LANES = [(DATA / f"batch_qcif_s{i}.264").read_bytes() for i in (1, 2)]
ROUND_KIDS = {"pack_wait", "upload", "step", "commit", "store", "output",
              "parse_wait"}
UPLOAD_KIDS = {"upload.merge", "upload.emit", "upload.copy"}


def _sums(bd):
    return {k: sum(s[k] for s in bd.stats)
            for k in ("host_parse_s", "device_dispatch_s")}


@pytest.fixture(scope="module")
def runs():
    """Decodes of LANES: with the recorder off, then on (materialize=True,
    one BatchDecoder after its warm-up), and on with on_frame."""
    recorder.disable()
    recorder.drain()
    try:
        with BatchDecoder(len(LANES), device="cpu") as bd:
            off = bd.decode(LANES)
            off_spans = recorder.drain()
            before = _sums(bd)
            recorder.enable()
            on = bd.decode(LANES)
            recorder.disable()
            spans = recorder.drain()
            got = {"off": off, "off_spans": off_spans, "on": on,
                   "spans": spans, "bd": bd, "before": before,
                   "after": _sums(bd)}
        with BatchDecoder(len(LANES), device="cpu", materialize=False,
                          on_frame=lambda i, f: f) as bd2:
            recorder.enable()
            got["device"] = bd2.decode(LANES)
            recorder.disable()
            got["device_spans"] = recorder.drain()
        yield got
    finally:
        recorder.disable()
        recorder.drain()


def _kids(spans):
    out = defaultdict(list)
    for s in spans:
        out[s.parent].append(s)
    return out


def test_off_records_nothing_and_frames_equal(runs):
    assert runs["off_spans"] == []
    assert [[f.planar() for f in lane] for lane in runs["off"]] == \
        [[f.planar() for f in lane] for lane in runs["on"]]
    assert sum(map(len, runs["on"])) == 7


def test_each_round_is_a_tree_that_tiles_it(runs):
    spans, bd = runs["spans"], runs["bd"]
    kids = _kids(spans)
    (dec,) = [s for s in spans if s.name == "decode"]
    rounds = [s for s in spans if s.name == "round"]
    assert len(rounds) == bd.rounds == 4
    assert sorted(s.round for s in rounds) == [0, 1, 2, 3]
    main = [s for s in kids[dec.id] if s.name != "frame_out"]
    assert Counter(s.name for s in main) == \
        {"parse_first": 1, "round": 4, "flush": 1}
    assert sum(s.t1 - s.t0 for s in main) == dec.t1 - dec.t0
    for r in rounds:
        phases = [s for s in kids[r.id] if s.name != "frame_out"]
        assert Counter(s.name for s in phases) == Counter(ROUND_KIDS)
        assert all(r.t0 <= s.t0 <= s.t1 <= r.t1 for s in kids[r.id])
        assert sum(s.t1 - s.t0 for s in phases) >= 0.9 * (r.t1 - r.t0)
        assert r.attrs["live"] == len({s.lane for s in spans
                                       if s.name == "lane.pack"
                                       and s.round == r.round})
        assert r.attrs["upload"] == "wire" and r.attrs["bytes"] > 0
        (up,) = [s for s in phases if s.name == "upload"]
        assert {s.name for s in kids[up.id]} == UPLOAD_KIDS
        assert all(up.t0 <= s.t0 <= s.t1 <= up.t1 for s in kids[up.id])
    assert sum(r.attrs["output"] for r in rounds) + sum(
        1 for s in kids[dec.id] if s.name == "frame_out") == 7


def test_pool_spans_hang_under_the_main_thread_waits(runs):
    spans = runs["spans"]
    by_id = {s.id: s for s in spans}
    main = by_id[[s for s in spans if s.name == "decode"][0].id].thread
    live = {0: {0, 1}, 1: {0, 1}, 2: {0, 1}, 3: {1}}
    for name, wait in (("lane.pack", "pack_wait"),
                       ("lane.parse", "parse_wait")):
        per_round = defaultdict(list)
        for s in spans:
            if s.name == name and s.round >= 0:
                per_round[s.round].append(s.lane)
                parent = by_id[s.parent]
                assert parent.name == wait and parent.round == s.round
                assert parent.thread == main
                assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
        assert {r: sorted(v) for r, v in per_round.items()} == \
            {r: sorted(v) for r, v in live.items()}
    firsts = [s for s in spans if s.name == "lane.parse" and s.round < 0]
    assert sorted(s.lane for s in firsts) == [0, 1]
    assert {by_id[s.parent].name for s in firsts} == {"parse_first"}
    emits = [s for s in spans if s.name == "lane.emit"]
    assert len(emits) == 4 * len(LANES)
    assert {by_id[s.parent].name for s in emits} == {"upload.emit"}


def test_counters_are_the_spans_sums(runs):
    spans, bd = runs["spans"], runs["bd"]
    before, after = runs["before"], runs["after"]

    def total(*names):
        return sum(s.t1 - s.t0 for s in spans if s.name in names) / 1e9

    assert total("lane.parse", "lane.pack") == pytest.approx(
        after["host_parse_s"] - before["host_parse_s"], rel=1e-9)
    assert total("upload") == pytest.approx(bd.upload_s, rel=1e-9)
    # the dispatch holds the upload, step and store, not the commit loop
    assert total("upload", "step", "store") == pytest.approx(
        after["device_dispatch_s"] - before["device_dispatch_s"], rel=1e-9)


@pytest.mark.parametrize("kind", ["on", "device"])
def test_frame_out_marks_every_frame_returned(runs, kind):
    frames = runs[kind]
    spans = runs["spans" if kind == "on" else "device_spans"]
    outs = Counter(s.lane for s in spans if s.name == "frame_out")
    assert all(s.t0 == s.t1 for s in spans if s.name == "frame_out")
    assert outs == {i: len(f) for i, f in enumerate(frames)}


def test_frame_batch_has_no_field_counts(runs):
    """Frame streams: every round's `fields` is 0, no `weave` span, and
    the lanes' field counters stay 0."""
    rounds = [s for s in runs["spans"] if s.name == "round"]
    assert rounds and all(r.attrs["fields"] == 0 for r in rounds)
    assert not [s for s in runs["spans"] if s.name == "weave"]
    assert [(s["field_pictures"], s["weave_s"]) for s in runs["bd"].stats] \
        == [(0, 0.0)] * len(LANES)


def test_span_holds_a_profiler_event_on_its_clock():
    """A span around a record_function region contains that event, under
    a CPU-activity profiler, within 1 ms after conversion to Unix ns."""
    recorder.disable()
    recorder.drain()
    recorder.enable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            t0 = now()
            with torch.autograd.profiler.record_function("span_probe"):
                torch.ones(4096).cumsum(0)
            recorder.add("probe", t0, now())
    finally:
        recorder.disable()
    (span,) = recorder.drain()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "span_probe"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert span.t0 - 1_000_000 <= start <= end <= span.t1 + 1_000_000
    assert abs(span.t1 - time.time_ns()) < 10 ** 9
