"""Traced runs of cells, read through the port's spans: the four span
readings (benchmark/spanread.py), where the card's idle time lies among
the main thread's spans, the set-up's split, the spans' clock against the
device trace's, how much of a round its phases cover, the parse pool's
maps, the rounds' counters, and what a span costs.

    python3 benchmark/span_report.py --workload CELL --seed N
        [--seconds 45] [--out DIR]

The cell runs as `benchmark/run.py --trace 1` runs it (harness.run_cell),
with the port's span recorder turned on for this run alone and a copy
kept of each traced call's device events (`capture`).  The report is
one JSON line, printed and, with --out, written to
DIR/span_report_CELL_N.json:

- `metrics`, `run`: the run's result line's;
- `spans`: parse_wait_ms_per_round, commit_ms_per_round,
  frame_out_gap_p95_ms, idle_in_parse_pct, and idle_in_parse_pct with
  the device clock re-anchored at every round (`realigned`);
- `idle_by_span`: the ten main-thread span names with the most idle
  device seconds inside them (`idle_by_span_realigned` the same,
  re-anchored);
- `idle_covered_pct`: the share of the card's idle time in the window
  that the main thread's innermost spans hold (a round's phases, the
  call's first parse and its flush);
- `setup_spans`: the seconds of each set-up span;
- `round_ms`: the median of each of a round's phases, ms;
- `coverage`: the median and least share of a round that its phases
  cover;
- `clock`: for each round, the skew from its `upload.copy` span's start
  to the first `Memcpy HtoD` on the card after the round began (by call
  and by round), the share of rounds whose copy starts between the
  span's start and 2 ms after its end, and a bound on how far the
  skew's spread can move idle_in_parse_pct;
- `pool`: spanread.pool_maps, the pool's spans under each wait;
- `round_attrs`: the rounds' counters (median live lanes, pictures
  committed, frames output; rounds by upload; the copy's GB/s);
- `spans_per_round`, and `cost`: ns a span recorded on this host
  (`recorder.add`, `recorder.mark`) and of a span site with the recorder
  off, and the spans' cost as a share of the median round.

A program without the recorder (older than the spans) runs the cell all
the same, and the report's `spans` is None.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:] = [str(BENCH.parent)] + [p for p in sys.path
                                     if Path(p or ".").resolve() != BENCH]

from benchmark import devtrace, harness, spanread  # noqa: E402

CONTAINERS = ("decode", "round", "upload")
COPY_WINDOW_NS = 2_000_000


class capture:
    """`with capture() as cap:` turns the port's span recorder on, empty,
    and keeps each device session's events as devtrace.device_events
    hands them to the harness; on exit the recorder is off again and
    `cap.spans`, `cap.sessions` hold what the run recorded.  Without the
    recorder in the program, `cap.spans` is None."""

    def __enter__(self):
        try:
            from arrow_h264_tpu_torch.spans import recorder
        except ImportError:
            recorder = None
        self.recorder, self.spans, self.sessions = recorder, None, []
        self._inner = devtrace.device_events

        def device_events(prof):
            events = self._inner(prof)
            self.sessions.append(events)
            return events
        devtrace.device_events = device_events
        if recorder is not None:
            recorder.drain()
            recorder.enable()
        return self

    def __exit__(self, *exc):
        devtrace.device_events = self._inner
        if self.recorder is not None:
            self.recorder.disable()
            self.spans = self.recorder.drain()
        return False


def idle_report(tr: spanread.Trace) -> dict:
    idle = tr.idle() or []
    total = sum(e - s for s, e in idle) / 1e9
    names = {s.name for s in tr.spans
             if s.thread == tr.main and s.name not in ("frame_out", "decode")}
    by = {n: tr.idle_in(n) for n in names}
    leaves = [n for n in names if n not in CONTAINERS]
    return {"idle_s": total,
            "idle_by_span": [[n, v] for n, v in sorted(
                by.items(), key=lambda kv: -kv[1])[:10]],
            "idle_covered_pct": 100.0 * tr.idle_in(*leaves) / total
            if total else None}


def clock_report(tr: spanread.Trace) -> dict | None:
    sk = spanread.skews(tr)
    if not sk:
        return None
    ends = {(c.call, c.round): c.t1 - c.t0 for c in tr.named("upload.copy")}
    calls = {d.call: d.t0 for d in tr.named("decode")}
    rounds = {(s.call, s.round): s.t0 for s in tr.named("round")}
    by_call = defaultdict(list)
    for c, r, ns in sk:
        by_call[c].append(ns / 1e6)
    every = [ns / 1e6 for _, _, ns in sk]
    ref = statistics.median(every)
    idle = sum(e - s for s, e in tr.idle() or []) / 1e6
    inside = sum(0 <= ns <= ends[c, r] + COPY_WINDOW_NS for c, r, ns in sk)
    return {"rounds": len(sk), "inside_pct": 100.0 * inside / len(sk),
            "skew_ms_median": ref, "skew_ms_min": min(every),
            "skew_ms_max": max(every),
            # each round's error moves at most three of the parse waits'
            # edges (the round's start, pack_wait's end, parse_wait's
            # start) by its distance from the median
            "idle_in_parse_bound_pct": 100.0 * sum(
                3 * abs(x - ref) for x in every) / idle if idle else None,
            # each call's rounds, least, median and most skew (ms)
            "calls": [[c, len(v), min(v), statistics.median(v), max(v)]
                      for c, v in sorted(by_call.items())],
            # each round's call, round, s since its call began, skew (ms)
            "each": [[c, r, (rounds[c, r] - calls[c]) / 1e9, ns / 1e6]
                     for c, r, ns in sk]}


def round_report(tr: spanread.Trace) -> dict:
    per = defaultdict(lambda: defaultdict(int))
    for s in tr.spans:
        if s.thread == tr.main and s.round >= 0:
            per[s.name][s.call, s.round] += s.t1 - s.t0
    keys = [(r.call, r.round) for r in tr.named("round")]
    return {n: statistics.median(per[n].get(k, 0) for k in keys) / 1e6
            for n in sorted(per) if n != "frame_out"}


def attrs_report(tr: spanread.Trace) -> dict:
    """The rounds' counters: medians of live lanes, pictures committed
    and frames output a round, rounds by upload, and the bytes shipped
    over the `upload.copy` spans' seconds."""
    rounds = [r.attrs for r in tr.named("round") if r.attrs.get("live")]
    kinds = defaultdict(int)
    for a in rounds:
        kinds[a.get("upload")] += 1
    copy_s = tr.seconds("upload.copy")
    shipped = sum(a.get("bytes", 0) for a in rounds)
    out = {k: statistics.median(a[k] for a in rounds)
           for k in ("live", "committed", "output")} if rounds else {}
    out.update(rounds_by_upload=dict(kinds), bytes_per_round=shipped /
               len(rounds) if rounds else None,
               copy_gb_s=shipped / copy_s / 1e9 if copy_s else None)
    return out


def cost_report(n: int = 200_000) -> dict:
    """ns a span costs on this host: recorded, and a site with the
    recorder off."""
    from arrow_h264_tpu_torch.spans import now, recorder
    recorder.drain()
    recorder.enable()
    t0 = now()
    for _ in range(n):
        recorder.add("lane.parse", 1, 2, 3, 4, 5, 6)
    t1 = now()
    for _ in range(n):
        recorder.mark("commit", 1, 3, 4, 5)
    t2 = now()
    recorder.disable()
    recorder.drain()
    t3 = now()
    for _ in range(n):
        if recorder.enabled:
            recorder.add("lane.parse", 1, 2)
    t4 = now()
    return {"add_ns": (t1 - t0) / n, "mark_ns": (t2 - t1) / n,
            "off_site_ns": (t4 - t3) / n}


def report(cell: str, seed: int, seconds: float, **kw) -> dict:
    """The report of one traced run of `cell`; kw: run_cell's device and
    root."""
    with capture() as cap:
        result, _ = harness.run_cell(cell, seed, seconds, True, T_START,
                                     **kw)
    out = {"workload": cell, "seed": seed, "correct": result["correct"],
           "device": result["device"], "metrics": result["metrics"],
           "breakdown": result.get("breakdown"), "run": result["run"],
           "spans": None}
    tr = None if cap.spans is None else spanread.split(
        cap.spans, cap.sessions, result["run"]["rounds"])
    if tr is None:
        return out
    setup = defaultdict(float)
    for s in tr.setup:
        setup[s.name] += (s.t1 - s.t0) / 1e9
    cover = defaultdict(int)
    for s in tr.spans:
        if s.name in spanread.ROUND_PHASES and s.thread == tr.main:
            cover[s.parent] += s.t1 - s.t0
    shares = [cover[r.id] / (r.t1 - r.t0) for r in tr.named("round")]
    rounds = tr.rounds
    round_ms = round_report(tr)
    cost = cost_report()
    per_round = len(tr.spans) / rounds
    cost["share_of_round_pct"] = 100.0 * per_round * cost["add_ns"] / (
        1e6 * round_ms["round"])
    moved = spanread.realigned(tr)
    out["spans"] = {
        "parse_wait_ms_per_round": spanread.parse_wait_ms_per_round(tr),
        "commit_ms_per_round": spanread.commit_ms_per_round(tr),
        "frame_out_gap_p95_ms": spanread.frame_out_gap_p95_ms(tr),
        "idle_in_parse_pct": spanread.idle_in_parse_pct(tr),
        "idle_in_parse_pct_realigned": spanread.idle_in_parse_pct(moved)}
    out.update(idle_report(tr),
               idle_by_span_realigned=idle_report(moved)["idle_by_span"],
               setup_spans=dict(setup), round_ms=round_ms,
               coverage={"median": statistics.median(shares),
                         "least": min(shares)},
               clock=clock_report(tr), pool=spanread.pool_maps(tr),
               round_attrs=attrs_report(tr), rounds=rounds,
               spans_per_round=per_round, cost=cost)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    line = json.dumps(report(args.workload, args.seed, args.seconds))
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / f"span_report_{args.workload}_{args.seed}.json"
         ).write_text(line)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
