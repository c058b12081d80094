"""The port's spans of a traced window (arrow_h264_tpu_torch/spans.py)
against the card's device events: pure functions of what one run
recorded, for benchmark/span_report.py.

A run's spans are split (`split`) into the set-up spans (`setup.*`
outside the window's calls), the warm-up (the BatchDecoder's first decode
call) and the window (every later call, whose rounds must sum to the
window's, else nothing is read).  Times are Unix-epoch ns, the base of
torch.profiler's device events, so the card's idle intervals and the
host's spans compare directly.  Four readings of a window:

- parse_wait_ms_per_round: the main thread's wall in the parse pool's
  maps, `pack_wait` (ABI and wire pack) and `parse_wait` (the next
  round's parse), over rounds: the pool's wall time, which the lanes'
  summed parse seconds cannot give;
- commit_ms_per_round: the `commit` spans (each lane's Decoder.commit:
  the DPB store, the co-located motion, the output bumping), over rounds;
- frame_out_gap_p95_ms: the p95 over lanes and frames of the gap between
  one lane's consecutive `frame_out` instants within a call;
- idle_in_parse_pct: the share of the card's idle time (each call's
  `decode` span less the union of its device events) inside `pack_wait`
  or `parse_wait`; None without a device trace.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

# the round's children, recorded on the main thread
ROUND_PHASES = ("pack_wait", "setup.device_state", "upload", "step",
                "commit", "store", "output", "parse_wait")
PARSE_WAITS = ("pack_wait", "parse_wait")
# the main thread's waits on the parse pool, and the pool spans under each
POOL_WAITS = {"parse_first": "lane.parse", "pack_wait": "lane.pack",
              "parse_wait": "lane.parse", "upload.emit": "lane.emit"}


@dataclass
class Trace:
    """The window's spans, the set-up's, and each window call's device
    events (None without a device trace), all in Unix ns."""
    spans: list
    setup: list
    sessions: list | None
    main: int = 0                   # the main thread's id
    _by: dict = field(default_factory=dict)

    def named(self, *names: str) -> list:
        """The main thread's spans of `names`, in time order."""
        key = names
        if key not in self._by:
            self._by[key] = sorted(
                (s for s in self.spans
                 if s.name in names and s.thread == self.main),
                key=lambda s: s.t0)
        return self._by[key]

    def seconds(self, *names: str) -> float:
        return sum(s.t1 - s.t0 for s in self.named(*names)) / 1e9

    @property
    def rounds(self) -> int:
        return sum(1 for s in self.named("round") if s.attrs.get("live"))

    def frame_out_gaps_ms(self) -> list[float]:
        """Each lane's gaps between consecutive frame_out instants within
        a call, in ms."""
        times = defaultdict(list)
        for s in self.spans:
            if s.name == "frame_out":
                times[s.call, s.lane].append(s.t0)
        gaps = []
        for ts in times.values():
            ts.sort()
            gaps += [(b - a) / 1e6 for a, b in zip(ts, ts[1:])]
        return gaps

    def idle(self) -> list[tuple[int, int]] | None:
        """The card's idle intervals: each call's `decode` span less the
        union of the device events of its session."""
        if self.sessions is None:
            return None
        if "idle" in self._by:
            return self._by["idle"]
        out = []
        for d, events in zip(self.named("decode"), self.sessions):
            cur = d.t0
            for _, s, e in sorted(events, key=lambda ev: ev[1]):
                if s > cur:
                    out.append((cur, min(s, d.t1)))
                cur = max(cur, e)
                if cur >= d.t1:
                    break
            if cur < d.t1:
                out.append((cur, d.t1))
        self._by["idle"] = [(s, e) for s, e in out if e > s]
        return self._by["idle"]

    def idle_in(self, *names: str) -> float:
        """Idle device seconds inside the main thread's spans of `names`
        (0 without a device trace)."""
        return overlap(self.idle() or [],
                       [(s.t0, s.t1) for s in self.named(*names)]) / 1e9


def overlap(a: list, b: list) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def split(spans: list, sessions: list | None, rounds: int) -> Trace | None:
    """The window of a run's spans: the calls after the first (the
    warm-up), with the window's device sessions (None or empty: no device
    trace); None unless they hold `rounds` rounds, and a session a call
    where there are sessions."""
    calls = sorted({s.call for s in spans if s.name == "decode"})
    if len(calls) < 2:
        return None
    main = next(s.thread for s in spans if s.name == "decode")
    window_calls = set(calls[1:])
    setup = [s for s in spans if s.name.startswith("setup.")
             and s.call not in window_calls]
    trace = Trace([s for s in spans if s.call in window_calls], setup,
                  sessions or None, main)
    if trace.rounds != rounds or \
            (trace.sessions is not None
             and len(trace.sessions) != len(window_calls)):
        return None
    return trace


# ---- the four readings -------------------------------------------------------

def parse_wait_ms_per_round(tr: Trace) -> float | None:
    return 1e3 * tr.seconds(*PARSE_WAITS) / tr.rounds if tr.rounds else None


def commit_ms_per_round(tr: Trace) -> float | None:
    return 1e3 * tr.seconds("commit") / tr.rounds if tr.rounds else None


def frame_out_gap_p95_ms(tr: Trace) -> float | None:
    gaps = tr.frame_out_gaps_ms()
    return float(np.percentile(gaps, 95)) if gaps else None


def idle_in_parse_pct(tr: Trace) -> float | None:
    idle = tr.idle()
    if not idle:
        return None
    total = sum(e - s for s, e in idle) / 1e9
    return 100.0 * tr.idle_in(*PARSE_WAITS) / total


# ---- the spans' clock against the device trace's ---------------------------

def skews(tr: Trace) -> list[tuple[int, int, int]]:
    """(call, round, ns) of each round with a copy to the card: from its
    `upload.copy` span's start to the first `Memcpy HtoD` on the card
    after the round began."""
    if tr.sessions is None:
        return []
    copies = {d.call: sorted(s for name, s, _ in events
                             if name.startswith("Memcpy HtoD"))
              for d, events in zip(tr.named("decode"), tr.sessions)}
    starts = {(s.call, s.round): s.t0 for s in tr.named("round")}
    out = []
    for c in tr.named("upload.copy"):
        ts = copies[c.call]
        k = bisect.bisect_left(ts, starts[c.call, c.round])
        if k < len(ts):
            out.append((c.call, c.round, ts[k] - c.t0))
    return out


def realigned(tr: Trace) -> Trace:
    """`tr` with each call's device events moved, round by round, by the
    round's skew less the run's median skew: the device clock re-anchored
    at every round's first copy to the card.  A round without a copy
    keeps the shift of the round before it."""
    sk = skews(tr)
    if not sk:
        return tr
    ref = statistics.median(s for _, _, s in sk)
    dev = {(c, r): s - ref for c, r, s in sk}
    sessions = []
    for d, events in zip(tr.named("decode"), tr.sessions):
        rounds = [s for s in tr.named("round") if s.call == d.call]
        starts = [s.t0 for s in rounds]
        shifts, last = [], 0
        for s in rounds:
            last = dev.get((s.call, s.round), last)
            shifts.append(last)
        moved = []
        for name, s, e in events:
            k = max(0, bisect.bisect_right(starts, s) - 1)
            x = shifts[k] if shifts else 0
            moved.append((name, s - x, e - x))
        sessions.append(moved)
    return Trace(tr.spans, tr.setup, sessions, tr.main)


# ---- the parse pool under the main thread's waits --------------------------

def pool_maps(tr: Trace) -> dict:
    """For each of the main thread's waits on the pool (POOL_WAITS), the
    medians over its spans in the window, ms: the wait's wall, the lanes'
    summed spans, the longest lane, the busiest thread's summed lanes,
    the pool's busy share (summed lanes over threads x wall, %) and the
    threads that ran lanes.  The wall less the busiest thread is the
    time the pool's busiest thread ran no lane (a queue hand-off); a wall
    near the longest lane says one lane ends the map."""
    kids = defaultdict(list)
    for s in tr.spans:
        if s.name in POOL_WAITS.values():
            kids[s.parent].append(s)
    out = {}
    for wait in POOL_WAITS:
        rows = []
        for w in tr.named(wait):
            ks = kids.get(w.id)
            if not ks or w.t1 <= w.t0:
                continue
            wall = w.t1 - w.t0
            by_thread = defaultdict(int)
            for k in ks:
                by_thread[k.thread] += k.t1 - k.t0
            total = sum(by_thread.values())
            rows.append((wall, total, max(k.t1 - k.t0 for k in ks),
                         max(by_thread.values()),
                         100.0 * total / (len(by_thread) * wall),
                         len(by_thread)))
        if rows:
            med = [statistics.median(col) for col in zip(*rows)]
            out[wait] = {"maps": len(rows), "wall_ms": med[0] / 1e6,
                         "lanes_ms": med[1] / 1e6,
                         "longest_lane_ms": med[2] / 1e6,
                         "busiest_thread_ms": med[3] / 1e6,
                         "busy_pct": med[4], "threads": med[5]}
    return out
