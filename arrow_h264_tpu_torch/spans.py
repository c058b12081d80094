"""Spans of the batched decode's control loop, kept in memory, on the clock
of torch.profiler's events.

`recorder` is off by default.  When off, a span site costs one attribute
read (or the test of a local copy of it): no clock read, no allocation.
When on, each span is one tuple appended to a list; an append is atomic
under the GIL, so the parse pool's threads need no lock.  `drain` returns
the spans as `Span`s and clears the list; nothing is written to a file.

Times are read with `time.perf_counter_ns` and exported in Unix-epoch ns
(CLOCK_REALTIME), the base of torch.profiler's kineto events (its CPU
events, and CUPTI's device timestamps, which kineto converts to it), so a
span and a device event compare directly: the recorder takes one anchor
pair (perf_counter_ns, time_ns) when enabled.

What `parallel.batch.BatchDecoder.decode` records (the identifier of a
span is (call, round, lane); call counts decode calls since import):

- main thread: `decode` (a call), whose children are `parse_first` (the
  pool's first parse of every lane), one `round` a lockstep round, and
  `flush` (the DPBs' flush and the last outputs); a round's children
  are `pack_wait` (the pool's ABI and wire pack), `setup.device_state`
  (the device state, in a batch's first round), `upload` (children
  `upload.merge`, `upload.emit`, `upload.copy`), `step`, `commit`,
  `store`, `output` (the copies queued and the previous round's waited
  for, or the on_frame calls) and `parse_wait` (the pool's parse of the
  next round's pictures).  A round's `attrs`: live lanes, pictures
  committed, frames output, the upload ("wire" or "dense"), the bytes
  shipped and the lanes whose wire pack scanned rows in full
  (`full_scans`, DecodeStats.pack_full_scans);
- pool threads: `lane.parse`, `lane.pack`, `lane.emit`, each a child of
  the main-thread wait that submitted it;
- `frame_out`, an instant (t0 == t1) a frame that leaves the decoder;
- set-up: `setup.host_lib` (host/centropy.py::load_lib, with a g++
  build) and `setup.kernels` (ops/kernels/build.py::load, with nvcc).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

now = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    id: int
    parent: int         # the parent span's id, 0 for none
    call: int           # the decode call, -1 outside one
    round: int          # the call's round, -1 outside one
    lane: int           # -1: no one lane's
    thread: int         # threading.get_ident() of the recording thread
    t0: int             # Unix-epoch ns
    t1: int
    attrs: dict | None = None


class recorder:
    """The process's span recorder (class-level, as host/centropy.py's
    gil_meter): `enabled`, `enable`/`disable`, `add`/`mark` to record,
    `drain` to take the spans."""
    enabled = False
    _spans: list = []
    _offset = 0                     # Unix ns less perf_counter ns
    _ids = itertools.count(1)
    _calls = itertools.count()

    @classmethod
    def enable(cls) -> None:
        p0 = now()
        unix = time.time_ns()
        cls._offset = unix - (p0 + now()) // 2
        cls.enabled = True

    @classmethod
    def disable(cls) -> None:
        cls.enabled = False

    @classmethod
    def new_id(cls) -> int:
        return next(cls._ids)

    @classmethod
    def new_call(cls) -> int:
        return next(cls._calls)

    @classmethod
    def add(cls, name: str, t0: int, t1: int, parent: int = 0,
            call: int = -1, rnd: int = -1, lane: int = -1, sid: int = 0,
            attrs: dict | None = None) -> None:
        """Record the span `name` from t0 to t1 (perf_counter_ns); sid:
        its id if taken before (its children's parent), else a new one."""
        cls._spans.append((name, sid or next(cls._ids), parent, call, rnd,
                           lane, threading.get_ident(), t0, t1, attrs))

    @classmethod
    def mark(cls, name: str, t0: int, parent: int, call: int,
             rnd: int = -1, sid: int = 0, attrs: dict | None = None) -> int:
        """Record `name` from t0 to now; returns now, where the next span
        of a run of consecutive ones starts."""
        t1 = now()
        cls.add(name, t0, t1, parent, call, rnd, -1, sid, attrs)
        return t1

    @classmethod
    def drain(cls) -> list[Span]:
        """The spans recorded since the last drain, in Unix-epoch ns."""
        spans, cls._spans = cls._spans, []
        off = cls._offset
        return [Span(*s[:7], s[7] + off, s[8] + off, s[9]) for s in spans]
