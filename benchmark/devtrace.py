"""The device trace of a traced window, reduced to what the readers need.

`torch.profiler` with CUDA activity alone records every kernel, copy and
set on the card, also those the port launches through ctypes (no torch
operator owns them).  A traced window is one profiler session a decode
call (the check between calls is not traced).  From the sessions' events:

- kernel_s: the kernels' summed durations;
- busy_s: the length of the union of every device event's interval;
- device_ops: the ten names (short_name) with the most summed seconds;
- idle_gaps: the gaps between busy intervals within a session, summed by
  the operation that ends each gap (what the host queued when it came
  back to the card), the ten longest.
"""

from __future__ import annotations

import re
from collections import defaultdict

COPY_PREFIXES = ("Memcpy", "Memset")


def short_name(name: str) -> str:
    """A kernel's name without its namespace, template and parameter
    lists ("(anonymous namespace)::k(Args)" -> "k"); copies and sets as
    CUPTI names them."""
    if name.startswith(COPY_PREFIXES):
        return name
    name = name.replace("(anonymous namespace)::", "")
    name = re.split(r"[(<]", name, maxsplit=1)[0]
    return name.removeprefix("void ").strip() or name


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of each event on a CUDA device."""
    import torch
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = e.start_ns()
        out.append((short_name(e.name()), start, start + e.duration_ns()))
    return out


def reduce_events(sessions: list[list[tuple[str, int, int]]]
                  ) -> dict | None:
    """{"kernel_s", "busy_s", "device_ops", "idle_gaps"} of the events of
    each session (name, start ns, end ns), or None when no session holds
    a device event."""
    if not any(sessions):
        return None
    by_name: dict = defaultdict(float)
    gaps: dict = defaultdict(float)
    kernel_ns = busy_ns = 0
    for events in sessions:
        if not events:
            continue
        events = sorted(events, key=lambda e: e[1])
        for name, s, e in events:
            by_name[name] += (e - s) / 1e9
            if not name.startswith(COPY_PREFIXES):
                kernel_ns += e - s
        cur_s, cur_e = events[0][1], events[0][2]
        for name, s, e in events[1:]:
            if s > cur_e:
                busy_ns += cur_e - cur_s
                gaps[f"before {name}"] += (s - cur_e) / 1e9
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy_ns += cur_e - cur_s

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]

    return {"kernel_s": kernel_ns / 1e9, "busy_s": busy_ns / 1e9,
            "device_ops": top(by_name), "idle_gaps": top(gaps)}
