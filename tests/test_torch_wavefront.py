"""The work orders of the persistent kernels
(arrow_h264_tpu_torch.ops.kernels.wavefront).  The wavefront order against
the knight-phase schedule of the JAX package's Pallas kernels
(ops/pallas/deblock_phase.py): the same phases, in the same order, and
every MB after the neighbours it reads.  The row pipeline of
csrc/intra_raster.cu and csrc/deblock_raster.cu as a model of its
workers (tickets, row counters, the lag rule), replayed under adversarial
interleavings: every MB after everything its body reads or overwrites,
and no wait that never ends."""

import random

import numpy as np
import pytest
import torch

from arrow_h264_tpu.ops.pallas.deblock_phase import n_phases
from arrow_h264_tpu_torch.ops.kernels.wavefront import (
    row_args, wavefront_args, wavefront_order,
)

SIZES = [(1, 1), (1, 6), (6, 1), (7, 5), (120, 68)]
ROW_SIZES = [(1, 1), (1, 6), (6, 1), (2, 5), (7, 5), (120, 68)]


@pytest.mark.parametrize("mb_w,mb_h", SIZES)
def test_order_is_a_schedule(mb_w, mb_h):
    order = wavefront_order(mb_w, mb_h)
    n = mb_w * mb_h
    assert order.dtype == np.int32 and order.shape == (n,)
    assert sorted(order.tolist()) == list(range(n))
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    for m in range(n):
        my, mx = divmod(m, mb_w)
        # left, top-left, top, top-right: what intra and deblock read
        for dx, dy in ((-1, 0), (-1, -1), (0, -1), (1, -1)):
            x, y = mx + dx, my + dy
            if 0 <= x < mb_w and y >= 0:
                assert pos[y * mb_w + x] < pos[m], (m, x, y)


@pytest.mark.parametrize("mb_w,mb_h", SIZES)
def test_order_follows_the_jax_phases(mb_w, mb_h):
    order = wavefront_order(mb_w, mb_h)
    my, mx = np.divmod(order, mb_w)
    phase = 2 * my + mx
    # the JAX schedule's phases that hold an MB: all n_phases of them,
    # except the odd (empty) ones of a one-MB-wide frame
    jax_phases = {p for p in range(n_phases(mb_w, mb_h))
                  if any(0 <= p - 2 * y < mb_w for y in range(mb_h))}
    assert set(phase.tolist()) == jax_phases
    assert len(jax_phases) == (n_phases(mb_w, mb_h) if mb_w > 1 else mb_h)
    assert np.all(np.diff(phase) >= 0)
    # within a phase, rows ascend
    same = np.diff(phase) == 0
    assert np.all(np.diff(my)[same] > 0)


def test_wavefront_args_caches_the_order():
    o1, s1 = wavefront_args(3, 7, 5, torch.device("cpu"))
    o2, s2 = wavefront_args(2, 7, 5, torch.device("cpu"))
    assert o1 is o2
    assert torch.equal(o1, torch.from_numpy(wavefront_order(7, 5)))
    assert s1.dtype == torch.int32 and s1.shape == (3 * 35 + 1,)
    assert s2.shape == (2 * 35 + 1,)
    o3, s3 = wavefront_args(3, 7, 5, torch.device("cpu"), parts=2)
    assert o3 is o1 and s3.shape == (2 * 3 * 35 + 1,)


def test_probe_variants_apply(tmp_path):
    """Every source edit of tools/wavefront_probe.py still finds its text
    in the kernels' sources, so the probe builds each variant."""
    from tools import wavefront_probe
    for name in wavefront_probe.VARIANTS:
        srcs = wavefront_probe.variant_sources(name, tmp_path / name)
        assert [s.name for s in srcs] == list(wavefront_probe.SOURCES)
        assert all(s.exists() for s in srcs)


def test_row_args():
    (s1,) = row_args(3, 5, torch.device("cpu"))
    assert s1.dtype == torch.int32 and s1.shape == (3 * 5 + 1,)
    (s2,) = row_args(3, 5, torch.device("cpu"), parts=2)
    assert s2.shape == (2 * 3 * 5 + 1,)


def _row_workers(n_workers, B, parts, mb_w, mb_h, inter, lag, log):
    """The workers of a row-pipelined kernel as generators, one step of
    the kernel a `next()`: csrc/intra_raster.cu (inter is not None: the
    [B, mb_h, mb_w] MBs it passes over) or csrc/deblock_raster.cu (inter
    None).  A worker yields (counter, target) where the kernel waits,
    else None; log gets ("start" | "end", b, part, mx, my)."""
    rows = parts * B * mb_h
    state = {"ticket": 0, "done": np.zeros((B, parts, mb_h), np.int64),
             "held": [None] * n_workers}     # each worker's ticket

    def worker(w):
        while True:
            tk = state["held"][w] = state["ticket"]     # atomicAdd
            state["ticket"] += 1
            yield None
            if tk >= rows:
                return
            my, b, part = tk // (parts * B), tk // parts % B, tk % parts
            done = state["done"][b, part]
            seen = published = 0
            for mx in range(mb_w):
                if inter is not None:
                    if inter[b, my, mx]:
                        continue
                    if published < mx:
                        done[my] = published = mx
                        yield None
                if my > 0:
                    target = min(mx + lag, mb_w)
                    if target > seen:
                        while done[my - 1] < target:
                            yield (b, part, my - 1), target
                        seen = done[my - 1]
                log.append(("start", b, part, mx, my))
                yield None
                log.append(("end", b, part, mx, my))
                yield None
                done[my] = published = mx + 1
                yield None
            if published < mb_w:
                done[my] = mb_w
                yield None

    return [worker(w) for w in range(n_workers)], state


def _run_rows(strategy, n_workers, B, parts, mb_w, mb_h, inter=None,
              lag=2, seed=0):
    """Replay the workers, one step at a time, choosing the next worker
    to step by `strategy` among those whose wait is satisfied: "random",
    "newest" (the largest ticket, and a worker with none takes one first,
    so rows below race ahead as far as the waits let them) or "oldest"
    (the smallest ticket first).  Returns the log; fails on a deadlock."""
    log = []
    workers, state = _row_workers(n_workers, B, parts, mb_w, mb_h, inter,
                                  lag, log)
    rng = random.Random(seed)
    waits = [None] * len(workers)
    live = list(range(len(workers)))
    while live:
        ready = [w for w in live if waits[w] is None
                 or state["done"][waits[w][0]] >= waits[w][1]]
        assert ready, "deadlock: every live worker waits"
        held = [(np.inf if state["held"][w] is None else state["held"][w],
                 w) for w in ready]
        w = (rng.choice(ready) if strategy == "random"
             else max(held)[1] if strategy == "newest" else min(held)[1])
        try:
            waits[w] = next(workers[w])
        except StopIteration:
            live.remove(w)
    assert (state["done"] == mb_w).all()
    return log


# (dx, dy, writes) of the MBs whose samples a body touches, its own first:
# an intra body writes its MB and reads the left, top-left, top and
# top-right MBs; a deblock body reads and writes its MB, the left one (its
# vertical edge) and the top one (its horizontal edge)
INTRA_TOUCH = ((0, 0, True), (-1, 0, False), (-1, -1, False),
               (0, -1, False), (1, -1, False))
DEBLOCK_TOUCH = ((0, 0, True), (-1, 0, True), (0, -1, True))


def _conflicts(log, mb_w, intra):
    """Pairs of MB bodies that touch one MB's samples, at least one of
    them writing, that did not run one after the other in raster order
    (INTRA_TOUCH, DEBLOCK_TOUCH)."""
    t = {}
    for i, (ev, *key) in enumerate(log):
        t.setdefault(tuple(key), {})[ev] = i
    touch = {}                       # (b, part, region) -> [(raster, op, w)]
    for (b, part, mx, my), se in t.items():
        assert set(se) == {"start", "end"}
        for dx, dy, w in INTRA_TOUCH if intra else DEBLOCK_TOUCH:
            x, y = mx + dx, my + dy
            if 0 <= x < mb_w and y >= 0:
                touch.setdefault((b, part, x, y), []).append(
                    (my * mb_w + mx, se, w))
    bad = []
    for region, ops in touch.items():
        ops.sort(key=lambda o: o[0])
        for i, (_, first, w1) in enumerate(ops):
            for _, then, w2 in ops[i + 1:]:
                if (w1 or w2) and first["end"] > then["start"]:
                    bad.append(region)
    return bad


ROW_RUNS = [("newest", None), ("oldest", None), ("random", None),
            ("random", 2), ("random", 3), ("newest", 1)]


@pytest.mark.parametrize("mb_w,mb_h", ROW_SIZES)
def test_row_schedule(mb_w, mb_h):
    """The row pipeline of K5 (two parts, a third of the MBs inter, which
    it passes over) and of K6 under each replay: with as many workers as
    rows, two, three, and a single worker; two streams, one at 1080p.
    Every body runs after everything it reads or overwrites, and every
    wait ends."""
    B = 1 if mb_w * mb_h > 1000 else 2
    runs = ROW_RUNS[:2] + ROW_RUNS[-1:] if B == 1 else ROW_RUNS
    inter = np.random.default_rng(mb_w + mb_h).random((B, mb_h, mb_w)) < 0.3
    for seed, (strategy, n) in enumerate(runs):
        for parts, kinds in ((2, inter), (1, None)):
            n_workers = n or parts * B * mb_h
            log = _run_rows(strategy, n_workers, B, parts, mb_w, mb_h,
                            kinds, seed=seed)
            ran = sum(ev == "start" for ev, *_ in log)
            assert ran == (parts * B * mb_w * mb_h if kinds is None
                           else parts * int((~inter).sum()))
            assert not _conflicts(log, mb_w, intra=kinds is not None), \
                (strategy, n)


@pytest.mark.parametrize("intra", [True, False])
def test_row_schedule_needs_its_lag(intra):
    """The replay sees the race of a lag of one MB: an intra MB would read
    its top-right neighbour, a deblock MB the top one's right columns,
    before that neighbour is done."""
    mb_w, mb_h = 7, 5
    inter = np.zeros((1, mb_h, mb_w), bool) if intra else None
    log = _run_rows("newest", 2 * mb_h, 1, 2 if intra else 1, mb_w, mb_h,
                    inter, lag=1)
    assert _conflicts(log, mb_w, intra)
