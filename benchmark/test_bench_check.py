"""The check that decides `correct`, shown to fail.

CPU tests drive the rest of a run (harness.run_cell with device "cpu",
which skips the look for a card) over a small QCIF cell (benchkit): a
sound run is correct in both output modes; the control (every output
sample's lowest bit cleared, 7-bit samples in place of the stated 8) and
each fault a cell can have, planted in the port underneath, make
`correct` false:

- a step that returns its state unchanged: the batch's reference store
  writes nothing, so the DPB keeps what it held;
- half of the batch left out: the second half of the lanes gets no bytes;
- an answer altered where it is produced: one sample of lane 0's picture
  changed in the round's output planes.

(The exchange between chips has no fault to plant: every cell runs on
one card.)

The `cuda` tests run the control on the card at each cell's own size, on
three seeds, and print the readings:

    python -m pytest --noconftest -m cuda -s benchmark/test_bench_check.py
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from benchmark import benchkit, harness

BENCH = Path(__file__).resolve().parent
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CONTROL_SEEDS = (3_100_000_001, 3_100_000_002, 3_100_000_003)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    goldens = {n: benchkit.qcif_golden(n) for n in benchkit.QCIF_STREAMS}
    return benchkit.make_root(tmp_path_factory.mktemp("bench"), goldens)


def _run(root, cell=benchkit.QCIF_CELL, seed=2 ** 31 + 11, **kw):
    res, compared = harness.run_cell(cell, seed, 1.0, False,
                                     time.perf_counter(), device="cpu",
                                     root=root, **kw)
    assert list(res)[-1] == "compared"
    return res, compared


@pytest.mark.parametrize("cell", [benchkit.QCIF_CELL, benchkit.QCIF_HOST_CELL])
def test_sound_run_is_correct(root, cell):
    res, compared = _run(root, cell)
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] == res["run"]["frames"] > 0
    assert all(c["value"] == 0 for c in compared.values())
    assert set(res["metrics"]) == {"decode_fps", "setup_s"}
    # the window is the calls' time alone, the check between them off it
    run = res["run"]
    assert run["window_s"] == pytest.approx(sum(run["call_s"]))
    assert res["metrics"]["decode_fps"]["value"] == \
        pytest.approx(res["attempted"] / run["window_s"])


def test_traced_run_reads_the_layers(root):
    res, _ = harness.run_cell(benchkit.QCIF_CELL, 5, 1.0, True,
                              time.perf_counter(), device="cpu", root=root)
    assert res["correct"]
    # no device trace on the CPU: its readers stay silent, never 0
    assert {"frame_gap_p95_ms", "dispatch_ms_per_round",
            "parse_ms_per_frame", "gil_hold_pct",
            "upload_ms_per_round"} == set(res["metrics"])
    assert "breakdown" not in res


@pytest.mark.parametrize("cell", [benchkit.QCIF_CELL, benchkit.QCIF_HOST_CELL])
def test_control_fails(root, cell):
    res, compared = _run(root, cell, control=True)
    assert not res["correct"]
    assert compared["frames_wrong"]["value"] == res["attempted"]


def _plant(monkeypatch, fault):
    """Plant `fault` in BatchDecoder, the port's batched decode."""
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    init, decode = BatchDecoder._init_device, BatchDecoder.decode

    def init_planted(self, *a, **kw):
        init(self, *a, **kw)
        if fault == "state_unchanged":
            self._store = lambda *a, **kw: None
        elif fault == "answer_altered":
            step = self._step

            def altered(*a, **kw):
                planes = step(*a, **kw)
                planes[0][0][0, 0, 0] ^= 1
                return planes
            self._step = altered

    def decode_half(self, streams):
        half = len(streams) // 2
        return decode(self, list(streams[:half]) + [b""] * (len(streams)
                                                           - half))

    monkeypatch.setattr(BatchDecoder, "_init_device", init_planted)
    if fault == "half_batch":
        monkeypatch.setattr(BatchDecoder, "decode", decode_half)


@pytest.mark.parametrize("cell", [benchkit.QCIF_CELL, benchkit.QCIF_HOST_CELL])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_fault_fails(root, monkeypatch, cell, fault):
    _plant(monkeypatch, fault)
    res, compared = _run(root, cell)
    assert not res["correct"]
    key = {"state_unchanged": "frames_wrong", "half_batch": "frames_missing",
           "answer_altered": "frames_wrong"}[fault]
    assert compared[key]["value"] > compared[key]["limit"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_at_cell_size(card, cell):
    """The control at the cell's own size, over a window of run_seconds:
    every frame's comparison fails, on each seed."""
    for seed in CONTROL_SEEDS:
        res, compared = harness.run_cell(cell, seed, SPEC["run_seconds"],
                                         False, time.perf_counter(),
                                         control=True)
        print(json.dumps({"cell": cell, "seed": seed, "control": True,
                          "attempted": res["attempted"],
                          "compared": compared}), flush=True)
        assert not res["correct"]
        assert compared["frames_wrong"]["value"] == res["attempted"]
