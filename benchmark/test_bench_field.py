"""CPU tests of the benchmark's field configuration: the files of
`h264-1080i-high` and its cell `field1080i-b32-device`, and a run of the
harness over small field streams of the same writer.

Field streams code two pictures a frame, which `test_bench_layout.py`'s
check of every cell (one picture a frame) does not allow; here the cell's
goldens hold one letter a field picture, two a woven frame and its MD5.
The run goes through harness.run_cell on the CPU as test_bench_check.py's
do, with the warm-up's cut ending on a lone B top field, as it does in
the 1080i cell.

    python -m pytest benchmark/test_bench_field.py
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path

import pytest

from benchmark import benchkit, harness, lanes

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CONFIG, CELL = "h264-1080i-high", "field1080i-b32-device"
STREAMS = tuple(f"bench_field1080i_s{s}" for s in range(4))
SMALL = ("field_cabac_s0", "field_cabac_s1")
SMALL_CELL = "fieldsmall-b4-device"


def test_config_and_cell_entries():
    (conf,) = [c for c in SPEC["configs"] if c["name"] == CONFIG]
    assert conf["file"] == f"benchmark/configs/{CONFIG}.json"
    assert conf["reduced"] == []
    (entry,) = [w for w in SPEC["workloads"] if w["name"] == CELL]
    assert (entry["config"], entry["traffic"], entry["chips"]) == \
        (CONFIG, CELL, 1)
    config = harness.load_part(BENCH, "configs", CONFIG)
    traffic = harness.load_part(BENCH, "workloads", CELL)
    assert config["name"] == traffic["config"] == CONFIG
    assert config["field_coding"] == "all-field PAFF"
    assert (config["mb_width"], config["mb_height"], config["map_units"]) \
        == (120, 68, 34)
    assert config["stream_sets"]["broadcast1080i"]["streams"] == \
        list(STREAMS) == traffic["streams"]
    assert traffic["why"] == entry["why"]
    assert (traffic["lanes"], traffic["streams_per_call"],
            traffic["output"]) == (32, 2, "device")
    for trace in (False, True):
        for m in harness.metrics_for(SPEC, CELL, trace):
            assert callable(harness.reader(BENCH, m["name"]))


@pytest.mark.parametrize("name", STREAMS)
def test_field_golden(name):
    """The golden pins the bytes, reads one letter a field as the harness
    reads the bytes, and two a woven frame: 12 frames, 24 fields."""
    g = json.loads((BENCH / "data" / f"{name}.json").read_text())
    data = (REPO / g["file"]).read_bytes()
    assert hashlib.sha256(data).hexdigest() == g["sha256"]
    assert len(data) == g["bytes"]
    s = lanes.load_stream(name)
    kinds, idr = lanes.structure(data)
    assert kinds == s.structure == "".join(k + k for k in "IPBBPBBPBBPB")
    assert idr == g["idr"] == [0]
    assert len(kinds) == 2 * s.frames == 2 * g["frames"] == 24
    assert (s.width, s.height) == (1920, 1080)
    # the MD5s are libavcodec's, as the writer's JSON holds them
    meta = json.loads((REPO / "tests" / "data" / f"{name}.json").read_text())
    assert list(s.md5) == meta["md5"]
    # the warm-up's prefix ends on a lone field
    assert lanes.warm_pictures(s) == 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """benchkit's root with a cell of 4 lanes over two 6 x 4 MB field
    streams (96 x 128 frames), frames on the device."""
    tmp = tmp_path_factory.mktemp("bench")
    root = benchkit.make_root(tmp, {n: benchkit.qcif_golden(n)
                                    for n in SMALL})
    (root / "configs" / "h264-fieldsmall.json").write_text(json.dumps(
        {"name": "h264-fieldsmall", "mb_width": 6, "mb_height": 8}))
    (root / "workloads" / f"{SMALL_CELL}.json").write_text(json.dumps(
        {"config": "h264-fieldsmall", "chips": 1, "why": "CPU tests",
         "streams": list(SMALL), "lanes": 4, "streams_per_call": 2,
         "output": "device"}))
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": SMALL_CELL,
                              "config": "h264-fieldsmall",
                              "traffic": SMALL_CELL, "chips": 1,
                              "why": "CPU tests"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("control", [False, True])
def test_field_cell_run(root, control):
    """A sound run is correct, every frame a woven pair equal to its
    golden; the control reads every attempted frame wrong."""
    res, compared = harness.run_cell(SMALL_CELL, 2 ** 31 + 27, 1.0, False,
                                     time.perf_counter(), device="cpu",
                                     root=root, control=control)
    assert res["attempted"] == res["run"]["frames"] > 0
    # a round a field: 2 rounds a frame of each of the 4 lanes
    assert 4 * res["run"]["rounds"] == 2 * res["attempted"]
    if control:
        assert not res["correct"]
        assert compared["frames_wrong"]["value"] == res["attempted"]
    else:
        assert res["correct"] and res["failed"] == 0
        assert all(c["value"] == 0 for c in compared.values())
