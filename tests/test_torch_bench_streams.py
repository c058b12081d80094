"""The port's bench stream sets (`python -m arrow_h264_tpu_torch.bench
--streams qp26|broadcast|adversarial|uhd`) and its adversarial host stage,
on the CPU: the committed bench_broadcast_s0..s3 and bench_adversarial
streams (tools/bench_streams.py) against their JSON, their recipe and the
12 MB budget; each set's lanes and warm-up prefix; and
host_parse_adversarial_fps on a 2-picture prefix.  No test decodes a
whole 1080p stream."""

import json
import os

import numpy as np
import pytest

from arrow_h264_tpu_torch import bench
from arrow_h264_tpu_torch.api import crop_planes
from arrow_h264_tpu_torch.bitstream import nal
from arrow_h264_tpu_torch.bitstream.params import parse_sps
from arrow_h264_tpu_torch.models.pipeline import dpb_slots
from tools import bench_streams
from tools.conformance_streams import structure

STAT_KEYS = {"median", "min", "max"}
SETS = {
    "qp26": ["smoke_1080p_high", "batch_1080p_s1", "batch_1080p_s2",
             "batch_1080p_s3"],
    "broadcast": [f"bench_broadcast_s{s}" for s in range(4)],
    "adversarial": ["bench_adversarial"],
    "uhd": ["conf_c5"] * 4,
}


def _sps(data: bytes):
    return next(parse_sps(u.rbsp) for u in nal.parse_annexb(data)
                if u.nal_unit_type == nal.NAL_SPS)


def _pictures(data: bytes) -> int:
    """Coded pictures (single-slice streams: slice NALs)."""
    return sum(u.is_slice for u in nal.parse_annexb(data))


@pytest.mark.parametrize("name", list(bench_streams.STREAMS))
def test_bench_stream_json(name):
    """Each committed stream's JSON matches the stream (frame count, SPS
    size, structure, IDRs) and the recipe of its JAX-package source, with
    no cuts."""
    path = bench.DATA / f"{name}.264"
    data = path.read_bytes()
    meta = json.loads(path.with_suffix(".json").read_text())
    n, opts, seed, noise, source = bench_streams.STREAMS[name]
    assert meta["frames"] == len(meta["md5"]) == n == _pictures(data)
    assert len(set(meta["md5"])) == n
    sps = _sps(data)
    h, w = sps.height, sps.width
    y, _, _ = crop_planes(sps, np.zeros((h, w), np.uint8),
                          *[np.zeros((h // 2, w // 2), np.uint8)] * 2)
    assert (meta["width"], meta["height"]) == (y.shape[1], y.shape[0]) == \
        (bench_streams.W, bench_streams.H) == (sps.width, sps.height)
    assert (meta["structure"], meta["idr"]) == structure(data)
    assert meta["idr"] == [0]
    assert meta["content"] == (
        f"streams.make_content({bench_streams.W}, {bench_streams.H}, {n}, "
        f"seed={seed}, noise={noise})")
    assert meta["x264_opts"] == opts and meta["cuts"] == []
    assert meta["source"] == source
    assert meta["command"] == f"python tools/bench_streams.py {name}"
    if name.startswith("bench_broadcast"):
        # one GOP of 12 pictures over 4 references: the DPB fills and slides
        assert sps.max_num_ref_frames == 4 and dpb_slots(sps) == 5
        assert set(meta["structure"][1:]) == {"P", "B"}


def test_bench_streams_budget():
    """The two sets add at most 12 MB to tests/data."""
    total = sum((bench.DATA / f"{n}{ext}").stat().st_size
                for n in bench_streams.STREAMS for ext in (".264", ".json"))
    assert total <= bench_streams.BUDGET == 12 * 10 ** 6


@pytest.mark.parametrize("name", list(SETS))
def test_stream_set_lanes(name):
    """Each --streams set loads its documented streams, and its lanes cycle
    through them (at B = 32, 8 lanes a broadcast stream, as the JAX
    package's bench.py cycles them)."""
    assert list(bench.STREAM_SETS[name]) == SETS[name]
    lanes = bench.load_lanes(bench.set_paths(name))
    assert [lane.name for lane in lanes] == SETS[name]
    for lane in lanes:
        meta = json.loads((bench.DATA / f"{lane.name}.json").read_text())
        assert lane.md5 == meta["md5"]
    b = 4 if name == "uhd" else bench.BATCH
    cyc = bench.cycle_lanes(lanes, b)
    assert [lane.name for lane in cyc] == \
        [SETS[name][i % len(SETS[name])] for i in range(b)]
    if name == "broadcast":
        assert all(sum(lane.name == s for lane in cyc) == 8
                   for s in SETS[name])


@pytest.mark.parametrize("name,aus", [("qp26", 3), ("broadcast", 3),
                                      ("adversarial", 3), ("uhd", 2)])
def test_warm_up_prefix(name, aus):
    """The warm-up's prefix is WARM_AUS pictures, but one fewer than the
    shortest lane's, so uhd's 3-picture lanes warm up on 2 and no warm-up
    decodes a whole stream."""
    lanes = bench.load_lanes(bench.set_paths(name))
    assert bench.warm_aus(lanes) == aus
    for lane in lanes:
        assert _pictures(bench.truncate_aus(lane.data, aus)) == aus \
            < len(lane.md5)


def test_host_parse_adversarial_fps():
    """The adversarial host stage on a 2-picture prefix of
    bench_adversarial, and its three medians in the summary."""
    adv = bench.load_lanes(bench.set_paths("adversarial"))[0]
    lane = bench.Lane(adv.name, bench.truncate_aus(adv.data, 2), adv.md5[:2])
    res = bench.host_parse_adversarial_fps(repeats=1, lanes=[lane])
    assert res["stage"] == res["metric"] == "host_parse_adversarial_fps"
    assert res["stream_set"] == "adversarial"
    assert res["unit"] == "frames/s on one host thread"
    assert res["repeats"] == 1 and res["frames"] == 2
    assert res["streams"] == ["bench_adversarial"]
    assert res["kbit_per_frame"] == 8 * len(lane.data) / 2 / 1e3
    assert STAT_KEYS <= res.keys()
    assert 0 < res["min"] <= res["median"] <= res["max"]
    assert 0 < res["gil_hold_pct"]["median"] <= 100
    cores = os.cpu_count()
    assert res["host"]["cores"] == cores
    assert res["projected_fps_at_cores"]["max"] <= \
        cores * res["max"] * (1 + 1e-9)
    assert "device" not in res
    parse = {"metric": "host_parse_fps", "median": 9.0,
             "gil_hold_pct": {"median": 8.0},
             "projected_fps_at_cores": {"median": 7.0}}
    s = bench.summary([parse, res], "phase", "wire", 32, 1, "broadcast")
    assert s["stream_set"] == "broadcast"
    assert s["medians"] == {
        "host_parse_fps": 9.0, "gil_hold_pct": 8.0,
        "projected_fps_at_cores": 7.0,
        "host_parse_adversarial_fps": res["median"],
        "adversarial_gil_hold_pct": res["gil_hold_pct"]["median"],
        "adversarial_projected_fps_at_cores":
            res["projected_fps_at_cores"]["median"]}


def test_cli_host_stages_name_the_set(tmp_path, monkeypatch, capsys):
    """The command line's host stages run without a card; each lane stage's
    line and the summary carry the --streams set's name (the stages' own
    work is stubbed: the real ones are timed above and in
    tests/test_torch_bench.py)."""
    def fake(lanes, repeats=1, upload="wire"):
        return {"stage": "host_parse_fps", "metric": "host_parse_fps",
                "median": 1.0, "gil_hold_pct": {"median": 2.0},
                "projected_fps_at_cores": {"median": 3.0},
                "streams": [lane.name for lane in lanes]}
    monkeypatch.setattr(bench, "host_parse_fps", fake)
    out = tmp_path / "b.json"
    bench.main(["--stage", "host_parse_fps", "--stage",
                "host_parse_adversarial_fps", "--streams", "broadcast",
                "--repeats", "1", "--out", str(out)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln.get("stage") for ln in lines[:-1]] == [
        "host_parse_fps", "host_parse_adversarial_fps"]
    assert lines[0]["stream_set"] == "broadcast"
    assert lines[0]["streams"] == SETS["broadcast"]
    assert lines[1]["stream_set"] == "adversarial"
    assert lines[1]["streams"] == ["bench_adversarial"]
    assert lines[-1]["stream_set"] == "broadcast"
    assert lines[-1]["device"] is None and lines[-1]["run_s"] > 0
    assert json.loads(out.read_text())["summary"] == lines[-1]


@pytest.mark.parametrize("name", ["bench_adversarial", "bench_broadcast_s0"])
def test_bench_streams_regenerate(name):
    """tools/bench_streams.py rebuilds the committed streams byte for byte
    (x264 through tools/h264ref; one of each recipe)."""
    want = (bench.DATA / f"{name}.264").read_bytes()
    assert bench_streams.stream_bytes(name) == want
