"""The port's bench (arrow_h264_tpu_torch.bench) on the CPU at small sizes:
each stage function's result, its checks (goldens, frame counts, the
device-resident sums against the materialized frames) and the command
line's refusal to run a device stage without a card; the golden checks
also on the first picture of each new --streams set.  The cuda-marked
test runs every stage once on the card over each --streams set:

    python -m pytest --noconftest -m cuda tests/test_torch_bench.py
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from arrow_h264_tpu_torch import bench

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
QCIF = [DATA / f"batch_qcif_s{i}.264" for i in range(1, 5)]
B = 4
MB_W, MB_H = 8, 6

STAT_KEYS = {"median", "min", "max"}


@pytest.fixture(scope="module")
def lanes():
    return bench.load_lanes(QCIF)


@pytest.fixture(scope="module")
def e2e(lanes):
    return bench.e2e_fps(lanes, B, repeats=2, device="cpu")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_bench_imports_only_the_port():
    """bench.py imports neither JAX nor the JAX package nor tools/."""
    tree = ast.parse((REPO / "arrow_h264_tpu_torch" / "bench.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level]
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "arrow_h264_tpu", "tools"}, roots


def test_truncate_aus(lanes):
    """A prefix of k pictures keeps the parameter sets and decodes to k
    frames; k past the end is the whole stream."""
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.bitstream.nal import split_annexb
    data = lanes[2].data
    assert list(split_annexb(bench.truncate_aus(data, 99))) == \
        list(split_annexb(data))
    got = list(Decoder(device="cpu").decode_annexb(
        bench.truncate_aus(data, 3)))
    assert len(got) == 3


@pytest.mark.parametrize("upload", ["wire", "dense"])
def test_host_parse_fps(lanes, upload):
    res = bench.host_parse_fps(lanes[:1], repeats=2, upload=upload)
    assert res["metric"] == "host_parse_fps" and res["upload"] == upload
    assert res["unit"] == "frames/s on one host thread"
    assert res["repeats"] == 2 and res["frames"] == len(lanes[0].md5)
    assert STAT_KEYS <= res.keys()
    assert 0 < res["min"] <= res["median"] <= res["max"]
    assert 0 < res["gil_hold_pct"]["median"] <= 100
    cores = os.cpu_count()
    assert res["host"]["cores"] == cores
    proj = res["projected_fps_at_cores"]
    assert proj["max"] <= cores * res["max"] * (1 + 1e-9)
    assert "device" not in res


def test_e2e_fps(lanes, e2e):
    res, sums = e2e
    assert res["metric"] == "e2e_fps" and res["unit"] == "frames/s"
    assert STAT_KEYS <= res.keys()
    assert res["repeats"] == 2
    assert res["frames"] == sum(len(lanes[i % 4].md5) for i in range(B))
    assert res["rounds"] == max(len(lane.md5) for lane in lanes)
    assert (res["batch"], res["order"], res["upload"]) == (B, "phase",
                                                           "wire")
    assert [len(s) for s in sums] == [len(lanes[i % 4].md5)
                                      for i in range(B)]


def _edit_golden(tmp_path, how, streams=None):
    """The QCIF lanes with lane 1's golden edited: one MD5 altered, or one
    dropped.  With a --streams set: the first picture of the set's first
    stream, its first MD5 altered (a whole 1080p or 4K stream is too slow
    for the plain versions)."""
    if streams is None:
        paths, edit = [], 1
        for p in QCIF:
            for q in (p, p.with_suffix(".json")):
                shutil.copy(q, tmp_path / q.name)
            paths.append(tmp_path / p.name)
    else:
        lane = bench.load_lanes(bench.set_paths(streams))[0]
        paths, edit = [tmp_path / f"{lane.name}.264"], 0
        paths[0].write_bytes(bench.truncate_aus(lane.data, 1))
        paths[0].with_suffix(".json").write_text(
            json.dumps({"md5": lane.md5[:1]}))
    j = paths[edit].with_suffix(".json")
    g = json.loads(j.read_text())
    if how == "altered":
        g["md5"][edit] = "0" * 32
    else:
        g["md5"].pop()
    j.write_text(json.dumps(g))
    return bench.load_lanes(paths)


@pytest.mark.parametrize("stage,how,streams", [
    pytest.param("e2e_fps", "altered", None, id="e2e_fps-altered"),
    pytest.param("e2e_fps", "dropped", None, id="e2e_fps-dropped"),
    pytest.param("e2e_device_resident_fps", "altered", None,
                 id="e2e_device_resident_fps-altered"),
    *(pytest.param("e2e_fps", "altered", s, id=f"e2e_fps-altered-{s}")
      for s in ("broadcast", "adversarial", "uhd"))])
def test_e2e_golden_mismatch_raises(tmp_path, stage, how, streams):
    bad = _edit_golden(tmp_path, how, streams)
    fn = getattr(bench, stage)
    if streams is None:
        with pytest.raises(bench.BenchError, match="lane 1"):
            fn(bad, B, repeats=1, device="cpu")
    else:
        name = bench.STREAM_SETS[streams][0]
        with pytest.raises(bench.BenchError, match=rf"lane 0 \({name}\): "
                           r"MD5 differs from the golden at frames \[0\]"):
            fn(bad, 1, repeats=1, device="cpu")


def test_device_resident_sums_equal_materialized(lanes, e2e):
    """The resident stage's device plane sums equal the materialized
    frames' (it checks them itself); a wrong expectation raises."""
    _, sums = e2e
    res = bench.e2e_device_resident_fps(lanes, B, repeats=1, device="cpu",
                                        expect=sums)
    assert res["metric"] == "e2e_device_resident_fps"
    assert res["unit"] == "frames/s" and res["repeats"] == 1
    assert STAT_KEYS <= res.keys()
    assert res["frames"] == sum(map(len, sums))
    wrong = [list(s) for s in sums]
    y, cb, cr = wrong[3][0]
    wrong[3][0] = (y + 1, cb, cr)
    with pytest.raises(bench.BenchError, match=r"lanes \[3\]"):
        bench.e2e_device_resident_fps(lanes, B, repeats=1, device="cpu",
                                      expect=wrong)


@pytest.mark.parametrize("kind", ["recon", "wildmv", "intra"])
def test_device_stage(kind):
    res = bench.device_fps(kind, 2, repeats=2, device="cpu", mb_w=MB_W,
                           mb_h=MB_H)
    assert res["metric"] == f"device_{kind}_fps"
    assert res["unit"] == "frames/s" and res["repeats"] == 2
    assert STAT_KEYS <= res.keys() and STAT_KEYS <= res["host_ms"].keys()
    assert res["fps_from"] == "host clock (no CUDA device)"
    assert "event_ms" not in res
    assert res["batch"] == 2 and res["mb"] == [MB_W, MB_H]


def test_synthetic_lanes():
    """The wild lanes differ from the recon lanes' seeds only in the MVs
    of about 5 % of cells, some far outside the picture; intra lanes have
    no inter MB."""
    wild = bench.synthetic_lanes("wildmv", 2, MB_W, MB_H)
    from arrow_h264_tpu_torch.ops.synthetic import synthetic_abi_p
    base = synthetic_abi_p(MB_W, MB_H, seed=50, n_slots=bench.N_SLOTS)
    diff = (wild[0]["mv"] != base["mv"]).any((-1, -2))
    assert 0.02 < diff.mean() < 0.08
    assert abs(wild[0]["mv"]).max() > 400
    intra = bench.synthetic_lanes("intra", 2, MB_W, MB_H)
    from arrow_h264_tpu_torch.ops.abi import KIND_P
    assert all((a["kind"] < KIND_P).all() for a in intra)
    with pytest.raises(ValueError):
        bench.synthetic_lanes("patch", 1)


def test_d2h_needs_cuda():
    with pytest.raises(ValueError):
        bench.d2h_link_GBps(1, 1, device="cpu")


def test_summary_holds_each_median():
    results = [
        {"metric": "host_parse_fps", "median": 1.0,
         "gil_hold_pct": {"median": 2.0}, "projected_fps_at_cores":
         {"median": 3.0}},
        {"metric": "e2e_fps", "median": 4.0,
         "device": {"name": "card", "power_limit": "1 W"}}]
    s = bench.summary(results, "phase", "wire", 4, 1)
    assert s["medians"] == {"host_parse_fps": 1.0, "gil_hold_pct": 2.0,
                            "projected_fps_at_cores": 3.0, "e2e_fps": 4.0}
    assert s["device"] == {"name": "card", "power_limit": "1 W"}
    assert s["host_cores"] == os.cpu_count()


@pytest.mark.parametrize("stage", [s for s in bench.STAGES
                                   if s not in bench.HOST_STAGES])
def test_device_stage_exits_without_cuda(stage, capsys):
    """Without a card the command line refuses every device stage before
    printing any result."""
    _no_card()
    with pytest.raises(SystemExit) as e:
        bench.main(["--stage", stage])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_cli_without_cuda_exits_nonzero():
    _no_card()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-m", "arrow_h264_tpu_torch.bench",
                        "--stage", "e2e_fps"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA" in r.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("streams", list(bench.STREAM_SETS))
def test_bench_cuda(tmp_path, streams):
    """Every stage once on the card at B = 2, R = 1, over each --streams
    set, through the command line: a line a stage, then the summary; every
    check passed (rc 0), so every e2e frame equals its golden."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = tmp_path / "bench.json"
    r = subprocess.run([sys.executable, "-m", "arrow_h264_tpu_torch.bench",
                        "--streams", streams, "--batch", "2", "--repeats",
                        "1", "--out", str(out)],
                       cwd=REPO, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = [json.loads(ln) for ln in r.stdout.strip().splitlines()]
    assert [ln["stage"] for ln in lines[:-1]] == list(bench.STAGES)
    last = lines[-1]
    assert last["device"]["name"] == torch.cuda.get_device_name(0)
    assert last["stream_set"] == streams and last["run_s"] > 0
    assert set(last["medians"]) == set(bench.STAGES) | {
        "gil_hold_pct", "projected_fps_at_cores", "adversarial_gil_hold_pct",
        "adversarial_projected_fps_at_cores"}
    lanes = bench.cycle_lanes(bench.load_lanes(bench.set_paths(streams)), 2)
    for ln in lines[:-1]:
        stage = ln["stage"]
        if stage not in bench.HOST_STAGES:
            assert ln["device"] == last["device"]
        if stage in bench.LANE_STAGES:
            assert ln["stream_set"] == streams and ln["kbit_per_frame"] > 0
        if stage.startswith("e2e"):
            assert ln["frames"] == sum(len(lane.md5) for lane in lanes)
        if stage.startswith("device_"):
            assert ln["fps_from"] == "CUDA events around each call"
            assert STAT_KEYS <= ln["event_ms"].keys()
    assert lines[1]["stream_set"] == "adversarial"
    assert json.loads(out.read_text())["summary"] == last
