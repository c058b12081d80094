"""The conformance gate of the port on the CPU: the committed conformance
streams (tools/conformance_streams.py: configs 1-6 of
tools/tpu_conformance.py, the second 4K lane, the 720p GOP lanes) still
decode (libavcodec) to their committed MD5s and are rebuilt byte for
byte; the port's Decoder(device="cpu") equals them on the small configs
with both orders; tools/gpu_conformance.py passes on the CPU and refuses
to run on a card that is not there.  Every comparison is exact."""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import pytest

from tests.torch_ref import decode_port
from tools import conformance_streams, streams

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
# the committed streams and (width, height, frames) of each
SHAPES = {"conf_c1": (176, 144, 3), "conf_c2": (352, 288, 5),
          "conf_c3": (1280, 720, 5), "conf_c4": (1920, 1088, 5),
          "conf_c5": (3840, 2160, 3), "conf_c6": (352, 288, 4),
          "batch_2160p_s1": (3840, 2160, 2), "gop_720p_s0": (1280, 720, 8),
          "gop_720p_s1": (1280, 720, 8)}
# the configs small enough to decode with the plain versions here
CPU_CONFIGS = (1, 2, 6)


def _meta(name: str) -> dict:
    return json.loads((DATA / f"{name}.json").read_text())


def test_streams_are_the_generators():
    """The test's list is the generator's, and the nine streams stay
    within 12 MB together."""
    assert set(SHAPES) == set(conformance_streams.STREAMS)
    total = sum((DATA / f"{n}{ext}").stat().st_size for n in SHAPES
                for ext in (".264", ".json"))
    assert total <= 12_000_000, total


@pytest.mark.parametrize("name", SHAPES)
def test_conformance_stream_golden(h264ref, name):
    """Each committed stream decodes (libavcodec) to its committed
    per-frame MD5s, at its shape, with the structure and IDRs its JSON
    states."""
    path = DATA / f"{name}.264"
    meta = _meta(name)
    golden, w, h = streams.golden_decode(str(path))
    assert (w, h, len(golden)) == (meta["width"], meta["height"],
                                   meta["frames"]) == SHAPES[name]
    assert [hashlib.md5(f.tobytes()).hexdigest() for f in golden] \
        == meta["md5"]
    assert conformance_streams.structure(path.read_bytes()) \
        == (meta["structure"], meta["idr"])


@pytest.mark.parametrize("name", SHAPES)
def test_conformance_streams_regenerate(h264ref, name):
    """tools/conformance_streams.py rebuilds each committed stream byte
    for byte."""
    assert conformance_streams.stream_bytes(name) == \
        (DATA / f"{name}.264").read_bytes()


def test_gop_lanes_mix_idr_and_inter_rounds():
    """The two 720p lanes have two GOPs each, with their IDRs in
    different rounds: a lockstep round puts an IDR lane beside a P/B
    lane."""
    lanes = [_meta(f"gop_720p_s{i}") for i in (0, 1)]
    assert all(len(m["idr"]) >= 2 for m in lanes)
    mixed = [k for k in range(8)
             if any(k in m["idr"] for m in lanes)
             and any(m["structure"][k] in "PB" for m in lanes)]
    assert mixed == [4, 6]


@pytest.mark.parametrize("order", ["phase", "raster"])
@pytest.mark.parametrize("cfg", CPU_CONFIGS)
def test_decoder_cpu_conformance(cfg, order):
    """Decoder(device="cpu") with each order over configs 1, 2 and 6:
    every frame's MD5 equals the committed golden."""
    ours = decode_port(str(DATA / f"conf_c{cfg}.264"), order=order)
    assert [hashlib.md5(f.tobytes()).hexdigest() for f in ours] \
        == _meta(f"conf_c{cfg}")["md5"]


def _gate(*args):
    return subprocess.run([sys.executable, "tools/gpu_conformance.py",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def test_gpu_conformance_cpu():
    """tools/gpu_conformance.py 1 2 6 --device cpu exits 0 with one
    BIT-EXACT line a config and ALL BIT-EXACT."""
    r = _gate(*map(str, CPU_CONFIGS), "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "ALL BIT-EXACT"
    assert [ln.split()[1] for ln in lines if ln.endswith("BIT-EXACT")
            and ln.startswith("config")] == ["1", "2", "6"]


def test_gpu_conformance_needs_card():
    """Without a card the gate's default device raises, as Decoder()
    does: exit non-zero, no verdict."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _gate("1")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "BIT-EXACT" not in r.stdout


def test_gpu_conformance_reports_a_difference(monkeypatch):
    """A decoded frame with one byte flipped makes the gate name the frame
    and its differing bytes, say CONFORMANCE FAILURES and return 1."""
    from arrow_h264_tpu_torch.api import Frame
    from tools import gpu_conformance
    planar, calls = Frame.planar, []

    def flipped(self):
        b = planar(self)
        calls.append(1)
        return b if len(calls) != 2 else bytes([b[0] ^ 1]) + b[1:]

    monkeypatch.setattr(Frame, "planar", flipped)
    lines = []
    monkeypatch.setattr("builtins.print", lambda s, **kw: lines.append(s))
    assert gpu_conformance.main(["1", "--device", "cpu"]) == 1
    assert lines[-1] == "CONFORMANCE FAILURES"
    assert lines[-2].endswith("FAIL, lane 0 (conf_c1) frames 1 (1 bytes) "
                              "differ")
