"""The port's CLI (`python -m arrow_h264_tpu_torch`), SEI and traces on the
CPU: the tests of the JAX package's tests/test_cli_sei.py and
tests/test_trace_se.py with the port; the port's JSONL trace, SE log and
SEI messages equal to the JAX Decoder's on one stream; and
tools/feature_streams.py rebuilding the small committed streams byte for
byte."""

import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from arrow_h264_tpu_torch.__main__ import main
from arrow_h264_tpu_torch.api import Decoder
from arrow_h264_tpu_torch.bitstream import nal
from arrow_h264_tpu_torch.bitstream.bits import BitWriter
from arrow_h264_tpu_torch.bitstream.sei import (
    SEI_RECOVERY_POINT, SEIMessage, parse_sei_rbsp, write_sei_rbsp,
)
from tests.torch_ref import JaxDecoder
from tools import feature_streams, streams

DATA = Path(__file__).resolve().parent / "data"


def _encode(tmp_path, name, w, h, n, seed, opts) -> str:
    path = str(tmp_path / f"{name}.264")
    streams.encode(streams.make_content(w, h, n, seed=seed), w, h, path,
                   opts)
    return path


def test_sei_roundtrip_and_fields():
    """tests/test_cli_sei.py:13 with the port's SEI parser and writer."""
    w = BitWriter()
    w.ue(3)      # recovery_frame_cnt
    w.u(1, 1)    # exact_match_flag
    w.u(0, 1)    # broken_link_flag
    w.u(2, 2)    # changing_slice_group_idc
    w.u(0, (8 - w.bitpos % 8) % 8)
    msgs = [SEIMessage(SEI_RECOVERY_POINT, w.get_bytes()),
            SEIMessage(300, b"\x01\x02\x03" * 100)]   # long type and size
    rt = parse_sei_rbsp(write_sei_rbsp(msgs))
    assert [m.payload_type for m in rt] == [SEI_RECOVERY_POINT, 300]
    assert rt[0].fields["recovery_frame_cnt"] == 3
    assert rt[0].fields["exact_match_flag"] == 1
    assert rt[1].payload == msgs[1].payload


def test_decoder_collects_x264_sei(h264ref, tmp_path):
    """tests/test_cli_sei.py:34: x264's user-data SEI is collected."""
    path = _encode(tmp_path, "sei", 176, 144, 1, 3, streams.CONFIG_OPTS[1])
    data = open(path, "rb").read()
    assert any(u.nal_unit_type == nal.NAL_SEI for u in nal.parse_annexb(data))
    dec = Decoder(device="cpu", entropy="python")
    list(dec.decode_annexb(data))
    assert dec.sei_messages, "x264 userdata SEI should be collected"


@pytest.mark.parametrize("order", ["phase", "raster"])
def test_cli_decode_matches_golden(h264ref, tmp_path, capsys, order):
    """tests/test_cli_sei.py:46: `decode --ref` on the CPU writes the
    golden and exits 0, with a JSONL record an MB and SE records of every
    picture in the trace files; a reference with a flipped byte, one cut
    short and one with an extra frame each exit 1; `info` exits 0."""
    path = _encode(tmp_path, "cli", 176, 144, 3, 9, streams.CONFIG_OPTS[2])
    golden, _, _ = streams.golden_decode(path)
    ref, out = tmp_path / "golden.yuv", str(tmp_path / "out.yuv")
    ref.write_bytes(golden.tobytes())
    args = ["decode", path, out, "--device", "cpu", "--order", order]
    trace, se = tmp_path / "t.jsonl", tmp_path / "se.txt"
    assert main(args + ["--ref", str(ref), "--entropy", "python", "--psnr",
                        "--trace", str(trace), "--trace-se", str(se)]) == 0
    assert open(out, "rb").read() == golden.tobytes()
    assert sum(json.loads(ln)["t"] == "mb" for ln in open(trace)) \
        == 3 * 11 * 9
    assert {ln.split()[1] for ln in open(se)} == {"0", "1", "2"}
    said = capsys.readouterr().out
    assert "bit-exact vs reference YUV" in said
    assert f"on cpu, order {order}, incl. host entropy" in said
    assert "SNR Y inf dB  U inf dB  V inf dB" in said
    flipped = bytearray(golden.tobytes())
    flipped[len(flipped) // 2] ^= 1
    for bad in (bytes(flipped), golden.tobytes()[:-1],
                golden.tobytes() + golden[0].tobytes()):
        ref.write_bytes(bad)
        assert main(args + ["--ref", str(ref)]) == 1
    assert main(["info", path]) == 0
    assert "SPS 0: profile 66" in capsys.readouterr().out


def test_cli_device_cuda_needs_a_card(h264ref, tmp_path):
    """No fallback: `--device cuda` (the default) without a card raises
    the Decoder's RuntimeError."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = _encode(tmp_path, "nocard", 64, 64, 1, 1, streams.CONFIG_OPTS[1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["decode", path, str(tmp_path / "out.yuv")])


def test_decode_trace_jsonl(h264ref, tmp_path):
    """tests/test_cli_sei.py:61: one JSONL record a slice and an MB."""
    w, h = 64, 64
    path = _encode(tmp_path, "t", w, h, 2, 9, streams.CONFIG_OPTS[2])
    tpath = tmp_path / "trace.jsonl"
    dec = Decoder(device="cpu", trace=str(tpath))
    list(dec.decode_annexb(open(path, "rb").read()))
    recs = [json.loads(ln) for ln in open(tpath)]
    slices = [r for r in recs if r["t"] == "slice"]
    mbs = [r for r in recs if r["t"] == "mb"]
    assert len(slices) >= 2
    assert len(mbs) == 2 * (w // 16) * (h // 16)
    assert all("kind" in r and "qp" in r for r in mbs)
    assert any("mv" in r for r in mbs if r["frame"] == 1)


def test_trace_se(h264ref, tmp_path):
    """tests/test_cli_sei.py:84: the SE trace on the C++ engine logs
    every entropy read; two runs give the same log; bit positions rise
    within a slice."""
    opts = ["profile=main", "qp=30", "g=250", "bf=0", "refs=1",
            f"x264-params=cabac=1:{streams.X264_COMMON}"]
    data = open(_encode(tmp_path, "t", 176, 144, 2, 5, opts), "rb").read()
    logs = []
    for run in range(2):
        p = tmp_path / f"se{run}.txt"
        dec = Decoder(device="cpu", trace_se=str(p))
        assert dec.entropy == "cpp"
        assert sum(1 for _ in dec.decode_annexb(data)) == 2
        logs.append(p.read_text())
    assert logs[0] == logs[1]
    lines = logs[0].splitlines()
    assert len(lines) > 1000
    assert {"cab", "ue"} <= {ln.split()[3] for ln in lines}
    prev_key, prev_pos = None, -1
    for ln in lines:
        _, fr, sl, kind, pos, nbits, val = ln.split()
        if (fr, sl) != prev_key:
            prev_key, prev_pos = (fr, sl), -1
        assert int(pos) >= prev_pos, ln
        prev_pos = int(pos)


@pytest.mark.parametrize("cfg", [2, 3])
def test_trace_se_cpp_matches_python(h264ref, tmp_path, cfg):
    """tests/test_trace_se.py:28: the C++ and Python engines log the same
    syntax elements, P CAVLC (config 2) and B CABAC (config 3)."""
    data = open(_encode(tmp_path, f"c{cfg}", 176, 144, 4, 100 + cfg,
                        streams.CONFIG_OPTS[cfg]), "rb").read()
    traces = {}
    for engine in ("cpp", "python"):
        sink = io.StringIO()
        dec = Decoder(device="cpu", entropy=engine, trace_se=sink)
        assert dec.entropy == engine
        for _ in dec.decode_annexb(data):
            pass
        traces[engine] = sink.getvalue().splitlines()
    assert len(traces["cpp"]) > 1000, "trace suspiciously short"
    for i, (a, b) in enumerate(zip(traces["cpp"], traces["python"])):
        assert a == b, f"first trace divergence at record {i}: {a!r} != {b!r}"
    assert len(traces["cpp"]) == len(traces["python"])


def test_traces_and_sei_match_jax(h264ref, tmp_path):
    """The port's JSONL trace and SE log are byte-equal to the JAX
    Decoder's for one stream (config 4: CABAC, B pictures, weighted
    prediction), but for the port's own record of each picture's upload,
    and its SEI messages equal the JAX package's field by field."""
    data = open(_encode(tmp_path, "j", 64, 64, 3, 21,
                        streams.CONFIG_OPTS[4]), "rb").read()
    logs, seis = {}, {}
    for name, cls, kw in (("port", Decoder, {"device": "cpu"}),
                          ("jax", JaxDecoder, {})):
        t, se = io.StringIO(), io.StringIO()
        dec = cls(trace=t, trace_se=se, **kw)
        frames = [f.planar() for f in dec.decode_annexb(data)]
        logs[name] = (t.getvalue(), se.getvalue(), frames)
        seis[name] = [(m.payload_type, m.payload, m.fields)
                      for m in dec.sei_messages]
    trace, se, frames = logs["port"]
    lines = trace.splitlines(keepends=True)
    ups = [json.loads(ln) for ln in lines if '"t": "upload"' in ln]
    assert [(r["frame"], r["mode"]) for r in ups] == \
        [(i, "wire") for i in range(len(frames))]
    logs["port"] = ("".join(ln for ln in lines if '"t": "upload"' not in ln),
                    se, frames)
    assert logs["port"][0].count("\n") > 50
    assert logs["port"][1].count("\n") > 1000
    assert logs["port"] == logs["jax"]
    assert seis["port"] and seis["port"] == seis["jax"]


@pytest.mark.parametrize("name", [n for n in feature_streams.STREAMS
                                  if n not in feature_streams.LARGE])
def test_feature_streams_regenerate(h264ref, name):
    """tools/feature_streams.py rebuilds each small committed feature
    stream byte for byte (the 1080p ones are held by their MD5s)."""
    assert feature_streams.stream_bytes(name) == \
        (DATA / f"{name}.264").read_bytes()
