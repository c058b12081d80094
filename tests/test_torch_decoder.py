"""The port's slice as a whole: arrow_h264_tpu_torch.api.Decoder on the CPU
decodes real streams byte-identically to the JAX package's Decoder and to
the libavcodec golden; the committed 1080p and 1080i streams match their
committed golden hashes, and the 1080i ones are what tools/field_smoke.py
makes."""

import hashlib
import json
from pathlib import Path
import numpy as np
import pytest
import torch

from arrow_h264_tpu_torch.api import Decoder
from tests.torch_ref import decode_jax, decode_port, encode
from tools import field_smoke, streams

DATA = Path(__file__).resolve().parent / "data"
# the committed 1080p (tools/smoke_stream.py) and 1080i PAFF
# (tools/field_smoke.py) streams that chip_smoke.py decodes, and their
# frame counts
STREAMS_1080P = {"smoke_1080p_high": 6, "batch_1080p_s1": 6,
                 "batch_1080p_s2": 5, "batch_1080p_s3": 4,
                 "field_1080i_s0": 4, "field_1080i_s1": 3}


@pytest.mark.parametrize("cfg", [1, 2, 4])
def test_decoder_matches_jax_and_golden(h264ref, tmp_path, cfg):
    """Config 1 (Baseline intra), 2 (Baseline P, quarter-pel MC), 4 (High:
    CABAC, 8x8 transform, B-frames, weighted prediction)."""
    path = encode(tmp_path, cfg, n_frames=5, seed=30 + cfg)
    golden, _, _ = streams.golden_decode(path)
    ours = decode_port(path)
    assert ours.shape == golden.shape
    for f in range(len(golden)):
        assert np.array_equal(ours[f], golden[f]), \
            f"frame {f}: {int((ours[f] != golden[f]).sum())} byte diffs"
    assert np.array_equal(ours, decode_jax(path))


@pytest.mark.parametrize("name", STREAMS_1080P)
def test_smoke_stream_golden(h264ref, name):
    """Each committed 1080p (1080i) stream still decodes (libavcodec) to
    the committed per-frame MD5s that chip_smoke.py checks the port
    against."""
    path = DATA / f"{name}.264"
    meta = json.loads(path.with_suffix(".json").read_text())
    golden, w, h = streams.golden_decode(str(path))
    assert (w, h, len(golden)) == (meta["width"], meta["height"],
                                   meta["frames"]) \
        == (1920, 1080, STREAMS_1080P[name])
    assert [hashlib.md5(f.tobytes()).hexdigest() for f in golden] \
        == meta["md5"]


def test_decoder_device_is_explicit():
    """Decoder() defaults to CUDA and refuses to run without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Decoder()
    assert Decoder(device="cpu").device == torch.device("cpu")


def test_decoder_order_checked_at_construction():
    with pytest.raises(ValueError, match="order 'bogus'"):
        Decoder(device="cpu", order="bogus")
    assert Decoder(device="cpu", order="raster").order == "raster"



@pytest.mark.parametrize("name", field_smoke.STREAMS)
def test_field_smoke_streams_regenerate(name):
    """tools/field_smoke.py makes the committed 1080i streams byte for
    byte (their golden MD5s hold for what it writes)."""
    structure, qp, seed = field_smoke.STREAMS[name]
    assert field_smoke.make_field_smoke_stream(
        field_smoke.HD_MB_W, field_smoke.HD_MAP_UNITS, structure, qp, seed,
        crop_bottom=2) == (DATA / f"{name}.264").read_bytes()
