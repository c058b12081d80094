"""Lossless bypass, the CIF configs and the width classes through the
port's Decoder on the CPU: the same x264 streams as the JAX package's
tests/test_device_pipeline.py and tests/test_device_widths.py, each held
to the libavcodec golden as the JAX package is (at QCIF also to the JAX
Decoder itself), and lanes of different DPB sizes in one BatchDecoder.
Every comparison is exact."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
from tests.torch_ref import decode_jax, decode_port
from tools import feature_streams, streams

DATA = Path(__file__).resolve().parent / "data"


def _encode(tmp_path, name: str) -> str:
    """Encode feature stream `name` (tools/feature_streams.py) here."""
    path = tmp_path / f"{name}.264"
    path.write_bytes(feature_streams.stream_bytes(name))
    return str(path)


def _assert_frames(ours, golden, what=""):
    assert ours.shape == golden.shape, (what, ours.shape, golden.shape)
    for f in range(len(golden)):
        assert np.array_equal(ours[f], golden[f]), \
            f"{what} frame {f}: {int((ours[f] != golden[f]).sum())} byte diffs"


def test_lossless_bypass_cabac(h264ref, tmp_path):
    """FRExt lossless (qpprime_y_zero_transform_bypass_flag), CABAC with
    I_PCM MBs at QP 0 and B frames (tests/test_device_pipeline.py:102):
    equal to the golden, to the encoder's input and to the JAX Decoder."""
    path = _encode(tmp_path, "feat_lossless_qcif")
    golden, _, _ = streams.golden_decode(path)
    ours = decode_port(path)
    _assert_frames(ours, golden)
    _, (w, h), n, seed, _, noise, _ = \
        feature_streams.STREAMS["feat_lossless_qcif"]
    assert np.array_equal(ours, streams.make_content(w, h, n, seed=seed,
                                                     noise=noise))
    assert np.array_equal(ours, decode_jax(path))


def test_lossless_cavlc_dpcm_cropped(h264ref, tmp_path):
    """Lossless CAVLC at 164x132 (tests/test_device_pipeline.py:127): I4x4
    and I8x8 DPCM, cropping of a width that is not a whole number of MBs
    under bypass."""
    path = _encode(tmp_path, "feat_lossless_164x132")
    golden, w, h = streams.golden_decode(path)
    assert (w, h) == (164, 132)
    _assert_frames(decode_port(path), golden)


@pytest.mark.parametrize("cfg", [2, 3, 4])
def test_cif_configs(h264ref, tmp_path, cfg):
    """Configs 2-4 at CIF, mb_w 22 (tests/test_device_pipeline.py:143);
    config 3 is Main CABAC with B frames, 4 High."""
    path = _encode(tmp_path, f"feat_cif_cfg{cfg}")
    golden, _, _ = streams.golden_decode(path)
    _assert_frames(decode_port(path), golden, f"config {cfg}")


@pytest.mark.parametrize("name", ["feat_w512", "feat_w976"])
def test_width_classes_p(h264ref, tmp_path, name):
    """Baseline P at 512x80 and 976x64, mb_w 32 and 61
    (tests/test_device_widths.py:36)."""
    path = _encode(tmp_path, name)
    golden, _, _ = streams.golden_decode(path)
    _assert_frames(decode_port(path), golden, name)


def test_width_512_high_cabac(h264ref, tmp_path):
    """512x80 through High/CABAC, 8x8 transform and B frames
    (tests/test_device_widths.py:51), with both orders."""
    path = _encode(tmp_path, "feat_w512_high")
    golden, _, _ = streams.golden_decode(path)
    for order in ("phase", "raster"):
        _assert_frames(decode_port(path, order=order), golden, order)


def test_batch_lanes_of_different_dpb_sizes():
    """BatchDecoder(2) over a lane of one reference (feat_qcif_cfg2, 2 DPB
    slots) beside one of four (batch_qcif_s3, 5 slots): both lanes equal
    their golden MD5s.  The batch's DPB takes the most slots that a lane
    of the first round needs; with lane 0's 2, lane 1 failed when it
    stored its third reference picture."""
    names = ["feat_qcif_cfg2", "batch_qcif_s3"]
    with BatchDecoder(2, device="cpu") as bd:
        outs = bd.decode([(DATA / f"{n}.264").read_bytes() for n in names])
    assert bd.errors == [None, None]
    assert bd.n_slots == 5
    for n, frames in zip(names, outs):
        meta = json.loads((DATA / f"{n}.json").read_text())
        assert [hashlib.md5(f.planar()).hexdigest() for f in frames] \
            == meta["md5"], n


def test_batch_lane_that_outgrows_the_dpb_fails_alone():
    """A lane whose stream switches later to an SPS that needs more DPB
    slots than the batch holds fails with a ValueError that says so (its
    three decoded pictures were still waiting in its DPB for output, so
    it gives no frame); the other lane stays exact."""
    one_ref, four_refs = ((DATA / f"{n}.264").read_bytes()
                          for n in ("feat_qcif_cfg2", "batch_qcif_s3"))
    with BatchDecoder(2, device="cpu") as bd:
        outs = bd.decode([one_ref + four_refs, one_ref])
    assert bd.n_slots == 2
    assert isinstance(bd.errors[0], ValueError)
    assert "5 DPB slots, more than the 2" in str(bd.errors[0])
    assert bd.errors[1] is None
    md5 = json.loads((DATA / "feat_qcif_cfg2.json").read_text())["md5"]
    assert [hashlib.md5(f.planar()).hexdigest() for f in outs[1]] == md5
    assert outs[0] == []
