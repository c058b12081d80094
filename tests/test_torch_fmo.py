"""FMO / ASO through the port's Decoder on the CPU: the tests of the JAX
package's tests/test_fmo.py that decode, with the port.  The all-I_PCM
streams (tools/fmo_streams.py) are held to their authored content, the
FMO CAVLC pairs to libavcodec's decode of their raster twin, and the
committed 1080p FMO stream to its MD5s.  Every comparison is exact."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from arrow_h264_tpu_torch import api
from arrow_h264_tpu_torch.api import Decoder
from tests import torch_ref  # noqa: F401  (keeps torch to 2 threads)
from tools.fmo_streams import (
    SCENARIOS, make_fmo_cavlc_pair, make_fmo_stream, pcm_golden,
)

DATA = Path(__file__).resolve().parent / "data"


def _ours(data: bytes, entropy: str = "cpp") -> list[np.ndarray]:
    dec = Decoder(device="cpu", entropy=entropy)
    return [np.frombuffer(f.planar(), np.uint8)
            for f in dec.decode_annexb(data)]


def _assert_frames(got, golden, what=""):
    assert len(got) == len(golden), (what, len(got), len(golden))
    for j, (ours, want) in enumerate(zip(got, golden)):
        assert np.array_equal(ours, want), (what, j)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fmo_map_types_bit_exact(scenario):
    """Each slice group map type (0-6) at 11 x 9 MBs: the MBs land at
    their addresses (tests/test_fmo.py:34)."""
    pps_kwargs, cycle = SCENARIOS[scenario]
    data = make_fmo_stream(pps_kwargs, n_frames=2, change_cycle=cycle)
    _assert_frames(_ours(data), pcm_golden(pps_kwargs, n_frames=2,
                                           change_cycle=cycle), scenario)


def test_fmo_rides_cpp_engine(monkeypatch):
    """FMO pictures parse on the C++ engine (the slice loop follows
    next_mb): the port's Python PictureParse is never built
    (tests/test_fmo.py:44)."""
    def boom(*a, **k):
        raise AssertionError("FMO fell back to the Python parser")

    monkeypatch.setattr(api, "PictureParse", boom)
    pps_kwargs, cycle = SCENARIOS["dispersed_t1"]
    data = make_fmo_stream(pps_kwargs, n_frames=2, change_cycle=cycle)
    dec = Decoder(device="cpu", entropy="cpp")
    assert dec.entropy == "cpp"
    got = [np.frombuffer(f.planar(), np.uint8)
           for f in dec.decode_annexb(data)]
    _assert_frames(got, pcm_golden(pps_kwargs, n_frames=2,
                                   change_cycle=cycle))


def test_aso_slice_order_bit_exact():
    """ASO: each picture's slices in reverse group order, the MB-0 slice
    mid-picture (tests/test_fmo.py:67)."""
    pps_kwargs, _ = SCENARIOS["dispersed_t1"]
    data = make_fmo_stream(pps_kwargs, n_frames=2, slice_order=[2, 1, 0])
    _assert_frames(_ours(data), pcm_golden(pps_kwargs, n_frames=2))


def test_fmo_nondivisible_change_rate_bit_exact():
    """20 map units at change rate 6: slice_group_change_cycle takes 3
    bits, the ceiling (tests/test_fmo.py:96)."""
    pps_kwargs = dict(num_slice_groups=2, slice_group_map_type=5,
                      slice_group_change_direction_flag=0,
                      slice_group_change_rate=6)
    data = make_fmo_stream(pps_kwargs, n_frames=2, mb_w=5, mb_h=4,
                           change_cycle=4)
    _assert_frames(_ours(data), pcm_golden(pps_kwargs, n_frames=2, mb_w=5,
                                           mb_h=4, change_cycle=4))


@pytest.mark.parametrize("entropy", ["cpp", "python"])
@pytest.mark.parametrize("map_kind", ["interleave", "explicit"])
def test_fmo_cavlc_residual_bit_exact(h264ref, tmp_path, map_kind, entropy):
    """FMO with real CAVLC syntax (I16 residuals, P skip runs, MVDs,
    intra in P) through slice groups, against libavcodec's decode of the
    raster twin; the twin itself through the port too
    (tests/test_fmo.py:175)."""
    from tools import streams
    fmo, ras = make_fmo_cavlc_pair(map_kind, n_frames=3)
    p = tmp_path / f"fmo_{map_kind}_twin.264"
    p.write_bytes(ras)
    golden, _, _ = streams.golden_decode(str(p))
    assert len(golden) == 3
    _assert_frames(_ours(ras, entropy), golden, "raster twin")
    _assert_frames(_ours(fmo, entropy), golden, map_kind)


def test_fmo1080_committed_md5():
    """The committed 1080p FMO stream (slice group map type 6 at 120 x 68
    MBs, tools/feature_streams.py) decodes to its MD5s, which are
    libavcodec's of its raster twin."""
    path = DATA / "feat_fmo1080_explicit.264"
    meta = json.loads(path.with_suffix(".json").read_text())
    frames = list(Decoder(device="cpu").decode_annexb(path.read_bytes()))
    assert (frames[0].width, frames[0].height) == (1920, 1088)
    assert [hashlib.md5(f.planar()).hexdigest() for f in frames] \
        == meta["md5"]
