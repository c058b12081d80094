"""Lanes of several GOPs in lockstep, on the CPU: the exactness part of
tests/test_batch_binding_shape.py at QCIF.  Two config-4 lanes of 8
frames with an IDR every 3 and every 4 frames, so that rounds put a
lane's mid-stream IDR (DPB flush, slot reuse, output bumping) beside the
other lane's P or B picture, through the port's BatchDecoder with both
orders: each lane equal to the libavcodec golden and to the JAX
package's BatchDecoder, and no lane in error.  (The reference test's
sticky-spec and mode-lattice checks are of the TPU path and have no
counterpart in the port.)  Every comparison is exact."""

import numpy as np
import pytest

from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
from tools import streams
from tools.conformance_streams import structure

GOPS = (3, 4)
FRAMES = 8


def _planar(frames) -> np.ndarray:
    return np.stack([np.frombuffer(f.planar(), np.uint8) for f in frames])


@pytest.fixture(scope="module")
def lanes(h264ref, tmp_path_factory):
    """(datas, goldens, JAX BatchDecoder's frames) of the two lanes."""
    from arrow_h264_tpu.parallel.batch import BatchDecoder as JaxBatchDecoder
    tmp = tmp_path_factory.mktemp("gop")
    datas, goldens = [], []
    for i, gop in enumerate(GOPS):
        opts = [{"g=250": f"g={gop}", "keyint_min=250": f"keyint_min={gop}"}
                .get(o, o) for o in streams.CONFIG_OPTS[4]]
        path = str(tmp / f"gop{gop}.264")
        datas.append(streams.encode(streams.make_content(
            176, 144, FRAMES, seed=300 + i, noise=3), 176, 144, path, opts))
        goldens.append(streams.golden_decode(path)[0])
    jax_outs = JaxBatchDecoder(len(GOPS)).decode(datas)
    return datas, goldens, [_planar(f) for f in jax_outs]


def test_rounds_mix_idr_and_inter(lanes):
    """Each lane has several IDRs, in different rounds; some round has
    an IDR lane beside a P/B lane (round k decodes each lane's k-th
    picture in decode order)."""
    kinds, idrs = zip(*(structure(d) for d in lanes[0]))
    assert all(len(k) == FRAMES for k in kinds)
    assert all(len(i) >= 2 for i in idrs) and idrs[0] != idrs[1]
    assert any(k in idr and kinds[1 - j][k] in "PB"
               for j, idr in enumerate(idrs) for k in idr)


@pytest.mark.parametrize("order", ["phase", "raster"])
def test_batch_decoder_gop_lanes(lanes, order):
    datas, goldens, jax_outs = lanes
    with BatchDecoder(len(GOPS), device="cpu", order=order) as bd:
        outs = bd.decode(datas)
    assert bd.errors == [None] * len(GOPS)
    assert bd.rounds == FRAMES
    for i, (frames, golden, ref) in enumerate(zip(outs, goldens, jax_outs)):
        ours = _planar(frames)
        assert np.array_equal(ours, golden), f"lane {i} != golden"
        assert np.array_equal(ours, ref), f"lane {i} != JAX BatchDecoder"
