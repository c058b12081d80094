"""Concealment of lost slices and the dense per-cell weights of slice-row
overflow, through the port on the CPU: the tests of the JAX package's
tests/test_conceal.py and tests/test_slice_rows.py:136 with the port,
the port's concealed output equal to the JAX package's (concealment has
no golden), and the committed streams of tools/feature_streams.py
against their JSON.  Every comparison is exact."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from arrow_h264_tpu_torch.api import Decoder
from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
from tests.torch_ref import JaxDecoder
from tools import feature_streams, streams

DATA = Path(__file__).resolve().parent / "data"


def _cut_stream(tmp_path) -> tuple[bytes, str]:
    """(the 64x64 two-slice stream of tests/test_conceal.py:46 with the
    second slice of picture 1 dropped, the path of the whole stream)."""
    path = tmp_path / "c.264"
    data = feature_streams.stream_bytes("feat_conceal64")
    spec = feature_streams.STREAMS["feat_conceal64"]
    _, (w, h), n, seed, opts, noise, drop = spec
    streams.encode(streams.make_content(w, h, n, seed=seed, noise=noise),
                   w, h, str(path), opts)
    assert feature_streams.drop_slice(path.read_bytes(), drop) == data
    return data, str(path)


@pytest.mark.parametrize("entropy", ["python", "cpp"])
def test_lost_slice_concealed(h264ref, tmp_path, entropy):
    """tests/test_conceal.py:46: the frame count holds, the undamaged
    picture and the parsed rows of the damaged one equal the golden, and
    the lost rows are the reference's co-located samples."""
    cut, path = _cut_stream(tmp_path)
    golden, gw, gh = streams.golden_decode(path)
    dec = Decoder(device="cpu", entropy=entropy, conceal=True)
    frames = list(dec.decode_annexb(cut))
    assert len(frames) == 3, "concealment must preserve frame count"
    assert dec.concealed and dec.concealed[0][1] > 0
    assert frames[0].planar() == golden[0].tobytes()
    ysz = gw * gh
    g1 = golden[1][:ysz].reshape(gh, gw)
    o1 = np.frombuffer(frames[1].planar(), np.uint8)[:ysz].reshape(gh, gw)
    assert np.array_equal(o1[:16], g1[:16]), "parsed region changed"
    ref = np.frombuffer(frames[0].planar(), np.uint8)[:ysz].reshape(gh, gw)
    assert np.array_equal(o1[48:], ref[48:]), "frame-copy concealment"


def test_conceal_matches_jax(h264ref, tmp_path):
    """The port's Decoder(conceal=True) equals the JAX package's on the
    same cut bytes: every frame and the `concealed` list."""
    cut, _ = _cut_stream(tmp_path)
    ours = Decoder(device="cpu", conceal=True)
    theirs = JaxDecoder(conceal=True)
    got = [f.planar() for f in ours.decode_annexb(cut)]
    want = [f.planar() for f in theirs.decode_annexb(cut)]
    assert got == want
    assert ours.concealed == theirs.concealed == [(1, 8)]
    assert ours.stats.concealed_mbs == 8


@pytest.mark.parametrize("order", ["phase", "raster"])
def test_committed_conceal64(order):
    """The committed cut stream decodes to its JSON: the JAX package's
    concealed output and `concealed`."""
    path = DATA / "feat_conceal64.264"
    meta = json.loads(path.with_suffix(".json").read_text())
    dec = Decoder(device="cpu", conceal=True, order=order)
    md5 = [hashlib.md5(f.planar()).hexdigest()
           for f in dec.decode_annexb(path.read_bytes())]
    assert md5 == meta["md5"]
    assert [list(c) for c in dec.concealed] == meta["concealed"]


def test_no_conceal_still_raises(h264ref, tmp_path):
    """tests/test_conceal.py:61: without conceal a corrupt stream raises."""
    w, h = 64, 64
    path = str(tmp_path / "c2.264")
    streams.encode(streams.make_content(w, h, 2, seed=12), w, h, path,
                   streams.CONFIG_OPTS[2])
    data = open(path, "rb").read()
    bad = data[:len(data) - 40] + b"\x55" * 8
    with pytest.raises(Exception):
        list(Decoder(device="cpu", conceal=False).decode_annexb(bad))


def test_motion_copy_concealment_unit():
    """tests/test_conceal.py:76: conceal_abi copies the co-located motion
    field of the nearest reference into the repaired MBs."""
    from arrow_h264_tpu_torch.conceal import conceal_abi
    from arrow_h264_tpu_torch.ops.abi import KIND_P, empty_frame_abi
    mb_w, mb_h = 4, 3
    abi = empty_frame_abi(mb_w, mb_h)
    covered = np.ones((mb_h, mb_w), bool)
    covered[1, :] = False                       # middle MB row lost
    col = np.zeros((mb_h * 4, mb_w * 4, 2), np.int32)
    col[..., 0] = 8                             # uniform pan +2px
    col[..., 1] = -4
    n = conceal_abi(abi, covered, ref_slot=1, col_mv=col)
    assert n == mb_w
    lost = np.arange(mb_w, 2 * mb_w)
    assert (abi["kind"][lost] == KIND_P).all()
    assert (abi["mv"][lost, :, :, 0, 0] == 8).all()
    assert (abi["mv"][lost, :, :, 0, 1] == -4).all()
    assert (abi["refslot"][lost, :, :, 0] == 1).all()
    kept = np.arange(0, mb_w)
    assert (abi["mv"][kept] == 0).all()


def test_many_distinct_weight_slices(h264ref, tmp_path):
    """tests/test_slice_rows.py:136: 18 slices a picture with distinct
    pred-weight tables (more than the 15 slice rows: dense per-cell
    weights) equal the libavcodec golden through Decoder and through
    BatchDecoder(2)."""
    from tools.wp_streams import make_many_weight_slices_stream
    data = make_many_weight_slices_stream(mb_w=4, mb_h=18, n_p=2)
    p = tmp_path / "wp18.264"
    p.write_bytes(data)
    golden, _, _ = streams.golden_decode(str(p))
    assert golden.shape[0] == 3
    frames = [f.planar() for f in Decoder(device="cpu").decode_annexb(data)]
    assert frames == [g.tobytes() for g in golden]
    with BatchDecoder(2, device="cpu") as bd:
        rows = bd.decode([data, data])
    assert bd.errors == [None, None]
    for lane in rows:
        assert [f.planar() for f in lane] == [g.tobytes() for g in golden]


def test_dense_lane_beside_table_lane():
    """BatchDecoder(2) over feat_wp18 (dense weights) beside feat_wp_table
    (per-slice weight tables, expanded into the batch's dense weights by
    upload_batch): both lanes equal their golden MD5s."""
    names = ["feat_wp18", "feat_wp_table"]
    with BatchDecoder(2, device="cpu") as bd:
        outs = bd.decode([(DATA / f"{n}.264").read_bytes() for n in names])
    assert bd.errors == [None, None]
    for n, frames in zip(names, outs):
        meta = json.loads((DATA / f"{n}.json").read_text())
        assert [hashlib.md5(f.planar()).hexdigest() for f in frames] \
            == meta["md5"], n
