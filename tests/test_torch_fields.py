"""PAFF field decoding in the port (arrow_h264_tpu_torch): every picture
a field, decoded at field height and output as woven frames.

The five hand-authored streams of tests/test_fields.py decode equal to
their golden (libavcodec, or the constructed one for the PCM and gap
streams) with both entropies, and equal to the JAX package's Decoder;
the smooth-content streams of tools/field_smoke.py, where the field
rules of the deblocking filter show, decode equal to libavcodec; the
field deblock tables against the JAX package's; field lanes in
BatchDecoder.  Every comparison is exact."""

import functools

import jax
import numpy as np
import pytest

from arrow_h264_tpu.api import Decoder as JaxDecoder
from arrow_h264_tpu.ops import deblock as jdeblock
from arrow_h264_tpu.ops.synthetic import synthetic_abi_p
from arrow_h264_tpu_torch.api import Decoder
from arrow_h264_tpu_torch.ops import deblock as td
from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
from tests.torch_ref import DEBLOCK_KEYS, to_jax, to_torch
from tools import field_streams as FS
from tools import fmo_streams
from tools.field_smoke import make_field_smoke_stream
from tools.streams import golden_decode

# name -> (stream maker, constructed golden or None for libavcodec's)
FIELD_STREAMS = {
    "pcm": (FS.make_field_pcm_stream, FS.field_pcm_golden),
    "cavlc": (FS.make_field_cavlc_stream, None),
    "p": (FS.make_field_p_stream, None),
    "b": (FS.make_field_b_stream, None),
    "gap": (FS.make_field_gap_stream, FS.field_gap_golden),
}
# smooth content at 6 x 4 MB fields: (structure, QP, seed)
SMOOTH = [("IPBP", 32, 0), ("IPP", 28, 1)]
MB_W, MB_H = 6, 4


def _planar(frames) -> list[np.ndarray]:
    return [np.frombuffer(f.planar(), np.uint8) for f in frames]


def _libavcodec(data: bytes, tmp_path) -> list[np.ndarray]:
    p = tmp_path / "s.264"
    p.write_bytes(data)
    return list(golden_decode(str(p))[0])


def _assert_frames(ours, want, what):
    assert len(ours) == len(want), what
    for i, (o, w) in enumerate(zip(ours, want)):
        assert np.array_equal(o, w), \
            f"{what}: frame {i}, {int((o != w).sum())} bytes differ"


@functools.lru_cache(maxsize=None)
def _port(name: str, entropy: str) -> tuple:
    data = FIELD_STREAMS[name][0]()
    return tuple(_planar(Decoder(device="cpu", entropy=entropy)
                         .decode_annexb(data)))


@pytest.mark.parametrize("entropy", ["python", "cpp"])
@pytest.mark.parametrize("name", FIELD_STREAMS)
def test_field_stream_matches_golden(h264ref, tmp_path, name, entropy):
    make, construct = FIELD_STREAMS[name]
    want = construct() if construct else _libavcodec(make(), tmp_path)
    _assert_frames(list(_port(name, entropy)), want, name)


@pytest.fixture(scope="module")
def jax_frames() -> dict:
    """{name: the JAX package's frames of each stream}.  The streams but
    the gap one share their SPS and each starts with its SPS, PPS and an
    IDR, so one JAX Decoder takes them back to back and compiles once;
    the gap stream's SPS differs (more references), so it has its own."""
    def decode(data):
        return [np.concatenate([f.y.ravel(), f.cb.ravel(), f.cr.ravel()])
                for f in JaxDecoder(entropy="cpp").decode_annexb(data)]

    shared = [n for n in FIELD_STREAMS if n != "gap"]
    frames = decode(b"".join(FIELD_STREAMS[n][0]() for n in shared))
    out = {"gap": decode(FIELD_STREAMS["gap"][0]())}
    for n in shared:
        k = len(_port(n, "cpp"))
        out[n], frames = frames[:k], frames[k:]
    assert not frames
    return out


@pytest.mark.parametrize("name", FIELD_STREAMS)
def test_field_stream_matches_jax(jax_frames, name):
    """On this noise content the JAX package's deblock limit does not
    show (test_deblock_tables_field), so its decode is the reference."""
    _assert_frames(list(_port(name, "cpp")), jax_frames[name], name)


def test_field_poc_and_units():
    """Field POC (type 0) and woven frame height on the PCM stream."""
    dec = Decoder(device="cpu", entropy="python")
    frames = list(dec.decode_annexb(FS.make_field_pcm_stream(n_frames=3)))
    assert [f.poc for f in frames] == [0, 2, 4]
    assert all(f.height == 4 * 32 for f in frames)


@pytest.mark.parametrize("entropy", ["python", "cpp"])
@pytest.mark.parametrize("structure,qp,seed", SMOOTH)
def test_smooth_field_stream_matches_libavcodec(h264ref, tmp_path, structure,
                                                qp, seed, entropy):
    """Smooth content, cropped to 120 rows: intra MBs at QP > 0, same and
    cross-parity references, neighbours 2-3 quarter samples apart."""
    data = make_field_smoke_stream(MB_W, MB_H, structure, qp, seed,
                                   crop_bottom=2)
    ours = _planar(Decoder(device="cpu", entropy=entropy)
                   .decode_annexb(data))
    assert ours[0].size == MB_W * 16 * (MB_H * 32 - 8) * 3 // 2
    _assert_frames(ours, _libavcodec(data, tmp_path), structure)


@functools.lru_cache(maxsize=None)
def _jax_field_tables(mb_w: int, mb_h: int):
    return jax.jit(lambda abi: jdeblock.deblock_tables(abi, mb_w, mb_h,
                                                       field=True))


def _field_abi(bi: bool, seed: int) -> dict:
    """A synthetic P (or B) ABI with MVs of -3..3 quarter samples over two
    references, so that many neighbours share a reference and differ by
    2 or 3 vertically; no 8x8 transform and every edge filtered."""
    abi = synthetic_abi_p(MB_W * 2, MB_H * 2, seed=seed, n_slots=2,
                          intra_frac=0.1, bi_frac=0.5 if bi else 0.0)
    rng = np.random.default_rng(seed)
    abi["mv"] = rng.integers(-3, 4, abi["mv"].shape).astype(np.int32)
    abi["tr8"][:] = 0
    abi["disable_idc"][:] = 0
    return abi


def _tables(abi):
    w, h = MB_W * 2, MB_H * 2
    got = td.deblock_tables(to_torch(abi), w, h, field=True)
    want = _jax_field_tables(w, h)(to_jax(abi, DEBLOCK_KEYS))
    return ({k: v[0].numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def _mv_gap_2_3(abi, horiz: bool) -> np.ndarray:
    """bool [n, 4 (e), 4 (s)]: list-0 MVs of the two blocks of each luma
    edge differ by 2 or 3 quarter samples vertically (False on the
    picture border)."""
    w, h = MB_W * 2, MB_H * 2
    g = abi["mv"][..., 0, 1].reshape(h, w, 4, 4).transpose(0, 2, 1, 3) \
        .reshape(h * 4, w * 4)                      # vertical MV per block
    d = np.abs(np.diff(g, axis=0 if horiz else 1))
    gap = np.zeros_like(g, bool)
    if horiz:
        gap[1:] = (d == 2) | (d == 3)
    else:
        gap[:, 1:] = (d == 2) | (d == 3)
    # block (by, bx) of MB (my, mx) -> [n, e, s]: e indexes the edge
    # across the direction, s along it
    gap = gap.reshape(h, 4, w, 4).transpose(0, 2, 1, 3).reshape(-1, 4, 4)
    return gap if horiz else gap.transpose(0, 2, 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_deblock_tables_field(seed):
    """deblock_tables(field=True) equals the JAX package's everywhere,
    bS 3 on horizontal intra MB edges included, except at edges between
    P blocks on one reference whose vertical MVs differ by 2 or 3: there
    the port gives bS 1 (spec 8.7.2.1: 4 quarter FRAME samples are 2
    quarter field samples) and the JAX package 0."""
    abi = _field_abi(False, seed)
    got, want = _tables(abi)
    assert (got["bs_h"] == 3).any() and (got["bs_v"] == 4).any()
    assert not (got["bs_h"] == 4).any()
    for k in td.TABLE_KEYS:
        if k.startswith(("bs_", "tc_")):
            continue
        assert np.array_equal(got[k], want[k]), k
    for d, horiz in (("v", False), ("h", True)):
        diff = got["bs_" + d] != want["bs_" + d]
        gap = _mv_gap_2_3(abi, horiz) & (want["bs_" + d] == 0)
        assert gap.any()
        assert np.array_equal(diff, gap), d
        assert (got["bs_" + d][diff] == 1).all()
        assert np.array_equal(got["tc_" + d][~diff], want["tc_" + d][~diff])
    chroma = np.stack([got["bs_v"][:, 0::2], got["bs_h"][:, 0::2]], 1)
    assert np.array_equal(got["bs_c"], chroma)


@pytest.mark.parametrize("bi", [False, True])
def test_deblock_tables_field_half_limit(bi):
    """The port's field tables are the JAX package's field tables of the
    same ABI with every vertical MV doubled (a vertical limit of 2 on the
    MVs is one of 4 on the doubled ones), over one and two lists."""
    abi = _field_abi(bi, 3)
    got, _ = _tables(abi)
    doubled = dict(abi, mv=abi["mv"] * np.array([1, 2], np.int32))
    _, want = _tables(doubled)
    for k in td.TABLE_KEYS:
        assert np.array_equal(got[k], want[k]), k


def _batch_lanes():
    """Three 6 x 4 MB field streams of 4, 3 and 3 frames."""
    return [make_field_smoke_stream(MB_W, MB_H, "IPBP", 32, 0),
            make_field_smoke_stream(MB_W, MB_H, "IPP", 28, 1),
            FS.make_field_b_stream()]


@pytest.mark.parametrize("order", ["phase", "raster"])
def test_batch_decoder_fields(h264ref, tmp_path, order):
    """Field lanes of different lengths in lockstep: each equal to its
    libavcodec golden and to the single-stream Decoder; a round a field."""
    datas = _batch_lanes()
    with BatchDecoder(len(datas), device="cpu", order=order) as bd:
        outs = bd.decode(datas)
    assert bd.errors == [None] * len(datas)
    assert (bd.rounds, bd.inter_rounds) == (8, 6)
    for i, (data, frames) in enumerate(zip(datas, outs)):
        ours = _planar(frames)
        _assert_frames(ours, _libavcodec(data, tmp_path), f"lane {i}")
        _assert_frames(ours, _planar(Decoder(device="cpu", order=order)
                                     .decode_annexb(data)), f"lane {i}")


def test_batch_decoder_field_lane_beside_frame_lane():
    """A field stream and a progressive stream of the same MB grid (6 x 4
    MB fields, 96 x 64 frames) cannot share a lockstep batch."""
    frame = fmo_streams.make_fmo_stream({}, n_frames=2, mb_w=MB_W,
                                        mb_h=MB_H)
    with BatchDecoder(2, device="cpu") as bd, \
            pytest.raises(ValueError, match="field coding"):
        bd.decode([FS.make_field_pcm_stream(), frame])
