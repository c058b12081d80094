"""CABAC High PAFF streams of tools/field_cabac.py in the port
(arrow_h264_tpu_torch): the writer's bytes pinned per seed and every
syntax kind it writes; Decoder and BatchDecoder on the CPU equal to
libavcodec's decode, kept as the MD5 of every frame in each stream's
JSON; a stream cut after a lone field, joined to a whole one; the field
counters (DecodeStats.field_pictures, weave_s) and spans (`weave`, the
round's `fields`).  The JAX package is no reference here: it deblocks
fields with the frame MV limit."""

import hashlib
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from arrow_h264_tpu_torch.api import Decoder
from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
from arrow_h264_tpu_torch.spans import recorder
from benchmark import lanes
from tools import field_cabac as FC

DATA = Path(__file__).resolve().parent / "data"
SMALL = ("field_cabac_s0", "field_cabac_s1", "field_cabac_s2")
HD = tuple(f"bench_field1080i_s{s}" for s in range(4))


def _meta(name: str) -> dict:
    return json.loads((DATA / f"{name}.json").read_text())


def _data(name: str) -> bytes:
    return (DATA / f"{name}.264").read_bytes()


def _md5s(frames) -> list[str]:
    return [hashlib.md5(f.planar()).hexdigest() for f in frames]


@pytest.mark.parametrize("name", SMALL)
def test_writer_bytes_pinned(name):
    """The writer gives the committed bytes again from the same seed, and
    the same tally of syntax kinds."""
    mb_w, map_units, structure, qp, seed, crop = FC.STREAMS[name]
    counts = Counter()
    data = FC.make_field_cabac_stream(mb_w, map_units, structure, qp, seed,
                                      crop, counts=counts)
    meta = _meta(name)
    assert hashlib.sha256(data).hexdigest() == meta["sha256"]
    assert data == _data(name)
    assert dict(sorted(counts.items())) == meta["syntax"]


@pytest.mark.parametrize("name", SMALL + HD)
def test_committed_stream(name):
    """Each committed stream: its bytes' SHA-256, one IDR, a field letter
    a coded picture as the benchmark reads the bytes (two a woven frame
    and its MD5), and every syntax kind of the writer; the 1080i ones at
    1920x1080, 12 frames IPBBPBBPBBPB, 300-450 kbit a frame."""
    data, meta = _data(name), _meta(name)
    assert hashlib.sha256(data).hexdigest() == meta["sha256"]
    kinds, idr = lanes.structure(data)
    assert kinds == meta["structure"] == \
        "".join(k + k for k in meta["pairs"])
    assert idr == [0]
    assert len(kinds) == 2 * len(meta["md5"]) == 2 * meta["frames"]
    assert [k for k in FC.SYNTAX if not meta["syntax"].get(k)] == []
    if name in HD:
        assert meta["pairs"] == "IPBBPBBPBBPB"
        assert (meta["width"], meta["height"]) == (1920, 1080)
        assert 300 <= len(data) * 8 / 1000 / meta["frames"] <= 450


@pytest.mark.parametrize("name,entropy", [(n, "cpp") for n in SMALL] +
                         [("field_cabac_s2", "python")])
def test_decoder_matches_libavcodec(name, entropy):
    """Every frame equal to libavcodec's: the CABAC field contexts and
    8x8 significance map, field spatial direct, the weave; the host
    library's parse on each stream, the Python parse on one."""
    frames = Decoder(device="cpu", entropy=entropy).decode_annexb(
        _data(name))
    assert _md5s(frames) == _meta(name)["md5"]


def _lone_cut(name: str) -> bytes:
    """The stream cut after its first B top field, as the benchmark's
    warm-up cuts it (the shortest prefix with every picture kind)."""
    meta = _meta(name)
    k = meta["structure"].index("B") + 1
    assert k % 2 == 1 and meta["structure"][:k] == "IIPPB"
    return lanes.truncate(_data(name), k)


def _check_lone_lane(frames, first: str, second: str) -> None:
    """`first` cut after its lone B top field, then `second` whole: the
    IDR pair, the lone field line-doubled (the field woven with itself),
    the P pair, then every frame of `second` equal to its golden."""
    want, after = _meta(first)["md5"], _meta(second)["md5"]
    assert len(frames) == 3 + len(after)
    got = _md5s(frames)
    assert got[3:] == after
    assert (got[0], got[2]) == (want[0], want[3])
    lone = frames[1]
    for plane in (lone.y, lone.cb, lone.cr):
        assert np.array_equal(plane[0::2], plane[1::2])


def test_lone_field_then_idr():
    """An unpaired (non-paired) B top field, then the next stream's IDR."""
    frames = Decoder(device="cpu").decode_annexb(
        _lone_cut("field_cabac_s0") + _data("field_cabac_s1"))
    _check_lone_lane(list(frames), "field_cabac_s0", "field_cabac_s1")


@pytest.fixture(scope="module")
def batch_run():
    """BatchDecoder over s0, s1 and s0 cut after its lone B top field
    then s1, with the span recorder on."""
    a, b = _data("field_cabac_s0"), _data("field_cabac_s1")
    recorder.disable()
    recorder.drain()
    try:
        with BatchDecoder(3, device="cpu") as bd:
            recorder.enable()
            outs = bd.decode([a, b, _lone_cut("field_cabac_s0") + b])
            recorder.disable()
            yield bd, outs, recorder.drain()
    finally:
        recorder.disable()
        recorder.drain()


def test_batch_decoder_lanes(batch_run):
    """Lanes over different streams in lockstep, a round a field: each
    equal to its goldens, and a lane whose first stream ends on a lone
    field decodes the next stream, not failed."""
    bd, outs, _ = batch_run
    assert bd.errors == [None] * 3
    assert _md5s(outs[0]) == _meta("field_cabac_s0")["md5"]
    assert _md5s(outs[1]) == _meta("field_cabac_s1")["md5"]
    _check_lone_lane(outs[2], "field_cabac_s0", "field_cabac_s1")
    assert bd.rounds == 5 + 12


def test_field_counters_and_spans(batch_run):
    """A `weave` span a woven frame (the lone field's too), under the
    `commit` that output it or the call's `flush`, on its lane;
    DecodeStats.weave_s its lane's sum; the rounds' `fields` are the
    field pictures they committed, and each lane's
    DecodeStats.field_pictures its fields."""
    bd, outs, spans = batch_run
    by_id = {s.id: s for s in spans}
    rounds = [s for s in spans if s.name == "round"]
    assert len(rounds) == bd.rounds
    assert all(r.attrs["fields"] == r.attrs["committed"] for r in rounds)
    assert sum(r.attrs["fields"] for r in rounds) == 12 + 12 + 17
    stats = bd.stats
    assert [s["field_pictures"] for s in stats] == [12, 12, 17]
    weaves = [s for s in spans if s.name == "weave"]
    assert Counter(s.lane for s in weaves) == \
        {i: len(o) for i, o in enumerate(outs)} == {0: 6, 1: 6, 2: 9}
    for s in weaves:
        parent = by_id[s.parent]
        assert parent.name in ("commit", "flush")
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
        assert s.call == parent.call
    for i, st in enumerate(stats):
        assert st["weave_s"] > 0
        assert st["weave_s"] == pytest.approx(
            sum(s.t1 - s.t0 for s in weaves if s.lane == i) / 1e9,
            rel=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("name", HD)
def test_1080i_stream_matches_libavcodec(name):
    """A 1080i stream of the benchmark, every frame (about 90 s each on a
    CPU)."""
    frames = Decoder(device="cpu").decode_annexb(_data(name))
    assert _md5s(frames) == _meta(name)["md5"]
