"""The port's compact wire upload (arrow_h264_tpu_torch.ops.wire) on the
CPU: the round trips of tests/test_wire.py on the port's pack and
unpack_wire; the port's buffers byte-equal to the JAX package's and its
unpack equal to the JAX unpack, on synthetic ABIs and on the pictures of
committed streams; Decoder(upload="wire") equal to upload="dense" and to
the goldens.  Every comparison is exact."""

import functools
import hashlib
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu.host import centropy as jcentropy
from arrow_h264_tpu.ops import wire as jwire
from arrow_h264_tpu_torch.api import Decoder
from arrow_h264_tpu_torch.host import centropy
from arrow_h264_tpu_torch.models import pipeline as tpipeline
from arrow_h264_tpu_torch.models.pipeline import (
    ABI_DEVICE_KEYS, UPLOADS, upload_batch, upload_wire,
)
from arrow_h264_tpu_torch.ops import wire
from arrow_h264_tpu_torch.ops.abi import empty_frame_abi
from arrow_h264_tpu_torch.ops.synthetic import synthetic_abi, synthetic_abi_p
from arrow_h264_tpu_torch.ops.transforms import COEFF_KEYS
from tests.torch_ref import decode_port
from tools import field_streams as FS
from tools.streams import golden_decode

DATA = Path(__file__).resolve().parent / "data"
MB_W, MB_H = 11, 9
JAX_PATCH = ("patch", "zero", 0)     # the JAX spec's last entry, no bytes
# committed streams whose pictures are packed by both packages
PACK_STREAMS = ["batch_qcif_s1", "batch_qcif_s2", "batch_qcif_s3",
                "batch_qcif_s4", "feat_lossless_qcif", "feat_conceal64",
                "feat_fmo_cavlc_explicit", "feat_wp_table"]
# committed streams decoded with each upload
DECODE_STREAMS = ["batch_qcif_s1", "feat_lossless_164x132", "feat_conceal64",
                  "feat_fmo_cavlc_interleave", "feat_wp18"]
# the hand-written field streams of tests/test_fields.py: maker,
# constructed golden (None: libavcodec's)
FIELD_STREAMS = {
    "pcm": (FS.make_field_pcm_stream, FS.field_pcm_golden),
    "cavlc": (FS.make_field_cavlc_stream, None),
    "p": (FS.make_field_p_stream, None),
    "b": (FS.make_field_b_stream, None),
    "gap": (FS.make_field_gap_stream, FS.field_gap_golden),
}


def _unpack(buf: np.ndarray, spec, mb_w=MB_W, mb_h=MB_H) -> dict:
    """One lane's buffer through unpack_wire -> {key: numpy array}."""
    out = wire.unpack_wire(torch.from_numpy(buf)[None], mb_w, mb_h, spec)
    return {k: v[0].numpy() for k, v in out.items()}


def _roundtrip(abi, mb_w=MB_W, mb_h=MB_H):
    sec, spec = wire.pack_wire(abi, mb_w, mb_h)
    buf = wire.flatten_wire(sec, spec, mb_w * mb_h)
    return buf, spec, _unpack(buf, spec, mb_w, mb_h)


def _check(abi, dense):
    """The unpacked ABI equals the host ABI: every device key exactly,
    refid by its equality structure (unpack_wire ships refslot in its
    place); absent keys are all-zero coefficient or PCM classes."""
    for k in ABI_DEVICE_KEYS:
        if k not in dense:
            assert k in COEFF_KEYS, k
            assert not np.asarray(abi[k]).any(), k
            continue
        got = np.asarray(dense[k])
        want = np.asarray(abi[k])
        assert got.shape == want.shape, k
        assert got.dtype == np.int32, k
        if k == "refid":
            neg = want < 0
            assert np.array_equal(got < 0, neg), k
            f_w = want.reshape(-1)
            f_g = got.reshape(-1)
            rng = np.random.default_rng(0)
            ii = rng.integers(0, f_w.size, 512)
            jj = rng.integers(0, f_w.size, 512)
            assert np.array_equal(f_w[ii] == f_w[jj], f_g[ii] == f_g[jj]), k
            continue
        assert np.array_equal(got, want), k


# ---- tests/test_wire.py on the port ----------------------------------------

def _edge_values():
    abi = empty_frame_abi(MB_W, MB_H)
    # int8-range coefficients stay on the bm8 sparse path
    abi["luma4"][0, 0, 0, 0] = 127
    abi["luma4"][1, 5, 3, 3] = -128
    abi["alpha_off"][:] = -12
    abi["beta_off"][:] = 12
    abi["pcm"][7] = np.arange(384) % 256
    abi["kind"][7] = 3
    return abi


def _level(v):
    abi = empty_frame_abi(MB_W, MB_H)
    abi["luma4"][0, 0, 0, 0] = v
    return abi


def _subpartitioned():
    abi = synthetic_abi_p(MB_W, MB_H, seed=3, n_slots=2)
    # broadcast cell 0 across each MB (16x16-like content), then
    # sub-partition a handful so the base scheme must carry
    # non-uniform full-grid rows
    for k in ("mv", "refidx", "refslot", "refid"):
        abi[k][:] = abi[k][:, :1, :1]
    abi["mv"][5, 2, 3, 0, 0] += 4
    abi["refidx"][17, 1, 1, 0] = 1
    abi["refslot"][17, 1, 1, 0] = 1
    return abi


def _weighted():
    abi = synthetic_abi_p(MB_W, MB_H, seed=1, n_slots=2)
    abi["wtab"][2, 5, 0, 1] = (3, -4, 1, 0)
    abi["slogwd"][2] = (6, 5)
    return abi


# case -> (ABI maker, the spec entries the pack must choose)
ROUNDTRIPS = {
    "p_frame": (lambda: synthetic_abi_p(MB_W, MB_H, seed=3, n_slots=2), {}),
    "empty_and_edge_values": (_edge_values,
                              {"l4": "bm8", "pcm": "sparse"}),
    "int8_overflow_falls_back_dense16": (lambda: _level(32767),
                                         {"l4": "dense16"}),
    "int16_overflow_falls_back_dense": (lambda: _level(40000),
                                        {"l4": "dense"}),
    "subpartitioned_mbs_nonuniform_rows": (_subpartitioned,
                                           {"inter": "base"}),
    "weighted_tables_sparse_rows": (_weighted, {"wtab": "sparse"}),
}


@pytest.mark.parametrize("case", ROUNDTRIPS)
def test_roundtrip(case):
    """pack_wire -> flatten_wire -> unpack_wire reproduces the dense ABI
    (tests/test_wire.py:56-131), in the scheme each case forces."""
    make, schemes = ROUNDTRIPS[case]
    abi = make()
    buf, spec, dense = _roundtrip(abi)
    _check(abi, dense)
    d = dict((f, (s, b)) for f, s, b in spec)
    for f, s in schemes.items():
        assert d[f][0] == s, (f, d[f])
    if case == "p_frame":
        dense_bytes = sum(np.asarray(abi[k]).nbytes for k in ABI_DEVICE_KEYS)
        assert wire.wire_nbytes(buf) < dense_bytes // 4
    if case == "subpartitioned_mbs_nonuniform_rows":
        assert d["inter"][1] >= 2


def test_merge_and_conform_batch():
    """Two lanes conformed to their merged spec unpack together as one
    [2, total] batch, each equal to its ABI."""
    a0 = synthetic_abi_p(MB_W, MB_H, seed=5, n_slots=2)
    a1 = empty_frame_abi(MB_W, MB_H)
    a1["luma4"][3, 2, 1, 1] = 9          # tiny sparse
    s0, sp0 = wire.pack_wire(a0, MB_W, MB_H)
    s1, sp1 = wire.pack_wire(a1, MB_W, MB_H)
    tgt = wire.merge_specs([sp0, sp1])
    n = MB_W * MB_H
    b0 = wire.flatten_wire(wire.conform_sections(s0, sp0, tgt, MB_W, MB_H),
                           tgt, n)
    b1 = wire.flatten_wire(wire.conform_sections(s1, sp1, tgt, MB_W, MB_H),
                           tgt, n)
    assert b0.shape == b1.shape
    dense = wire.unpack_wire(torch.from_numpy(np.stack([b0, b1])), MB_W,
                             MB_H, tgt)
    _check(a0, {k: v[0].numpy() for k, v in dense.items()})
    _check(a1, {k: v[1].numpy() for k, v in dense.items()})


def test_conceal_deblock_override_survives_wire():
    """Per-MB deblock-disable written by concealment survives the wire's
    per-slice disable_idc rows: flagged MBs read back disable_idc == 1
    while the rest of their slice keeps the header's value."""
    n = MB_W * MB_H
    abi = synthetic_abi_p(MB_W, MB_H, seed=2, n_slots=2)
    abi["deblock_off"] = np.zeros(n, np.int32)
    abi["slice_id"][:] = 0
    abi["disable_idc"][:] = 0
    abi["disable_idc"][-3:] = 1
    abi["deblock_off"][-3:] = 1
    _, _, dense = _roundtrip(abi)
    got = dense["disable_idc"]
    assert (got[-3:] == 1).all()
    assert (got[:-3] == 0).all()
    assert np.array_equal(dense["slice_id"], abi["slice_id"])


def test_nonexisting_ref_refid_stays_distinct():
    """A cell referencing a non-existing (frame_num gap) picture bound to
    slot 0 unpacks with another refid than a cell referencing the real
    picture at slot 0, while both read slot 0 for MC."""
    abi = synthetic_abi_p(MB_W, MB_H, seed=4, n_slots=2)
    for k in ("refid", "refslot", "refidx"):
        abi[k][:2] = -1
    abi["refid"][0, :, :, 0] = 5      # real picture, slot 0
    abi["refid"][1, :, :, 0] = 7      # non-existing gap picture, slot 0
    abi["refslot"][0, :, :, 0] = 0
    abi["refslot"][1, :, :, 0] = 0
    abi["refidx"][0, :, :, 0] = 0
    abi["refidx"][1, :, :, 0] = 0
    abi["nx_uids"] = np.asarray([7], np.int32)
    _, _, dense = _roundtrip(abi)
    rid, rsl = dense["refid"], dense["refslot"]
    assert rid[0, 0, 0, 0] != rid[1, 0, 0, 0]
    assert rsl[0, 0, 0, 0] == 0 and rsl[1, 0, 0, 0] == 0
    assert (dense["refidx"][:2] == abi["refidx"][:2]).all()


def test_decode_matches_dense_upload(h264ref, tmp_path):
    """A config-2 QCIF stream decodes to the same bytes with the wire as
    with the dense upload, and the wire ships fewer bytes."""
    from tools import streams
    path = str(tmp_path / "wire_e2e.264")
    yuv = streams.make_content(176, 144, 4)
    streams.encode(yuv, 176, 144, path, streams.CONFIG_OPTS[2])
    data = open(path, "rb").read()
    decs = {u: Decoder(device="cpu", upload=u) for u in UPLOADS}
    got = {u: [f.planar() for f in d.decode_annexb(data)]
           for u, d in decs.items()}
    assert len(got["wire"]) == 4 and got["wire"] == got["dense"]
    assert 0 < decs["wire"].stats.upload_bytes \
        < decs["dense"].stats.upload_bytes // 4


def _emit_cases():
    n = MB_W * MB_H
    heavy = synthetic_abi_p(MB_W, MB_H, seed=5, n_slots=2)
    heavy["kind"] = np.zeros(n, np.int32)            # all I4
    heavy["i4_modes"] = np.full((n, 16), 2, np.int32)
    rng = np.random.default_rng(0)
    heavy["luma4"] = rng.integers(-100, 100, (n, 16, 4, 4)).astype(np.int32)
    heavy["refidx"] = np.full((n, 4, 4, 2), -1, np.int32)
    heavy["refslot"] = np.full((n, 4, 4, 2), -1, np.int32)
    heavy["refid"] = np.full((n, 4, 4, 2), -1, np.int32)
    heavy["mv"] = np.zeros((n, 4, 4, 2, 2), np.int32)
    return [empty_frame_abi(MB_W, MB_H),
            synthetic_abi_p(MB_W, MB_H, seed=3, n_slots=2),
            synthetic_abi_p(MB_W, MB_H, seed=9, n_slots=2),
            heavy, _edge_values(), _level(40000), _weighted()]


def test_emit_wire_matches_sections_path():
    """pack_wire_raw + emit_wire is byte-equal to pack_wire ->
    conform_sections -> flatten_wire for every own -> target scheme pair
    the merge can produce, also when emitted into a caller's row."""
    n = MB_W * MB_H
    abis = _emit_cases()
    specs, raws, secs = [], [], []
    for a in abis:
        sec, spec = wire.pack_wire(a, MB_W, MB_H)
        raw, spec_r = wire.pack_wire_raw(a, MB_W, MB_H)
        assert spec_r == spec
        specs.append(spec)
        raws.append(raw)
        secs.append(sec)
    for sec, raw, spec in zip(secs, raws, specs):
        assert np.array_equal(wire.flatten_wire(sec, spec, n),
                              wire.emit_wire(raw, spec, spec, n))
    target = wire.merge_specs(specs)
    rows = np.full((len(abis), wire.wire_total(target, n)), 0xAB, np.uint8)
    for i, (sec, raw, spec) in enumerate(zip(secs, raws, specs)):
        ref = wire.flatten_wire(
            wire.conform_sections(sec, spec, target, MB_W, MB_H), target, n)
        assert np.array_equal(ref, wire.emit_wire(raw, spec, target, n))
        wire.emit_wire(raw, spec, target, n, out=rows[i])
        assert np.array_equal(ref, rows[i])
    with pytest.raises(ValueError, match="out"):
        wire.emit_wire(raws[0], specs[0], target, n, out=rows[0, :-8])


def test_nz_row_hints_match_full_scan(h264ref, tmp_path):
    """The decode-time nonzero-row hints make pack_wire_raw byte-identical
    to the hint-less full scan on a real CABAC stream."""
    from tools import streams
    path = str(tmp_path / "wire_nzr.264")
    yuv = streams.make_content(176, 144, 5)
    streams.encode(yuv, 176, 144, path, streams.CONFIG_OPTS[4])
    dec = Decoder(device="cpu", entropy="cpp")
    zero = tuple(torch.zeros(s, dtype=torch.uint8)
                 for s in ((144, 176), (72, 88), (72, 88)))
    nf = 0
    for pic, poc in dec.parse_pictures(open(path, "rb").read()):
        mb_w = pic.sps.pic_width_in_mbs
        mb_h = pic.sps.pic_height_in_map_units
        n = mb_w * mb_h
        abi = dec.pack_abi(pic, poc)
        assert "_nzr" in abi           # the C++ parser records hints
        raw_h, spec_h = wire.pack_wire_raw(abi, mb_w, mb_h)
        bare = dict(abi)
        bare.pop("_nzr")
        raw_s, spec_s = wire.pack_wire_raw(bare, mb_w, mb_h)
        assert spec_h == spec_s
        assert wire.emit_wire(raw_h, spec_h, spec_h, n).tobytes() == \
            wire.emit_wire(raw_s, spec_s, spec_s, n).tobytes()
        list(dec.commit(pic, poc, *zero, 4, lambda *a: None))
        nf += 1
    assert nf == 5


def test_nz_row_hints_unsorted_falls_back():
    """gather_blocks8 returns None on a non-ascending or out-of-range
    hint (ASO), so the pack falls back to the full scan; scan_rows32
    equals the JAX package's."""
    src = np.zeros((8, 16), np.int32)
    src[2, 3] = 7
    src[5, 0] = -4
    ok = centropy.gather_blocks8(src, np.array([2, 5], np.int32), 5, 33)
    assert ok is not None and ok[0] == 2
    assert centropy.gather_blocks8(src, np.array([5, 2], np.int32), 5,
                                   33) is None
    assert centropy.gather_blocks8(src, np.array([5, 99], np.int32), 5,
                                   33) is None
    src[6] = np.arange(16) * 3000
    for cap, ovf in ((1, False), (4, True)):   # row 6 misses int16
        got, want = centropy.scan_rows32(src, cap), \
            jcentropy.scan_rows32(src, cap)
        assert got[0] == want[0] == 3 and got[3] == want[3] == ovf
        k = min(cap, 3)
        assert np.array_equal(got[1][:k], want[1][:k])
        assert np.array_equal(got[2][:k], want[2][:k])


# ---- the port's wire against the JAX package's ---------------------------

def _wild_mv(seed: int):
    abi = synthetic_abi_p(2, 2, seed=seed, n_mv=6, bi_frac=0.5)
    rng = np.random.default_rng(seed)
    wild = rng.random((4, 4, 4)) < 0.3
    mv = rng.integers(-512, 513, abi["mv"].shape).astype(np.int32)
    abi["mv"] = np.where(wild[..., None, None], mv, abi["mv"])
    return abi


def _jax_abi(abi) -> dict:
    """The ABI as the JAX pack takes it: no patch list."""
    return {k: v for k, v in abi.items() if k != "patch"}


@functools.lru_cache(maxsize=None)
def _abis(name: str):
    """(mb_w, mb_h, host ABIs) of a group: synthetic ABIs, or the pictures
    of a committed stream as the port's Decoder uploads them (concealed
    where the stream's JSON lists concealment)."""
    if name == "synthetic_11x9":
        return MB_W, MB_H, (synthetic_abi(MB_W, MB_H, seed=1),
                            synthetic_abi_p(MB_W, MB_H, seed=2,
                                            bi_frac=0.3),
                            synthetic_abi_p(MB_W, MB_H, seed=3,
                                            intra_frac=0.5))
    if name == "synthetic_2x2_wild_mv":
        return 2, 2, tuple(_wild_mv(s) for s in range(3))
    meta = json.loads((DATA / f"{name}.json").read_text())
    capture = []
    decode_port(str(DATA / f"{name}.264"), capture=capture,
                conceal="concealed" in meta)
    pipe = capture[0][1]
    return pipe.mb_w, pipe.mb_h, tuple(a for a, *_ in capture)


@pytest.mark.parametrize("name", ["synthetic_11x9", "synthetic_2x2_wild_mv"]
                         + PACK_STREAMS)
def test_wire_matches_jax(name):
    """Each ABI's buffer is byte-equal to the JAX package's, for its own
    spec and for the group's merged one (the JAX spec ends in an empty
    patch entry); the port's unpack of the merged batch equals the JAX
    unpack (vmapped, jit on the CPU) key by key, and each own-spec unpack
    equals the ABI."""
    mb_w, mb_h, abis = _abis(name)
    n = mb_w * mb_h
    assert not any("wp" in a for a in abis)
    packs = [wire.pack_wire_raw(a, mb_w, mb_h) for a in abis]
    jpacks = [jwire.pack_wire_raw(_jax_abi(a), mb_w, mb_h) for a in abis]
    for a, (raw, spec), (jraw, jspec) in zip(abis, packs, jpacks):
        assert jspec == spec + (JAX_PATCH,)
        buf = wire.emit_wire(raw, spec, spec, n)
        assert np.array_equal(buf, jwire.emit_wire(jraw, jspec, jspec, n))
        _check(a, _unpack(buf, spec, mb_w, mb_h))
    target = wire.merge_specs([s for _, s in packs])
    jtarget = jwire.merge_specs([s for _, s in jpacks])
    assert jtarget == target + (JAX_PATCH,)
    bufs = np.stack([wire.emit_wire(r, s, target, n) for r, s in packs])
    jbufs = np.stack([jwire.emit_wire(r, s, jtarget, n) for r, s in jpacks])
    assert np.array_equal(bufs, jbufs)
    got = wire.unpack_wire(torch.from_numpy(bufs), mb_w, mb_h, target)
    want = jwire.unpack_fn(mb_w, mb_h, jtarget, batched=True)(
        jnp.asarray(jbufs))
    assert set(got) == set(want) - {"patch"}
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.dtype == torch.int32 and v.shape == w.shape, k
        assert np.array_equal(v.numpy(), w), k
    for i, a in enumerate(abis):
        _check(a, {k: v[i].numpy() for k, v in got.items()})


def test_upload_wire_matches_upload_batch():
    """upload_wire over lanes of one stream's pictures (a merged spec,
    field cvoff and all) gives upload_batch's tensors, refid by its
    equality structure."""
    mb_w, mb_h, abis = _abis("batch_qcif_s3")
    cvoffs = [None, np.where(np.arange(64) < 3, 2, 0).astype(np.int32),
              None, np.zeros(64, np.int32)]
    abis = [dict(a) if c is None else dict(a, cvoff=c)
            for a, c in zip(abis[:4], cvoffs)]
    packs = [wire.pack_wire_raw(a, mb_w, mb_h) for a in abis]
    target = wire.merge_specs([s for _, s in packs])
    got = upload_wire(packs, target, mb_w, mb_h, "cpu", 4, cvoffs)
    want = upload_batch(abis, "cpu", 4)
    assert set(got) == set(want)
    for i, a in enumerate(abis):
        _check(a, {k: v[i].numpy() for k, v in got.items()})
        assert np.array_equal(got["cvoff"][i].numpy(),
                              want["cvoff"][i].numpy())
    with pytest.raises(ValueError, match="wire buffer"):
        wire.unpack_wire(torch.zeros((1, 8), dtype=torch.uint8), mb_w, mb_h,
                         target)


# ---- Decoder(upload="wire") against "dense" and the goldens --------------

def _decode(data: bytes, upload: str, monkeypatch, **kw):
    """(frames, the upload records of the trace, whether each picture's
    ABI had dense per-cell weights, decoder) of one decode."""
    wp = []
    orig = tpipeline.DevicePipeline.decode_frame

    def spy(self, abi):
        wp.append("wp" in abi)
        return orig(self, abi)

    monkeypatch.setattr(tpipeline.DevicePipeline, "decode_frame", spy)
    trace = io.StringIO()
    dec = Decoder(device="cpu", upload=upload, trace=trace, **kw)
    frames = [np.frombuffer(f.planar(), np.uint8)
              for f in dec.decode_annexb(data)]
    recs = [json.loads(ln) for ln in trace.getvalue().splitlines()]
    ups = [r for r in recs if r["t"] == "upload"]
    return frames, ups, wp, dec


def _assert_uploads(ups, wp, upload, dec):
    """One upload record a picture, in order, naming its mode: "dense"
    for the dense upload and for every picture with dense weights."""
    assert [r["frame"] for r in ups] == list(range(len(wp)))
    want = ["dense" if upload == "dense" or w else "wire" for w in wp]
    assert [r["mode"] for r in ups] == want
    assert sum(r["bytes"] for r in ups) == dec.stats.upload_bytes > 0


@pytest.mark.parametrize("name", DECODE_STREAMS)
def test_decoder_wire_equals_dense(name, monkeypatch):
    """Each committed stream decodes to its expected MD5s with either
    upload; feat_wp18's pictures with dense per-cell weights go dense
    through the wire decoder too."""
    meta = json.loads((DATA / f"{name}.json").read_text())
    data = (DATA / f"{name}.264").read_bytes()
    for upload in UPLOADS:
        frames, ups, wp, dec = _decode(data, upload, monkeypatch,
                                       conceal="concealed" in meta)
        assert [hashlib.md5(f.tobytes()).hexdigest() for f in frames] \
            == meta["md5"], upload
        _assert_uploads(ups, wp, upload, dec)
        if name == "feat_wp18":
            assert any(wp) and not all(wp)


@pytest.mark.parametrize("name", FIELD_STREAMS)
def test_decoder_wire_equals_dense_fields(h264ref, tmp_path, name,
                                          monkeypatch):
    """The hand-written field streams decode equal to their goldens with
    either upload (cvoff rides beside the wire buffer)."""
    make, construct = FIELD_STREAMS[name]
    data = make()
    if construct is not None:
        want = list(construct())
    else:
        p = tmp_path / "s.264"
        p.write_bytes(data)
        want = list(golden_decode(str(p))[0])
    for upload in UPLOADS:
        frames, ups, wp, dec = _decode(data, upload, monkeypatch)
        assert len(frames) == len(want), upload
        for i, (f, w) in enumerate(zip(frames, want)):
            assert np.array_equal(f, w), (upload, i)
        _assert_uploads(ups, wp, upload, dec)


def test_decoder_upload_checked():
    with pytest.raises(ValueError, match="upload 'bogus'"):
        Decoder(device="cpu", upload="bogus")
