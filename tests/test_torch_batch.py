"""The port's lockstep multi-stream decode on the CPU
(arrow_h264_tpu_torch.parallel.batch.BatchDecoder): byte-equal to the
libavcodec golden and to the JAX package's BatchDecoder on the same
streams, with a corrupt lane, with device-resident output and with both
orders; its batched upload and reference store against the single-lane
ones.  Every comparison is exact."""

import functools
import hashlib
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu_torch import convert
from arrow_h264_tpu_torch.api import PendingFrame
from arrow_h264_tpu_torch.ops.inter import halfpel_planes, pad_chroma
from arrow_h264_tpu_torch.models.pipeline import (
    decode_frame_fn, decode_frames_batch_fn, dpb_alloc, store_ref_fn,
    store_refs_fn, upload_abi, upload_batch,
)
from arrow_h264_tpu_torch.parallel.batch import (
    BatchDecoder, decode_batch_lockstep,
)
from tests.torch_ref import FLAT4, FLAT8, decode_port, host_arrays
from tools import streams

DATA = Path(__file__).resolve().parent / "data"
# QCIF config-4 lanes of 3, 4, 5 and 3 frames (tools/smoke_stream.py):
# B pictures that store nothing, and lanes that finish early and ship the
# dummy ABI
QCIF_LANES = [DATA / f"batch_qcif_s{i}.264" for i in range(1, 5)]
N_LANES = 8


def _planar(frames) -> np.ndarray:
    return np.stack([np.frombuffer(f.planar(), np.uint8) for f in frames])


@pytest.fixture(scope="module")
def cfg2_lanes(h264ref, tmp_path_factory):
    """Eight 64x64 config-2 streams of 3 frames: (datas, goldens)."""
    tmp = tmp_path_factory.mktemp("cfg2")
    datas, goldens = [], []
    for i in range(N_LANES):
        p = str(tmp / f"s{i}.264")
        streams.encode(streams.make_content(64, 64, 3, seed=100 + i), 64, 64,
                       p, streams.CONFIG_OPTS[2])
        datas.append(open(p, "rb").read())
        goldens.append(streams.golden_decode(p)[0])
    return datas, goldens


def test_batch_decoder_streams(cfg2_lanes):
    """Eight lanes in lockstep: each equal to its golden and to the JAX
    package's BatchDecoder on the same bytes; one round per picture."""
    from arrow_h264_tpu.parallel.batch import BatchDecoder as JaxBatchDecoder
    datas, goldens = cfg2_lanes
    with BatchDecoder(N_LANES, device="cpu") as bd:
        outs = bd.decode(datas)
    assert bd.errors == [None] * N_LANES
    assert (bd.rounds, bd.inter_rounds) == (3, 2)
    jax_outs = JaxBatchDecoder(N_LANES).decode(datas)
    for i, (frames, golden) in enumerate(zip(outs, goldens)):
        ours = _planar(frames)
        assert np.array_equal(ours, golden), f"lane {i}"
        assert np.array_equal(ours, _planar(jax_outs[i])), f"lane {i}"
    stats = bd.stats
    assert [s["frames"] for s in stats] == [3] * N_LANES
    assert all(s["host_parse_s"] > 0 and s["device_dispatch_s"] > 0
               for s in stats)


@pytest.mark.parametrize("order", ["phase", "raster"])
def test_batch_decoder_orders(h264ref, order):
    """QCIF config-4 lanes of 3, 4, 5 and 3 frames (weighted P/B, non-
    reference B pictures, lanes ending in different rounds) with either
    order of the intra and deblock kernels: each lane equal to its golden
    hashes and to libavcodec."""
    with BatchDecoder(len(QCIF_LANES), device="cpu", order=order) as bd:
        outs = bd.decode([p.read_bytes() for p in QCIF_LANES])
    assert bd.errors == [None] * len(QCIF_LANES)
    assert bd.rounds == 5
    for p, frames in zip(QCIF_LANES, outs):
        meta = json.loads(p.with_suffix(".json").read_text())
        ours = _planar(frames)
        assert [hashlib.md5(f.tobytes()).hexdigest() for f in ours] \
            == meta["md5"], p.name
        assert np.array_equal(ours, streams.golden_decode(str(p))[0])


def test_batch_decoder_error_isolation(cfg2_lanes):
    """A corrupt lane is recorded in errors; the other lanes stay exact."""
    datas, goldens = cfg2_lanes
    datas = list(datas)
    bad = 2
    datas[bad] = datas[bad][:len(datas[bad]) // 2] + b"\x00\x17" * 40
    with BatchDecoder(N_LANES, device="cpu") as bd:
        outs = bd.decode(datas)
    assert bd.errors[bad] is not None
    for i in range(N_LANES):
        if i != bad:
            assert bd.errors[i] is None, (i, bd.errors[i])
            assert np.array_equal(_planar(outs[i]), goldens[i]), f"lane {i}"


def test_batch_decoder_parse_pool_stress(cfg2_lanes, monkeypatch):
    """Sixteen lanes on sixteen pool threads, more than this host's cores,
    with a short thread switch interval: every lane still exact."""
    datas, goldens = cfg2_lanes
    monkeypatch.setattr(os, "cpu_count", lambda: 64)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with BatchDecoder(2 * N_LANES, device="cpu") as bd:
            assert bd._pool._max_workers == 2 * N_LANES
            outs = bd.decode(datas + datas)
    finally:
        sys.setswitchinterval(interval)
    assert bd.errors == [None] * 2 * N_LANES
    for i, frames in enumerate(outs):
        assert np.array_equal(_planar(frames), goldens[i % N_LANES]), i


def test_batch_decoder_device_resident(cfg2_lanes):
    """materialize=False: every frame stays a PendingFrame on the decode
    device, and finalize() gives the golden bytes."""
    datas, goldens = cfg2_lanes
    with BatchDecoder(N_LANES, device="cpu", materialize=False) as bd:
        outs = bd.decode(datas)
    assert bd.errors == [None] * N_LANES
    for i, (frames, golden) in enumerate(zip(outs, goldens)):
        assert all(isinstance(f, PendingFrame) and f.y.device.type == "cpu"
                   for f in frames), i
        assert np.array_equal(_planar([f.finalize() for f in frames]),
                              golden), f"lane {i}"


def test_batch_decoder_on_frame_streaming(cfg2_lanes):
    """on_frame gets each frame once, in output order, as its round
    commits; its return value takes the frame's place."""
    datas, goldens = cfg2_lanes
    seen: list[list] = [[] for _ in range(N_LANES)]

    def consume(i, f):
        assert isinstance(f, PendingFrame)
        seen[i].append(f.finalize())

    with BatchDecoder(N_LANES, device="cpu", materialize=False,
                      on_frame=consume) as bd:
        outs = bd.decode(datas)
    assert bd.errors == [None] * N_LANES
    for i, golden in enumerate(goldens):
        assert outs[i] == [None] * len(golden), i
        assert np.array_equal(_planar(seen[i]), golden), f"lane {i}"
    with pytest.raises(ValueError, match="materialize=False"):
        BatchDecoder(2, device="cpu", on_frame=consume)


def test_lockstep_step_matches_jax():
    """decode_batch_lockstep over eight synthetic P lanes equals the JAX
    package's sharded lockstep step on the 8-device mesh, with the JAX
    DPBs carried over, and the port's own per-lane decode_frame_fn."""
    from arrow_h264_tpu.models import pipeline as jpipeline
    from arrow_h264_tpu.ops.synthetic import synthetic_abi_p
    from arrow_h264_tpu.ops.transforms import make_ws_consts
    from arrow_h264_tpu.parallel.batch import (
        decode_batch_lockstep as jax_lockstep,
    )
    from arrow_h264_tpu.parallel.sharding import (
        make_stream_mesh, sharded_decode_fn,
    )
    n = len(jax.devices())
    assert n == N_LANES, f"conftest should provide 8 cpu devices, got {n}"
    mb_w, mb_h = 2, 2
    H, W = mb_h * 16, mb_w * 16
    mesh = make_stream_mesh()
    ws4, ws8 = make_ws_consts(FLAT4, FLAT8)
    abis = [synthetic_abi_p(mb_w, mb_h, seed=i, n_mv=6) for i in range(n)]
    rng = np.random.default_rng(5)
    jdpbs = []
    for _ in range(n):
        dpb = jpipeline.dpb_alloc(mb_w, mb_h, 2)
        for s in range(2):
            dpb = jpipeline.store_ref_fn(*dpb, s, *(
                jnp.asarray(rng.integers(0, 256, shape, np.uint8))
                for shape in ((H, W), (H // 2, W // 2), (H // 2, W // 2))))
        jdpbs.append(dpb)
    fn = sharded_decode_fn(mesh, mb_w, mb_h, ws4, ws8, inter_mode="pl0")
    want = jax_lockstep(fn, abis, jdpbs,
                        [np.array([0, 1, -1, -1], np.int32)] * n, mesh)

    dpbs = [convert.dpb_from_jax(np.asarray(y), np.asarray(c), mb_w, mb_h)
            for y, c in jdpbs]
    tws4, tws8 = convert.ws_from_jax(ws4, ws8)
    kw = dict(mb_w=mb_w, mb_h=mb_h, ws4=tws4, ws8=tws8, cqp_off=(0, 0))
    got = decode_batch_lockstep(abis, dpbs, **kw)
    for p, w in zip(got, want):
        assert p.shape[0] == n
        assert np.array_equal(p.numpy(), np.asarray(w)[:, :p.shape[1]])
    for i in range(n):
        single = decode_frame_fn(upload_abi(abis[i], "cpu"), *dpbs[i],
                                 inter=True, **kw)
        for p, s in zip(got, single):
            assert torch.equal(p[i], s), f"lane {i}"


@functools.lru_cache(maxsize=None)
def _qcif_pictures():
    """(host ABI, pipeline, DPB luma, DPB chroma) of each picture of the
    5-frame QCIF lane, the DPB as the port's Decoder read it."""
    capture = []
    decode_port(str(QCIF_LANES[2]), capture=capture)
    return capture


def test_store_refs_fn_matches_store_ref_fn():
    """One batched store equals writing each storing lane's half-pel
    planes and padded chroma into its slot one by one, and the DPB rows of
    the lanes that store nothing are unchanged."""
    mb_w, mb_h, B, S = 3, 2, 4, 3
    H, W = mb_h * 16, mb_w * 16
    g = torch.Generator().manual_seed(9)
    dy, dc = (t.view((B, S) + t.shape[1:]) for t in
              dpb_alloc(mb_w, mb_h, B * S, "cpu"))
    dy.copy_(torch.randint(0, 256, dy.shape, generator=g, dtype=torch.uint8))
    dc.copy_(torch.randint(0, 256, dc.shape, generator=g, dtype=torch.uint8))
    planes = [torch.randint(0, 256, s, generator=g, dtype=torch.uint8)
              for s in ((B, H, W), (B, H // 2, W // 2), (B, H // 2, W // 2))]
    lanes, slots = [3, 0], [1, 2]
    want_y, want_c = dy.clone(), dc.clone()
    for i, s in zip(lanes, slots):
        want_y[i, s] = torch.stack(halfpel_planes(planes[0][i]))
        want_c[i, s, 0] = pad_chroma(planes[1][i])
        want_c[i, s, 1] = pad_chroma(planes[2][i])
    before_y, before_c = dy.clone(), dc.clone()
    store_refs_fn(dy, dc, lanes, slots, *planes)
    assert torch.equal(dy, want_y) and torch.equal(dc, want_c)
    for i in (1, 2):
        assert torch.equal(dy[i], before_y[i])
        assert torch.equal(dc[i], before_c[i])
    store_refs_fn(dy, dc, [], [], *planes)
    assert torch.equal(dy, want_y) and torch.equal(dc, want_c)
    store_ref_fn(dy[1], dc[1], 0, *(p[1] for p in planes))
    assert torch.equal(dy[1, 0], torch.stack(halfpel_planes(planes[0][1])))
    assert torch.equal(dy[1, 1:], before_y[1, 1:])


def test_upload_batch_zero_classes():
    """A coefficient class that is zero in one lane but not in another is
    shipped for both, zero rows included; a class zero in every lane is
    left out."""
    abis = [host_arrays(a) for a, *_ in _qcif_pictures()[:2]]
    assert abis[0]["luma4"].any()
    abis[1]["luma4"] = np.zeros_like(abis[1]["luma4"])
    for a in abis:
        a["pcm"] = np.zeros_like(a["pcm"])
    out = upload_batch(abis, "cpu")
    assert "pcm" not in out
    assert out["luma4"].shape == (2,) + abis[0]["luma4"].shape
    assert torch.equal(out["luma4"][0], torch.from_numpy(abis[0]["luma4"]))
    assert not out["luma4"][1].any()
    assert out["wtab"].dtype == torch.int32
    for k, v in upload_abi(abis[0], "cpu").items():
        assert torch.equal(v, out[k][0]), k


def _dense(abi: dict) -> dict:
    """The ABI with dense per-cell weights in place of the slice tables,
    as ops.abi's slice-row overflow fallback ships it."""
    out = {k: v for k, v in abi.items() if k not in ("wtab", "slogwd")}
    sid = abi["slice_id"]
    r0 = np.clip(abi["refidx"][..., 0], -1, 31) + 1
    r1 = np.clip(abi["refidx"][..., 1], -1, 31) + 1
    t = abi["wtab"][sid[:, None, None], r0, r1].astype(np.int32)
    out["wp"] = np.stack([t[..., 0:2], t[..., 2:4]], axis=3)
    out["logwd"] = abi["slogwd"][sid].astype(np.int32)
    return out


def test_upload_batch_mixed_dense_weights():
    """A round that mixes a dense-weight lane with table lanes ships wp /
    logwd for every lane, and each lane's planes equal what DevicePipeline
    gives that lane alone."""
    pics = [p for p in _qcif_pictures()
            if (p[0]["kind"] >= 4).any()][:3]           # P and B pictures
    assert len(pics) == 3
    abis = [host_arrays(a) for a, *_ in pics]
    abis[1] = _dense(abis[1])
    batch = upload_batch(abis, "cpu")
    assert "wp" in batch and "wtab" not in batch
    pipe = pics[0][1]
    got = decode_frames_batch_fn(
        batch, torch.stack([p[2] for p in pics]),
        torch.stack([p[3] for p in pics]), inter=True, **pipe._kw)
    for i, (_, p, dy, dc) in enumerate(pics):
        alone = decode_frame_fn(upload_abi(abis[i], "cpu"), dy, dc,
                                inter=True, **p._kw)
        for g, a in zip(got, alone):
            assert torch.equal(g[i], a), f"lane {i}"


def test_batch_decoder_device_is_explicit():
    """BatchDecoder() defaults to CUDA and refuses to run without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchDecoder(2)
    with pytest.raises(ValueError, match="order 'bogus'"):
        BatchDecoder(2, device="cpu", order="bogus")


def test_batch_decoder_lanes_share_parameters(h264ref):
    """Lanes of another resolution cannot join a lockstep batch."""
    with BatchDecoder(2, device="cpu") as bd, \
            pytest.raises(ValueError, match="stream parameters"):
        bd.decode([QCIF_LANES[0].read_bytes(),
                   (DATA / "smoke_1080p_high.264").read_bytes()])

