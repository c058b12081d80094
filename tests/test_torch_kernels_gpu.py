"""The CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device and skip without one.  They import no JAX,
so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_gpu.py
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from arrow_h264_tpu_torch.models.pipeline import dpb_alloc, store_ref_fn
from arrow_h264_tpu_torch.ops import kernels
from arrow_h264_tpu_torch.ops.deblock import (
    deblock_filter_planes, deblock_tables,
)
from arrow_h264_tpu_torch.ops.inter import mc_chroma_plain, mc_luma_plain
from arrow_h264_tpu_torch.ops.intra import intra_reconstruct
from arrow_h264_tpu_torch.ops.kernels.deblock_phase import deblock_phase
from arrow_h264_tpu_torch.ops.kernels.deblock_raster import deblock_raster
from arrow_h264_tpu_torch.ops.kernels.intra_phase import intra_phase
from arrow_h264_tpu_torch.ops.kernels.intra_raster import intra_raster
from arrow_h264_tpu_torch.ops.kernels.mc import mc_chroma, mc_luma
from arrow_h264_tpu_torch.ops.synthetic import (
    random_intra_abi, synthetic_batch,
)
from arrow_h264_tpu_torch.ops.transforms import (
    make_ws_consts, residual_planes,
)

pytestmark = pytest.mark.cuda

SMOKE = Path(__file__).resolve().parent / "data" / "smoke_1080p_high.264"
SIZES = [(7, 5), (22, 18)]            # ragged grid edges; CIF
RASTER_SIZES = [(7, 5), (120, 68)]     # ragged grid edges; 1080p


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.uint8
        assert torch.equal(g, w.to(torch.uint8))


def _residual(a, mb_w, mb_h, dev):
    ws4, ws8 = (t.to(dev) for t in make_ws_consts([[16] * 16] * 6,
                                                  [[16] * 64] * 2))
    return residual_planes(a, mb_w, mb_h, ws4, ws8)


@pytest.mark.parametrize("mb_w,mb_h", SIZES)
@pytest.mark.parametrize("inter", [False, True])
def test_intra_and_deblock_kernels(dev, mb_w, mb_h, inter):
    _, a = synthetic_batch(mb_w, mb_h, 3, dev, inter=inter,
                           **({"intra_frac": 0.4, "bi_frac": 0.3}
                              if inter else {}))
    res = _residual(a, mb_w, mb_h, dev)
    H, W = mb_h * 16, mb_w * 16
    g = torch.Generator(device=dev).manual_seed(3)
    init = [torch.randint(0, 256, s, generator=g, device=dev,
                          dtype=torch.int32)
            for s in ((1, H, W), (1, H // 2, W // 2), (1, H // 2, W // 2))]
    n0 = kernels.LAUNCHES["intra_phase"]
    got = intra_phase(a, *res, *init, mb_w, mb_h)
    assert kernels.LAUNCHES["intra_phase"] == n0 + 1
    _equal(got, intra_reconstruct(a, *res, mb_w, mb_h, *init))
    tables = deblock_tables(a, mb_w, mb_h, (1, -1))
    want = deblock_filter_planes(*got, tables, mb_w, mb_h)
    _equal(deblock_phase(*(p.clone() for p in got), tables, mb_w, mb_h), want)


@pytest.mark.parametrize("mb_w,mb_h", RASTER_SIZES)
@pytest.mark.parametrize("inter", [False, True])
def test_raster_kernels(dev, mb_w, mb_h, inter):
    """K5/K6 against the plain versions and against K1/K2 on the same
    inputs."""
    _, a = synthetic_batch(mb_w, mb_h, 4, dev, inter=inter,
                           **({"intra_frac": 0.4, "bi_frac": 0.3}
                              if inter else {}))
    res = _residual(a, mb_w, mb_h, dev)
    H, W = mb_h * 16, mb_w * 16
    g = torch.Generator(device=dev).manual_seed(4)
    init = [torch.randint(0, 256, s, generator=g, device=dev,
                          dtype=torch.int32)
            for s in ((1, H, W), (1, H // 2, W // 2), (1, H // 2, W // 2))]
    n0 = dict(kernels.LAUNCHES)
    got = intra_raster(a, *res, *init, mb_w, mb_h)
    assert kernels.LAUNCHES["intra_raster"] == n0["intra_raster"] + 1
    _equal(got, intra_reconstruct(a, *res, mb_w, mb_h, *init))
    _equal(got, intra_phase(a, *res, *init, mb_w, mb_h))
    tables = deblock_tables(a, mb_w, mb_h, (1, -1))
    want = deblock_filter_planes(*got, tables, mb_w, mb_h)
    filtered = deblock_raster(*(p.clone() for p in got), tables, mb_w, mb_h)
    assert kernels.LAUNCHES["deblock_raster"] == n0["deblock_raster"] + 1
    _equal(filtered, want)
    _equal(filtered, deblock_phase(*(p.clone() for p in got), tables,
                                   mb_w, mb_h))


def _random_inputs(mb_w, mb_h, B, seed, dev):
    """B streams of random intra ABIs (random modes and availability) over
    random init planes, and random deblock tables (every bS, tc0, alpha,
    beta): (abi, residual planes, init planes, tables)."""
    H, W = mb_h * 16, mb_w * 16
    n = mb_w * mb_h
    rng = np.random.default_rng(seed)
    abis = [random_intra_abi(mb_w, mb_h, 7 * seed + i) for i in range(B)]
    a = {k: torch.from_numpy(np.stack([x[k] for x in abis])).to(dev)
         for k in abis[0]}
    shapes = ((B, H, W), (B, H // 2, W // 2), (B, H // 2, W // 2))
    res = [rng.integers(-300, 300, s).astype(np.int32) for s in shapes]
    for i, x in enumerate(abis):          # PCM residuals are raw samples
        pcm = np.kron((x["kind"] == 3).reshape(mb_h, mb_w),
                      np.ones((16, 16), bool))
        res[0][i] = np.where(pcm, res[0][i] % 256, res[0][i])
        for c in res[1:]:
            c[i] = np.where(pcm[::2, ::2], c[i] % 256, c[i])
    res = [torch.from_numpy(r).to(dev) for r in res]
    init = [torch.from_numpy(rng.integers(0, 256, s).astype(np.int32))
            .to(dev) for s in shapes]

    def t(lo, hi, *shape):
        return torch.from_numpy(rng.integers(lo, hi, (B, n) + shape)
                                .astype(np.int32)).to(dev)

    tables = {"bs_v": t(0, 5, 4, 4), "tc_v": t(0, 26, 4, 4),
              "a_v": t(0, 256, 4), "b_v": t(0, 19, 4),
              "bs_h": t(0, 5, 4, 4), "tc_h": t(0, 26, 4, 4),
              "a_h": t(0, 256, 4), "b_h": t(0, 19, 4),
              "bs_c": t(0, 5, 2, 2, 4), "tc_c": t(0, 26, 2, 2, 4, 2),
              "a_c": t(0, 256, 2, 2, 2), "b_c": t(0, 19, 2, 2, 2)}
    # no edge at the picture border, as deblock_tables guarantees
    tables["bs_v"].view(B, mb_h, mb_w, 4, 4)[:, :, 0, 0] = 0
    tables["bs_h"].view(B, mb_h, mb_w, 4, 4)[:, 0, :, 0] = 0
    tables["bs_c"].view(B, mb_h, mb_w, 2, 2, 4)[:, :, 0, 0, 0] = 0
    tables["bs_c"].view(B, mb_h, mb_w, 2, 2, 4)[:, 0, :, 1, 0] = 0
    return a, res, init, tables


@pytest.mark.parametrize("mb_w,mb_h", [(5, 4), (9, 2)])
def test_kernels_random_batch(dev, mb_w, mb_h):
    """Three streams of random intra ABIs and random deblock tables in one
    launch each, against the plain versions."""
    a, res, init, tables = _random_inputs(mb_w, mb_h, 3, mb_w, dev)
    got = intra_phase(a, *res, *init, mb_w, mb_h)
    _equal(got, intra_reconstruct(a, *res, mb_w, mb_h, *init))
    _equal(intra_raster(a, *res, *init, mb_w, mb_h), got)
    want = deblock_filter_planes(*got, tables, mb_w, mb_h)
    _equal(deblock_phase(*(p.clone() for p in got), tables, mb_w, mb_h), want)
    _equal(deblock_raster(*(p.clone() for p in got), tables, mb_w, mb_h),
           want)


def _device_kernels(call, name):
    """(call's result, how many times it put the kernel `name` on the card),
    counted from torch.profiler's device activities."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = call()
        torch.cuda.synchronize()
    return out, sum(e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and name in e.key)


@pytest.mark.parametrize("mb_w,mb_h,B", [(1, 1, 1), (1, 6, 1), (6, 1, 1),
                                         (7, 5, 1), (120, 68, 1),
                                         (120, 68, 4)])
def test_wavefront_kernels(dev, mb_w, mb_h, B):
    """K1/K2 against the plain versions on edge grids (one MB wide or
    high, 1 x 1) and at 1080p, where B = 4 streams hold far more MBs than
    the card has resident blocks; each call puts its kernel on the card
    once."""
    a, res, init, tables = _random_inputs(mb_w, mb_h, B, mb_w + mb_h, dev)
    got, n = _device_kernels(lambda: intra_phase(a, *res, *init, mb_w, mb_h),
                             "intra_phase_kernel")
    assert n == 1
    _equal(got, intra_reconstruct(a, *res, mb_w, mb_h, *init))
    want = deblock_filter_planes(*got, tables, mb_w, mb_h)
    filtered, n = _device_kernels(
        lambda: deblock_phase(*(p.clone() for p in got), tables, mb_w, mb_h),
        "deblock_phase_kernel")
    assert n == 1
    _equal(filtered, want)


def test_wavefront_kernels_repeat(dev):
    """50 calls of K1 and of K2 on one 1080p input: a race between an MB
    and the neighbours it waits on would make some output differ from the
    first or from the plain version."""
    a, res, init, tables = _random_inputs(120, 68, 1, 11, dev)
    first = intra_phase(a, *res, *init, 120, 68)
    _equal(first, intra_reconstruct(a, *res, 120, 68, *init))
    for _ in range(49):
        _equal(intra_phase(a, *res, *init, 120, 68), first)
    want = deblock_filter_planes(*first, tables, 120, 68)
    for _ in range(50):
        _equal(deblock_phase(*(p.clone() for p in first), tables, 120, 68),
               want)


@pytest.mark.parametrize("mb_w,mb_h", SIZES)
@pytest.mark.parametrize("wild", [False, True])
def test_mc_kernels(dev, mb_w, mb_h, wild):
    H, W = mb_h * 16, mb_w * 16
    n_slots = 3
    dy, dc = dpb_alloc(mb_w, mb_h, n_slots, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    for s in range(n_slots):
        store_ref_fn(dy, dc, s, *(
            torch.randint(0, 256, shp, generator=g, device=dev,
                          dtype=torch.uint8)
            for shp in ((H, W), (H // 2, W // 2), (H // 2, W // 2))))
    abi, a = synthetic_batch(mb_w, mb_h, 5, dev, inter=True,
                             n_slots=n_slots, bi_frac=0.5)
    mv = a["mv"]
    if wild:
        rng = np.random.default_rng(5)
        mv = torch.from_numpy(rng.integers(-512, 513, tuple(mv.shape))
                              .astype(np.int32)).to(dev)
    rs = a["refslot"]
    assert torch.equal(mc_luma(dy[None], mv, rs, mb_w, mb_h),
                       mc_luma_plain(dy[None], mv, rs, mb_w, mb_h))
    assert torch.equal(mc_chroma(dc[None], mv, rs, mb_w, mb_h),
                       mc_chroma_plain(dc[None], mv, rs, mb_w, mb_h))


def test_wrappers_refuse_bad_tensors(dev):
    _, a = synthetic_batch(7, 5, 1, dev)
    res = _residual(a, 7, 5, dev)
    with pytest.raises(TypeError):
        intra_phase(a, res[0].long(), *res[1:], None, None, None, 7, 5)
    dy, _ = dpb_alloc(7, 5, 2, dev)
    with pytest.raises(ValueError):
        mc_luma(dy[None], a["mv"].transpose(2, 3), a["refslot"], 7, 5)


@pytest.mark.parametrize("order,path", [
    ("phase", {"intra_phase", "deblock_phase", "mc_luma", "mc_chroma"}),
    ("raster", {"intra_raster", "deblock_raster", "mc_luma", "mc_chroma"})])
def test_decoder_cuda_smoke_stream(dev, order, path):
    from arrow_h264_tpu_torch.api import Decoder
    meta = json.loads(SMOKE.with_suffix(".json").read_text())
    kernels.reset_launches()
    md5 = [hashlib.md5(f.planar()).hexdigest()
           for f in Decoder(device=dev, order=order).decode_annexb(
               SMOKE.read_bytes())]
    assert md5 == meta["md5"]
    assert {k for k, v in kernels.LAUNCHES.items() if v} == path, \
        kernels.LAUNCHES
