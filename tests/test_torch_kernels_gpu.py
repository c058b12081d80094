"""The CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device and skip without one.  They import no JAX,
so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_gpu.py
"""

import hashlib
import json
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from arrow_h264_tpu_torch.models.pipeline import dpb_alloc
from arrow_h264_tpu_torch.ops import kernels
from arrow_h264_tpu_torch.ops.deblock import (
    deblock_filter_planes, deblock_tables,
)
from arrow_h264_tpu_torch.ops.inter import (
    PAD, PADC, mc_chroma_plain, mc_luma_plain,
)
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
# the committed 1080i PAFF streams (tools/field_smoke.py)
FIELD_1080I = [SMOKE.parent / f"field_1080i_s{i}.264" for i in (0, 1)]
# QCIF config-4 lanes of 3, 4, 5 and 3 frames (tools/smoke_stream.py)
QCIF_LANES = [SMOKE.parent / f"batch_qcif_s{i}.264" for i in range(1, 5)]
SIZES = [(7, 5), (22, 18)]            # ragged grid edges; CIF
RASTER_SIZES = [(7, 5), (120, 68)]     # ragged grid edges; 1080p
MC_SIZES = [(1, 1), (7, 5), (22, 18), (120, 68)]
MC_SLOTS = 3


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


# order -> the intra and deblock kernels of Decoder(order=...), by name
ORDERS = {"phase": {"intra_phase": intra_phase,
                    "deblock_phase": deblock_phase},
          "raster": {"intra_raster": intra_raster,
                     "deblock_raster": deblock_raster}}
# edge grids (one MB wide or high, 1 x 1) and 1080p, where B = 4 streams
# hold far more MBs than the card has resident blocks
WAVEFRONT_GRIDS = [(1, 1, 1), (1, 6, 1), (6, 1, 1), (7, 5, 1), (120, 68, 1),
                   (120, 68, 4)]


@pytest.mark.parametrize("mb_w,mb_h,B", WAVEFRONT_GRIDS)
@pytest.mark.parametrize("order", ORDERS)
def test_wavefront_kernels(dev, order, mb_w, mb_h, B):
    """K1/K2 (knight-move wavefront) and K5/K6 (row pipeline) against the
    plain versions on each of WAVEFRONT_GRIDS; each wrapper call counts
    one launch (test_wavefront_kernels_launch_once counts the card's)."""
    (intra, intra_fn), (deblock, deblock_fn) = ORDERS[order].items()
    a, res, init, tables = _random_inputs(mb_w, mb_h, B, mb_w + mb_h, dev)
    n0 = dict(kernels.LAUNCHES)
    got = intra_fn(a, *res, *init, mb_w, mb_h)
    filtered = deblock_fn(*(p.clone() for p in got), tables, mb_w, mb_h)
    assert kernels.LAUNCHES[intra] == n0[intra] + 1
    assert kernels.LAUNCHES[deblock] == n0[deblock] + 1
    _equal(got, intra_reconstruct(a, *res, mb_w, mb_h, *init))
    _equal(filtered, deblock_filter_planes(*got, tables, mb_w, mb_h))


def test_wavefront_kernels_launch_once(dev):
    """One call of each of K1, K2, K5 and K6 on each of WAVEFRONT_GRIDS
    puts that kernel on the card once: one torch.profiler session over
    all the calls counts as many device launches of each kernel as calls
    (a call that launched nothing would also fail test_wavefront_kernels).
    One session, as in chip_smoke.py: on the card, sessions after the
    first dozen or so in a process came back with no device activity at
    all."""
    from torch.profiler import ProfilerActivity, profile
    calls = []
    for mb_w, mb_h, B in WAVEFRONT_GRIDS:
        a, res, init, tables = _random_inputs(mb_w, mb_h, B, mb_w + mb_h, dev)
        planes = tuple(p.to(torch.uint8) for p in init)
        for (intra, intra_fn), (deblock, deblock_fn) in (
                o.items() for o in ORDERS.values()):
            calls.append((intra, partial(intra_fn, a, *res, *init, mb_w,
                                         mb_h)))
            calls.append((deblock, partial(deblock_fn, *planes, tables,
                                           mb_w, mb_h)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _, call in calls:
            call()
            torch.cuda.synchronize()
    seen = {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}
    for name in {n for n, _ in calls}:
        assert sum(c for k, c in seen.items() if f"{name}_kernel" in k) \
            == len(WAVEFRONT_GRIDS), (name, seen)


@pytest.mark.parametrize("order", ORDERS)
def test_wavefront_kernels_repeat(dev, order):
    """50 calls of the intra and of the deblock kernel of `order` on one
    1080p input: a race between an MB and the neighbours it waits on
    would make some output differ from the first or from the plain
    version."""
    intra_fn, deblock_fn = ORDERS[order].values()
    a, res, init, tables = _random_inputs(120, 68, 1, 11, dev)
    first = intra_fn(a, *res, *init, 120, 68)
    _equal(first, intra_reconstruct(a, *res, 120, 68, *init))
    for _ in range(49):
        _equal(intra_fn(a, *res, *init, 120, 68), first)
    want = deblock_filter_planes(*first, tables, 120, 68)
    for _ in range(50):
        _equal(deblock_fn(*(p.clone() for p in first), tables, 120, 68),
               want)


def _mc_dpbs(mb_w, mb_h, B, seed, dev):
    """B DPBs of MC_SLOTS slots with random bytes in every sample, padding
    included, so a column or row clamped at the wrong place reads another
    value than the plain version's."""
    H, W = mb_h * 16, mb_w * 16
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randint(0, 256, shape, generator=g, device=dev,
                               dtype=torch.uint8)
                 for shape in ((B, MC_SLOTS, 4, H + 2 * PAD, W + 2 * PAD),
                               (B, MC_SLOTS, 2, H // 2 + 2 * PADC,
                                W // 2 + 2 * PADC)))


def _mc_motion(mb_w, mb_h, B, mvs, seed, dev):
    """(mv, refslot) of B streams.  synthetic: synthetic_batch's P/B MVs
    and slots; wild: MVs anywhere in +-2048 quarter samples; edge:
    integer MV parts at the columns and rows where the reads reach each
    edge of the 32-sample padding and just past it, and +-512.  wild and
    edge draw each list's slot from -1 (unused) .. MC_SLOTS + 1 (a slot
    >= S clamps to S - 1)."""
    n = mb_w * mb_h
    rng = np.random.default_rng(seed)
    shape = (B, n, 4, 4, 2, 2)
    if mvs == "synthetic":
        abis = [synthetic_batch(mb_w, mb_h, seed + i, dev, inter=True,
                                n_slots=MC_SLOTS, bi_frac=0.5)[1]
                for i in range(B)]
        return (torch.cat([a["mv"] for a in abis]),
                torch.cat([a["refslot"] for a in abis]))
    if mvs == "wild":
        mv = rng.integers(-2048, 2049, shape)
    else:
        near = np.array([PAD + k for k in (-2, -1, 0, 1, 2)])
        ints = np.concatenate([near, -near, [-512, 512, 0, 3, -5]])
        mv = rng.choice(ints, shape) * 4 + rng.integers(0, 8, shape)
    rs = rng.integers(-1, MC_SLOTS + 2, shape[:-1])
    return (torch.from_numpy(mv.astype(np.int32)).to(dev),
            torch.from_numpy(rs.astype(np.int32)).to(dev))


def _mc_equal(dy, dc, mv, rs, mb_w, mb_h, cvoff=None):
    """K3 and K4 equal to their plain versions, uint8; K4 with the slots'
    chroma offsets cvoff [B, S] (zeros, as frames pass, by default).
    Each wrapper call adds one to its LAUNCHES count; this does not see
    how many kernels the call put on the card (chip_smoke.py counts those
    with torch.profiler)."""
    if cvoff is None:
        cvoff = torch.zeros(dc.shape[:2], dtype=torch.int32, device=dc.device)
    for kern, plain, dpb, extra in ((mc_luma, mc_luma_plain, dy, ()),
                                    (mc_chroma, mc_chroma_plain, dc,
                                     (cvoff,))):
        n0 = kernels.LAUNCHES[kern.__name__]
        got = kern(dpb, mv, rs, *extra, mb_w, mb_h)
        assert kernels.LAUNCHES[kern.__name__] == n0 + 1
        want = plain(dpb, mv, rs, *extra, mb_w, mb_h)
        assert got.dtype == want.dtype == torch.uint8
        assert torch.equal(got, want), kern.__name__


@pytest.mark.parametrize("mb_w,mb_h", MC_SIZES)
@pytest.mark.parametrize("mvs", ["synthetic", "wild", "edge"])
@pytest.mark.parametrize("B", [1, 3])
def test_mc_kernels(dev, mb_w, mb_h, mvs, B):
    seed = 5 + mb_w + 3 * B
    dy, dc = _mc_dpbs(mb_w, mb_h, B, seed, dev)
    mv, rs = _mc_motion(mb_w, mb_h, B, mvs, seed, dev)
    _mc_equal(dy, dc, mv, rs, mb_w, mb_h)


@pytest.mark.parametrize("mb_w,mb_h", MC_SIZES)
@pytest.mark.parametrize("mvs", ["synthetic", "wild", "edge"])
@pytest.mark.parametrize("B", [1, 3])
def test_mc_chroma_cvoff(dev, mb_w, mb_h, mvs, B):
    """K4 with a cross-parity chroma offset of -2, 0 or +2 per lane and
    slot, as field pictures pass it (wild and edge slots >= S clamp, and
    take the offset of slot S - 1)."""
    seed = 7 + mb_w + 3 * B
    dy, dc = _mc_dpbs(mb_w, mb_h, B, seed, dev)
    mv, rs = _mc_motion(mb_w, mb_h, B, mvs, seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    cvoff = (torch.randint(-1, 2, (B, MC_SLOTS), generator=g, device=dev,
                           dtype=torch.int32) * 2)
    _mc_equal(dy, dc, mv, rs, mb_w, mb_h, cvoff)


def test_mc_chroma_refuses_bad_cvoff(dev):
    """cvoff must be int32 [B, S] on the DPB's device: else K4 raises,
    with no launch."""
    dy, dc = _mc_dpbs(7, 5, 1, 1, dev)
    mv, rs = _mc_motion(7, 5, 1, "synthetic", 1, dev)
    before = dict(kernels.LAUNCHES)
    good = torch.zeros((1, MC_SLOTS), dtype=torch.int32, device=dev)
    for bad, err in ((good[:, :-1], ValueError), (good.long(), TypeError),
                     (good.cpu(), ValueError)):
        with pytest.raises(err, match="cvoff"):
            mc_chroma(dc, mv, rs, bad, 7, 5)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("pos", range(64))
def test_mc_kernels_positions(dev, pos):
    """Every chroma 1/8-sample position (yFrac, xFrac) = divmod(pos, 8),
    and with it every luma quarter-sample position, as one MV of each
    list over a 7x5 grid."""
    fy, fx = divmod(pos, 8)
    dy, dc = _mc_dpbs(7, 5, 1, pos, dev)
    mv = torch.empty((1, 35, 4, 4, 2, 2), dtype=torch.int32, device=dev)
    mv[..., 0, :] = torch.tensor([16 + fx, -24 + fy])
    mv[..., 1, :] = torch.tensor([-40 + fx, 8 + fy])
    rs = torch.zeros((1, 35, 4, 4, 2), dtype=torch.int32, device=dev)
    rs[..., 1] = 2
    _mc_equal(dy, dc, mv, rs, 7, 5)


def test_mc_wrappers_refuse_unaligned(dev):
    """The word reads need a 4-byte aligned DPB, the MV load an 8-byte
    aligned mv: a view that is not raises, with no launch."""
    dy, dc = _mc_dpbs(7, 5, 1, 1, dev)
    mv, rs = _mc_motion(7, 5, 1, "synthetic", 1, dev)
    before = dict(kernels.LAUNCHES)
    for kern, dpb in ((mc_luma, dy), (mc_chroma, dc)):
        flat = torch.empty(dpb.numel() + 1, dtype=torch.uint8, device=dev)
        view = flat[1:].view(dpb.shape)
        assert view.is_contiguous() and view.data_ptr() % 4
        extra = () if kern is mc_luma else (
            torch.zeros((1, MC_SLOTS), dtype=torch.int32, device=dev),)
        with pytest.raises(ValueError, match="aligned"):
            kern(view, mv, rs, *extra, 7, 5)
        words = torch.empty(mv.numel() + 1, dtype=torch.int32, device=dev)
        mv_view = words[1:].view(mv.shape)
        assert mv_view.data_ptr() % 8
        with pytest.raises(ValueError, match="aligned"):
            kern(dpb, mv_view, rs, *extra, 7, 5)
    assert kernels.LAUNCHES == before


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


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("stream", FIELD_1080I, ids=lambda p: p.stem)
def test_decoder_cuda_field_stream(dev, stream, order):
    """A committed 1080i PAFF stream on the card: every woven frame equal
    to its libavcodec MD5; the order's intra and deblock kernels launched
    once a field, K3/K4 once a P or B field (all but the I pair)."""
    from arrow_h264_tpu_torch.api import Decoder
    meta = json.loads(stream.with_suffix(".json").read_text())
    kernels.reset_launches()
    md5 = [hashlib.md5(f.planar()).hexdigest()
           for f in Decoder(device=dev, order=order).decode_annexb(
               stream.read_bytes())]
    assert md5 == meta["md5"]
    fields = 2 * len(md5)
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update(dict.fromkeys(ORDERS[order], fields))
    want.update(mc_luma=fields - 2, mc_chroma=fields - 2)
    assert kernels.LAUNCHES == want


@pytest.mark.parametrize("order", ORDERS)
def test_batch_decoder_cuda(dev, order):
    """BatchDecoder(4) on the card: every lane equal to the port's CPU
    decode of the same bytes and to its golden hashes; the order's intra
    and deblock kernels launched once a round and K3/K4 once a round with
    an inter lane, not once a lane."""
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    datas = [p.read_bytes() for p in QCIF_LANES]
    kernels.reset_launches()
    with BatchDecoder(len(datas), device=dev, order=order) as bd:
        outs = bd.decode(datas)
    launches = dict(kernels.LAUNCHES)
    assert bd.errors == [None] * len(datas)
    assert bd.rounds == 5 and 0 < bd.inter_rounds < bd.rounds
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update(dict.fromkeys(ORDERS[order], bd.rounds))
    want.update(mc_luma=bd.inter_rounds, mc_chroma=bd.inter_rounds)
    assert launches == want
    for p, data, frames in zip(QCIF_LANES, datas, outs):
        meta = json.loads(p.with_suffix(".json").read_text())
        ours = [f.planar() for f in frames]
        assert [hashlib.md5(b).hexdigest() for b in ours] == meta["md5"]
        assert ours == [f.planar() for f in Decoder(
            device="cpu", order=order).decode_annexb(data)]
