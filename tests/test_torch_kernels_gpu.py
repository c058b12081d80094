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
    PAD, PADC, inter_init_plain, mc_chroma_plain, mc_luma_plain,
    store_refs_plain,
)
from arrow_h264_tpu_torch.ops.intra import intra_reconstruct
from arrow_h264_tpu_torch.ops.kernels.deblock_phase import deblock_phase
from arrow_h264_tpu_torch.ops.kernels.deblock_raster import deblock_raster
from arrow_h264_tpu_torch.ops.kernels.deblock_tables import (
    deblock_tables as deblock_tables_k7,
)
from arrow_h264_tpu_torch.ops.kernels.inter_combine import inter_combine
from arrow_h264_tpu_torch.ops.kernels.intra_phase import intra_phase
from arrow_h264_tpu_torch.ops.kernels.intra_raster import intra_raster
from arrow_h264_tpu_torch.ops.kernels.mc import mc_chroma, mc_luma
from arrow_h264_tpu_torch.ops.kernels.residual import (
    CLASS_SHAPES, residual_planes as residual_k9,
)
from arrow_h264_tpu_torch.ops.kernels.store_ref import store_refs
from arrow_h264_tpu_torch.ops.kernels import unpack_bm8 as k8
from arrow_h264_tpu_torch.ops.kernels import unpack_wire as k12
from arrow_h264_tpu_torch.ops.kernels.unpack_bm8 import (
    DEVICE_LAUNCHES, unpack_bm8,
)
from arrow_h264_tpu_torch.ops.kernels.unpack_wire import (
    device_launches as k12_launches, unpack_wire as unpack_wire_k12,
)
from arrow_h264_tpu_torch.ops.synthetic import (
    WIRE_CASES, forced_wire_round, random_deblock_abi, random_deblock_tables,
    random_intra_abi, random_residual_abi, random_weighted_abi,
    synthetic_batch,
)
from arrow_h264_tpu_torch.ops.transforms import (
    make_ws_consts, residual_planes,
)
from arrow_h264_tpu_torch.ops.wire import (
    _scatter_bm8, unpack_wire, unpack_wire_plain,
)
from tools.gpu_conformance import bm8_tally, want_launches
from tools.mc_bench import SPLITS, partitioned_motion

pytestmark = pytest.mark.cuda

SMOKE = Path(__file__).resolve().parent / "data" / "smoke_1080p_high.264"
# the committed 1080i PAFF streams (tools/field_smoke.py)
FIELD_1080I = [SMOKE.parent / f"field_1080i_s{i}.264" for i in (0, 1)]
# QCIF config-4 lanes of 3, 4, 5 and 3 frames (tools/smoke_stream.py)
QCIF_LANES = [SMOKE.parent / f"batch_qcif_s{i}.264" for i in range(1, 5)]
STRIP_4K = (240, 4)                    # 3840x64: the width of 3840x2160
SIZES = [(7, 5), (22, 18), STRIP_4K]   # ragged grid edges; CIF; 4K strip
RASTER_SIZES = [(7, 5), (120, 68), STRIP_4K]   # ... 1080p; 4K strip
MC_SIZES = [(1, 1), (7, 5), (22, 18), (120, 68), STRIP_4K]
MC_MOTION = ["synthetic", "wild", "edge", "partitions", "edge_mbs"]
# widths that are not a multiple of the MC kernels' strip of MBs (SW = 8
# in csrc/mc.cu), and a one-row picture
MC_STRIPS = [(7, 5), (1, 6), (6, 1)]
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
    random init planes, and random deblock tables (random_deblock_tables:
    every bS, tc0, alpha, beta): (abi, residual planes, init planes,
    tables)."""
    H, W = mb_h * 16, mb_w * 16
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
    tables = {k: torch.from_numpy(v).to(dev) for k, v in
              random_deblock_tables(mb_w, mb_h, B, seed).items()}
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


# one MB, one MB wide or high, a ragged grid and 1080p
DEBLOCK_GRIDS = [(1, 1), (1, 6), (6, 1), (7, 5), (120, 68)]


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mb_w,mb_h", DEBLOCK_GRIDS)
@pytest.mark.parametrize("tables", ["random", "field"])
def test_deblock_kernels_tables(dev, tables, mb_w, mb_h, B):
    """K2 and K6 on B streams of random planes, with random tables (bS
    0..4, tc0 0..25, alpha and beta 0..255 on every edge inside the
    picture) or with the tables of field pictures (deblock_tables(...,
    field=True) of synthetic P/B ABIs with intra MBs): each equal to the
    plain version, one launch a call."""
    seed = 1000 * B + 10 * mb_w + mb_h
    rng = np.random.default_rng(seed)
    H, W = mb_h * 16, mb_w * 16
    planes = [torch.from_numpy(rng.integers(0, 256, s).astype(np.uint8))
              .to(dev) for s in ((B, H, W), (B, H // 2, W // 2),
                                 (B, H // 2, W // 2))]
    if tables == "random":
        tabs = {k: torch.from_numpy(v).to(dev) for k, v in
                random_deblock_tables(mb_w, mb_h, B, seed).items()}
    else:
        abis = [synthetic_batch(mb_w, mb_h, seed + i, dev, inter=True,
                                intra_frac=0.4, bi_frac=0.3)[1]
                for i in range(B)]
        a = {k: torch.cat([x[k] for x in abis]) for k in abis[0]}
        tabs = deblock_tables(a, mb_w, mb_h, (1, -1), field=True)
    want = deblock_filter_planes(*planes, tabs, mb_w, mb_h)
    n0 = dict(kernels.LAUNCHES)
    for name, fn in (("deblock_phase", deblock_phase),
                     ("deblock_raster", deblock_raster)):
        _equal(fn(*(p.clone() for p in planes), tabs, mb_w, mb_h), want)
        assert kernels.LAUNCHES[name] == n0[name] + 1


def _table_abi(source, mb_w, mb_h, B, seed, dev):
    """B pictures' deblocking fields on the card: synthetic I or P/B
    ABIs (bS 0..4 from intra MBs, coefficients, MVs and references) or
    random_deblock_abi (every rule of deblock_tables)."""
    if source == "random":
        return {k: torch.from_numpy(v).to(dev) for k, v in
                random_deblock_abi(mb_w, mb_h, B, seed).items()}
    abis = [synthetic_batch(mb_w, mb_h, seed + i, dev,
                            inter=source != "synthetic_i",
                            **({} if source == "synthetic_i" else
                               {"intra_frac": 0.3, "bi_frac": 0.4}))[1]
            for i in range(B)]
    return {k: torch.cat([x[k] for x in abis]) for k in abis[0]}


@pytest.mark.parametrize("field", [False, True], ids=["frame", "field"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mb_w,mb_h", DEBLOCK_GRIDS)
@pytest.mark.parametrize("source", ["synthetic_i", "synthetic_p", "random"])
def test_deblock_tables_kernel(dev, source, mb_w, mb_h, B, field):
    """K7 on B pictures: every one of the twelve tables torch.equal to
    the plain deblock_tables (dtype and shape included), each 16-byte
    aligned as K2/K6 need; one launch a call."""
    a = _table_abi(source, mb_w, mb_h, B, 3 * mb_w + mb_h + B, dev)
    want = deblock_tables(a, mb_w, mb_h, (2, -3), field)
    n0 = kernels.LAUNCHES["deblock_tables"]
    got = deblock_tables_k7(a, mb_w, mb_h, (2, -3), field)
    assert kernels.LAUNCHES["deblock_tables"] == n0 + 1
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].data_ptr() % 16 == 0, k
        assert torch.equal(got[k], w), k


# (mb_w, mb_h, B): lanes that start off a 16-byte boundary (n = 99, 66)
# with a ragged last strip of K7's 32 MBs, strips that end mid-row, and
# 3840x2160 at B = 4 (past the L2)
TABLE_STRIPS = [(11, 9, 3), (33, 2, 3), (240, 135, 4)]


@pytest.mark.parametrize("field", [False, True], ids=["frame", "field"])
@pytest.mark.parametrize("mb_w,mb_h,B", TABLE_STRIPS)
@pytest.mark.parametrize("source", ["synthetic_p", "random"])
def test_deblock_tables_strips(dev, source, mb_w, mb_h, B, field):
    """K7 where its strips and lanes are not aligned, and at 4K B = 4:
    the twelve tables torch.equal to the plain deblock_tables."""
    a = _table_abi(source, mb_w, mb_h, B, mb_w + 7 * B, dev)
    want = deblock_tables(a, mb_w, mb_h, (-2, 3), field)
    got = deblock_tables_k7(a, mb_w, mb_h, (-2, 3), field)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("mb_w,mb_h,B", [(11, 9, 3), (120, 68, 1)])
def test_deblock_tables_unaligned_abi(dev, mb_w, mb_h, B):
    """ABI fields whose storage starts 4 bytes past a 16-byte boundary:
    K7 stages them a word at a time, with the same tables."""
    a = _table_abi("random", mb_w, mb_h, B, 5, dev)
    off = {}
    for k, t in a.items():
        flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=dev)
        at = (-(flat.data_ptr() // 4) + 1) % 4
        off[k] = flat[at:at + t.numel()].view(t.shape)
        off[k].copy_(t)
        assert off[k].data_ptr() % 16 == 4
    want = deblock_tables(a, mb_w, mb_h)
    got = deblock_tables_k7(off, mb_w, mb_h)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def _bm8_case(w, B, br, grid, seed, dev, strided=False):
    """B lanes of one bm8 class on the card, as the wire ships them: each
    lane's real rows (a different count a lane) at sorted unique dense
    rows, then padding rows at idx == grid with empty bitmaps; values
    enough for every set bit.  strided: the three sections are views of
    one [B, total] byte buffer, as unpack_wire reads them."""
    rng = np.random.default_rng(seed)
    bmw = (w + 15) // 16
    idx = np.full((B, br), grid, np.int32)
    bm = rng.integers(0, 1 << 16, (B, br, bmw)).astype(np.uint16)
    for b, k in enumerate(rng.integers(br // 3, br + 1, B)):
        idx[b, :k] = np.sort(rng.choice(grid, k, replace=False))
        bm[b, k:] = 0
    bm[:, ::7] = 0xFFFF
    bm[:, 3::7] = 0
    bv = 16 * bmw * br + 8
    vals = rng.integers(-128, 128, (B, bv)).astype(np.int8)
    if not strided:
        return (torch.from_numpy(idx).to(dev),
                torch.from_numpy(bm.view(np.int16)).to(dev),
                torch.from_numpy(vals).to(dev))
    o1, o2 = 4 * br, 4 * br + 2 * br * bmw
    parts = [idx.view(np.uint8).reshape(B, -1),
             bm.view(np.uint8).reshape(B, -1), vals.view(np.uint8),
             np.zeros((B, 8 + (-(o2 + bv)) % 8), np.uint8)]
    buf = torch.from_numpy(np.concatenate(parts, 1)).to(dev)
    return (buf[:, :o1].view(torch.int32),
            buf[:, o1:o2].view(torch.int16).reshape(B, br, bmw),
            buf[:, o2:o2 + bv].view(torch.int8))


# (w, rows, dense rows): the wire's classes (ldc/cdc 16/8 values a row)
# at small sizes and at the sizes of a 1080p l4 class, and lanes whose
# rows span many of the kernel's chunks of 1024 rows
BM8_CASES = [(8, 1, 1), (16, 40, 60), (64, 33, 40), (16, 2500, 3000),
             (8, 5000, 8160), (64, 3000, 32640), (16, 60000, 130560)]


@pytest.mark.parametrize("strided", [False, True], ids=["dense", "strided"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("w,br,grid", BM8_CASES)
def test_unpack_bm8_kernel(dev, w, br, grid, B, strided):
    """K8 on B lanes: torch.equal to the plain _scatter_bm8; one wrapper
    launch a call."""
    args = _bm8_case(w, B, br, grid, w + br + B, dev, strided)
    want = _scatter_bm8(*(t.contiguous() for t in args), grid, w)
    n0 = kernels.LAUNCHES["unpack_bm8"]
    got = unpack_bm8(*args, grid, w)
    assert kernels.LAUNCHES["unpack_bm8"] == n0 + 1
    assert got.dtype == torch.int32 and got.shape == (B, grid, w)
    assert torch.equal(got, want)


def _bm8_classes(specs, B, seed, dev):
    """The classes of `specs` ((w, rows, dense rows, what) each; what:
    "sorted", "unsorted" or "clamped") as _bm8_case makes them, laid out
    in one [B, total] byte buffer on the card (each lane's sections at
    4-byte aligned offsets, lanes a row stride apart that is 4 bytes off
    16) -> (buffer, class_table entries with the outputs' word offsets,
    the classes' numpy (idx, bm, vals, grid, w), output words)."""
    parts, entries, arrays, at, words = [], [], [], 0, 0
    for i, (w, br, grid, what) in enumerate(specs):
        rng = np.random.default_rng(seed + i)
        idx, bm, vals = (t.cpu().numpy() for t in _bm8_case(
            w, B, br, grid, seed + i, torch.device("cpu")))
        if what == "unsorted":
            for b in range(B):
                perm = rng.permutation(br)
                idx[b], bm[b] = idx[b, perm], bm[b, perm]
        if what == "clamped":                      # positions past the end
            vals = vals[:, :max(1, int((bm != 0).sum(2).sum(1).min()) * 4)]
        entry = []
        for a in (idx, bm, vals):
            lanes = np.ascontiguousarray(a).reshape(B, -1).view(np.uint8)
            entry.append(at)
            parts.append((at, lanes))
            at += -(-lanes.shape[1] // 8) * 8
        arrays.append((idx, bm, vals, grid, w))
        entries.append((*entry, br, vals.shape[1], grid, w, words))
        words += B * grid * w
    stride = at + 4 if (at + 4) % 16 else at + 8
    buf = np.zeros((B, stride), np.uint8)
    for off, lanes in parts:
        buf[:, off:off + lanes.shape[1]] = lanes
    return (torch.from_numpy(buf).to(dev), [
        (i, bm, v, stride, stride, stride, *rest)
        for i, bm, v, *rest in entries], arrays, words)


# class sets of one K8 call: the wire's widths and sizes, rows out of
# order, positions past the lane's last value, five classes at once
BM8_CLASS_SETS = {
    "wire": [(16, 2500, 3000, "sorted"), (64, 600, 750, "sorted"),
             (16, 900, 1500, "sorted"), (16, 40, 190, "sorted"),
             (8, 60, 190, "sorted")],
    "unsorted": [(16, 3000, 8000, "unsorted"), (8, 33, 40, "sorted")],
    "clamped": [(64, 700, 2000, "clamped"), (16, 5000, 9000, "clamped")],
    "many_chunks": [(16, 60000, 130560, "sorted")],
}


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("classes", BM8_CLASS_SETS)
def test_unpack_bm8_classes_kernel(dev, classes, B):
    """K8's one call over several classes (the table unpack_wire gives
    it: sections at offsets in one byte buffer, lanes a row stride
    apart): each class's region torch.equal to the plain _scatter_bm8;
    one wrapper launch."""
    buf, entries, arrays, words = _bm8_classes(
        BM8_CLASS_SETS[classes], B, 7 * B + len(classes), dev)
    t = k8.class_table(entries, B)
    out = torch.empty(words, dtype=torch.int32, device=dev)
    n0 = kernels.LAUNCHES["unpack_bm8"]
    k8.launch(buf.data_ptr(), out, t, B, dev)
    assert kernels.LAUNCHES["unpack_bm8"] == n0 + 1
    at = 0
    for idx, bm, vals, grid, w in arrays:
        want = _scatter_bm8(*(torch.from_numpy(np.ascontiguousarray(a))
                              .to(dev) for a in (idx, bm.view(np.int16),
                                                 vals)), grid, w)
        got = out[at:at + B * grid * w].view(B, grid, w)
        assert torch.equal(got, want)
        at += B * grid * w


@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("case", ["sparse", "base", "mixed"])
def test_unpack_bm8_round_kernel(dev, case, B):
    """K8's one call over every bm8 class of a wire round
    (unpack_bm8_round): each class torch.equal to _scatter_bm8 on its
    sections; one wrapper launch, two device kernels."""
    buf, spec = _wire_round(case, 120, 68, B, dev)
    keys = k12.bm8_keys(spec)
    want = {k: v for k, v in unpack_wire_plain(buf, 120, 68, spec).items()
            if k in keys}
    n0 = kernels.LAUNCHES["unpack_bm8"]
    got = k12.unpack_bm8_round(buf, 120, 68, spec)
    assert kernels.LAUNCHES["unpack_bm8"] == n0 + bool(keys)
    assert set(got) == keys and (keys or case == "mixed")
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert k12.bm8_launches(spec, 120 * 68) == (2 if keys else 0)


def _wire_round(case, mb_w, mb_h, B, dev):
    """(buf [B, total] uint8 on the card, lanes a row stride apart; spec):
    a wire round of WIRE_CASES[case] (ops/synthetic.py), its lanes
    cycling four random ABIs."""
    buf, spec = forced_wire_round(case, mb_w, mb_h, B, mb_w + B, distinct=4)
    wide = torch.from_numpy(buf.base).to(dev)
    return wide[:, :buf.shape[1]], spec


def _check_unpack(buf, mb_w, mb_h, spec):
    """K12 (and K8 for the bm8 classes) torch.equal to unpack_wire_plain
    for every key; one K12 wrapper launch, and one K8 launch where the
    round ships a bm8 class."""
    want = unpack_wire_plain(buf, mb_w, mb_h, spec)
    n0 = dict(kernels.LAUNCHES)
    got = unpack_wire_k12(buf, mb_w, mb_h, spec)
    bm8 = any(sch == "bm8" for _, sch, _ in spec)
    assert kernels.LAUNCHES == {**n0, "unpack_wire": n0["unpack_wire"] + 1,
                                "unpack_bm8": n0["unpack_bm8"] + bm8}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.int32 and g.shape == w.shape, k
        assert g.is_contiguous() or k == "wtab", k
        assert torch.equal(g, w), k


# (mb_w, mb_h): 1920x1080 and 3840x2160
WIRE_GRIDS = [(120, 68), (240, 135)]


@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("mb_w,mb_h", WIRE_GRIDS)
@pytest.mark.parametrize("case", WIRE_CASES)
def test_unpack_wire_kernel(dev, case, mb_w, mb_h, B):
    """K12 on wire rounds forced to every scheme (intra zero/sparse/dense;
    inter zero/base/base with sparse rows/dense; dense and dense16
    coefficient classes beside bm8 ones; pcm zero/sparse/dense; wtab
    zero/sparse), with padding rows and unsorted sparse rows."""
    buf, spec = _wire_round(case, mb_w, mb_h, B, dev)
    _check_unpack(buf, mb_w, mb_h, spec)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mb_w,mb_h", [(11, 9), (7, 5)])
@pytest.mark.parametrize("case", WIRE_CASES)
def test_unpack_wire_kernel_unaligned(dev, case, mb_w, mb_h, B):
    """K12 where a lane's words of a one-word key start off a 16-byte
    boundary (n = 99 and 35 at B = 3) and segments end off it: their
    heads and tails are stored word by word, every key torch.equal."""
    buf, spec = _wire_round(case, mb_w, mb_h, B, dev)
    _check_unpack(buf, mb_w, mb_h, spec)


def test_unpack_wire_refuses_bad_buffers(dev):
    """A buffer K12 does not take raises, through the wrapper and through
    ops/wire.py::unpack_wire, and launches nothing: no fallback to the
    plain version on the card."""
    buf, spec = _wire_round("sparse", 11, 9, 3, dev)
    B, total = buf.shape
    bad = {
        TypeError: [buf.view(torch.int8)],
        ValueError: [
            buf[:, :total - 8],                                  # width
            torch.zeros((B, total + 8), dtype=torch.uint8,
                        device=dev)[:, 1:total + 1],             # address
            torch.zeros((B, total + 2), dtype=torch.uint8,
                        device=dev)[:, :total],                  # stride
            torch.zeros((total, B), dtype=torch.uint8,
                        device=dev).t(),                         # columns
            torch.zeros((0, total), dtype=torch.uint8, device=dev)],
    }
    n0 = dict(kernels.LAUNCHES)
    for err, bufs in bad.items():
        for b in bufs:
            for fn in (unpack_wire_k12, unpack_wire):
                with pytest.raises(err):
                    fn(b, 11, 9, spec)
    assert kernels.LAUNCHES == n0
    _check_unpack(buf, 11, 9, spec)
    assert unpack_wire(buf, 11, 9, spec).keys() == \
        unpack_wire_plain(buf, 11, 9, spec).keys()


# frames of one MB kind, from one MB to 1080p
ONE_KIND_GRIDS = [(1, 1), (1, 6), (6, 1), (7, 5), (120, 68)]


def _one_kind_inputs(mb_w, mb_h, B, kind, seed, dev):
    """B streams whose MBs are all of `kind` (0 I4x4, 1 I8x8, 2 I16x16,
    3 PCM), over random init planes: the modes cycle over the MBs and
    blocks of the batch, so every mode occurs where the batch has room
    for it, and the availability bits are random (atr 0 and 1, reads at
    the picture border).  (abi, residual planes, init planes)."""
    H, W = mb_h * 16, mb_w * 16
    n = mb_w * mb_h
    rng = np.random.default_rng(seed)
    m = np.arange(B * n).reshape(B, n)
    a = {"kind": np.full((B, n), kind),
         "i4_modes": (16 * m[..., None] + np.arange(16)) % 9,
         "i4_avail": rng.integers(0, 2, (B, n, 16, 4)),
         "i8_modes": (4 * m[..., None] + np.arange(4)) % 9,
         "i8_avail": rng.integers(0, 2, (B, n, 4, 4)),
         "i16_mode": m % 4, "chroma_mode": (m + m // 4) % 4,
         "mb_avail": rng.integers(0, 2, (B, n, 3))}
    a = {k: torch.from_numpy(v.astype(np.int32)).to(dev)
         for k, v in a.items()}
    shapes = ((B, H, W), (B, H // 2, W // 2), (B, H // 2, W // 2))
    lo = 0 if kind == 3 else -300         # PCM residuals are raw samples
    res = [torch.from_numpy(rng.integers(lo, 256 if kind == 3 else 300, s)
                            .astype(np.int32)).to(dev) for s in shapes]
    init = [torch.from_numpy(rng.integers(0, 256, s).astype(np.int32))
            .to(dev) for s in shapes]
    return a, res, init


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("mb_w,mb_h", ONE_KIND_GRIDS)
@pytest.mark.parametrize("kind", [0, 1, 2, 3],
                         ids=["i4x4", "i8x8", "i16", "pcm"])
def test_intra_kernels_one_kind(dev, kind, mb_w, mb_h, B):
    """K1 and K5 on frames of one MB kind, so each path of the per-MB body
    (csrc/intra_mb.cuh) runs alone: equal to the plain version, and K5 to
    K1."""
    a, res, init = _one_kind_inputs(mb_w, mb_h, B, kind, 100 * kind + B, dev)
    want = intra_reconstruct(a, *res, mb_w, mb_h, *init)
    got = intra_phase(a, *res, *init, mb_w, mb_h)
    _equal(got, want)
    _equal(intra_raster(a, *res, *init, mb_w, mb_h), got)


# order -> the intra and deblock kernels of Decoder(order=...), by name
ORDERS = {"phase": {"intra_phase": intra_phase,
                    "deblock_phase": deblock_phase},
          "raster": {"intra_raster": intra_raster,
                     "deblock_raster": deblock_raster}}
# edge grids (one MB wide or high, 1 x 1) and 1080p, where B = 4 streams
# hold far more MBs than the card has resident blocks
WAVEFRONT_GRIDS = [(1, 1, 1), (1, 6, 1), (6, 1, 1), (7, 5, 1), (120, 68, 1),
                   (120, 68, 4), (*STRIP_4K, 1)]


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
    """One call of each of K1, K2, K5, K6, K7, K9, K10 and K11 on each
    of WAVEFRONT_GRIDS puts that kernel on the card once, one call of K8
    its DEVICE_LAUNCHES kernels, and one of K12 its device_launches (one,
    two with sparse rows): one torch.profiler session over all the
    calls counts as many device launches of each kernel as calls (a call
    that launched nothing would also fail test_wavefront_kernels).  One
    session, as in chip_smoke.py: on the card, sessions after the first
    dozen or so in a process came back with no device activity at all,
    and a session after another lost the records of short kernels."""
    from torch.profiler import ProfilerActivity, profile
    calls = []
    k12_calls = 0                  # K12's device launches over its calls
    for mb_w, mb_h, B in WAVEFRONT_GRIDS:
        a, res, init, tables = _random_inputs(mb_w, mb_h, B, mb_w + mb_h, dev)
        planes = tuple(p.to(torch.uint8) for p in init)
        for (intra, intra_fn), (deblock, deblock_fn) in (
                o.items() for o in ORDERS.values()):
            calls.append((intra, partial(intra_fn, a, *res, *init, mb_w,
                                         mb_h)))
            calls.append((deblock, partial(deblock_fn, *planes, tables,
                                           mb_w, mb_h)))
        calls.append(("deblock_tables", partial(
            deblock_tables_k7, _table_abi("random", mb_w, mb_h, B, mb_w, dev),
            mb_w, mb_h)))
        grid = 16 * mb_w * mb_h
        calls.append(("unpack_bm8", partial(
            unpack_bm8, *_bm8_case(16, B, max(1, grid // 2), grid, mb_h,
                                   dev), grid, 16)))
        # K12 on a round with no bm8 class (K8 would launch beside it)
        # and no sparse rows, and on one with sparse rows (two launches)
        for case in ("dense", "dense32"):
            buf, spec = _wire_round(case, mb_w, mb_h, B, dev)
            assert all(sch != "bm8" for _, sch, _ in spec)
            calls.append(("unpack_wire", partial(unpack_wire_k12, buf, mb_w,
                                                 mb_h, spec)))
            k12_calls += k12_launches(spec, mb_w * mb_h)
        calls.append(("residual", partial(
            residual_k9, _residual_abi(mb_w, mb_h, B, mb_w, dev), mb_w,
            mb_h, *_ws(dev), (1, -1), True)))
        calls.append(("inter_combine", partial(
            inter_combine, *_combine_case(mb_w, mb_h, B, mb_w, dev, "tables"),
            mb_w, mb_h)))
        calls.append(("store_refs", partial(
            store_refs, *_store_case(mb_w, mb_h, B, 2, mb_w, dev),
            list(range(B)), [1] * B, *_pictures(mb_w, mb_h, B, mb_w, dev))))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _, call in calls:
            call()
            torch.cuda.synchronize()
    seen = {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}
    for name in {n for n, _ in calls}:
        per_call = DEVICE_LAUNCHES if name == "unpack_bm8" else 1
        want = k12_calls if name == "unpack_wire" else \
            per_call * len(WAVEFRONT_GRIDS)
        assert sum(c for k, c in seen.items() if f"{name}_kernel" in k) \
            == want, (name, seen)
    assert len(WAVEFRONT_GRIDS) < k12_calls < 4 * len(WAVEFRONT_GRIDS)


# K9 (residual), K10 (inter_combine), K11 (store_refs)
STAGE_GRIDS = [(1, 1), (7, 5), (9, 1), (120, 68), STRIP_4K]
SCALED4 = [[6 + (7 * i + 3 * k) % 40 for k in range(16)] for i in range(6)]
SCALED8 = [[6 + (5 * i + 11 * k) % 60 for k in range(64)] for i in range(2)]


def _ws(dev, scaled=False):
    return tuple(t.to(dev) for t in make_ws_consts(
        SCALED4 if scaled else [[16] * 16] * 6,
        SCALED8 if scaled else [[16] * 64] * 2))


def _residual_abi(mb_w, mb_h, B, seed, dev, drop=()):
    return {k: torch.from_numpy(v).to(dev) for k, v in
            random_residual_abi(mb_w, mb_h, B, seed).items()
            if k not in drop}


def _check_residual(a, mb_w, mb_h, ws, cqp_off, bypass):
    n0 = kernels.LAUNCHES["residual"]
    got = residual_k9(a, mb_w, mb_h, *ws, cqp_off, bypass)
    assert kernels.LAUNCHES["residual"] == n0 + 1
    want = residual_planes(a, mb_w, mb_h, *ws, cqp_off, bypass)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32 and torch.equal(g, w)


@pytest.mark.parametrize("bypass", [False, True], ids=["lossy", "bypass"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mb_w,mb_h", STAGE_GRIDS)
def test_residual_kernel(dev, mb_w, mb_h, B, bypass):
    """K9 == ops/transforms.py::residual_planes on random_residual_abi
    (every MB kind, qp 0..51, tr8, PCM, every DPCM mode), a non-flat
    scaling matrix and both chroma QP offsets."""
    a = _residual_abi(mb_w, mb_h, B, mb_w + B, dev)
    _check_residual(a, mb_w, mb_h, _ws(dev, scaled=True), (2, -3), bypass)


@pytest.mark.parametrize("drop", [
    ("luma4",), ("luma8",), ("luma4", "luma_dc"), ("chroma_dc",),
    ("chroma_ac",), ("chroma_dc", "chroma_ac"), ("pcm",),
    tuple(k for k, _ in CLASS_SHAPES)], ids=lambda d: "-".join(d))
@pytest.mark.parametrize("bypass", [False, True], ids=["lossy", "bypass"])
def test_residual_kernel_absent_classes(dev, drop, bypass):
    """Classes the upload leaves out read as zero, as in the plain
    version (tr8 still picks the 8x8 result without luma4)."""
    a = _residual_abi(7, 5, 2, 11, dev, drop)
    _check_residual(a, 7, 5, _ws(dev), (-4, 5), bypass)


@pytest.mark.parametrize("inter", [False, True])
def test_residual_kernel_synthetic(dev, inter):
    """K9 on the synthetic I and P ABIs the other kernels' tests use."""
    _, a = synthetic_batch(120, 68, 8, dev, inter=inter)
    _check_residual(a, 120, 68, _ws(dev), (0, 0), False)


@pytest.mark.parametrize("mb_w,mb_h,B,bypass", [
    (11, 9, 2, False), (11, 9, 2, True), (240, 135, 4, False)])
def test_residual_kernel_sizes(dev, mb_w, mb_h, B, bypass):
    """K9 at QCIF (11x9 MBs: an odd width, a ragged strip) and at
    3840x2160 with four lanes."""
    a = _residual_abi(mb_w, mb_h, B, mb_h + B, dev)
    _check_residual(a, mb_w, mb_h, _ws(dev, scaled=True), (2, -3), bypass)


@pytest.mark.parametrize("bypass", [False, True], ids=["lossy", "bypass"])
@pytest.mark.parametrize("shift", [tuple(k for k, _ in CLASS_SHAPES),
                                   ("luma4", "chroma_ac", "pcm")],
                         ids=lambda s: "-".join(s))
def test_residual_kernel_unaligned_classes(dev, shift, bypass):
    """Class tensors whose base lies one word past a 16-byte boundary
    (views of one buffer): the kernel stages them a word at a time."""
    a = _residual_abi(11, 9, 2, 13, dev)
    for k in shift:
        buf = torch.empty(a[k].numel() + 4, dtype=torch.int32, device=dev)
        a[k] = buf[1:1 + a[k].numel()].view(a[k].shape).copy_(a[k])
        assert a[k].data_ptr() % 16 == 4
    _check_residual(a, 11, 9, _ws(dev, scaled=True), (2, -3), bypass)


def _combine_case(mb_w, mb_h, B, seed, dev, weights):
    """(abi, pred_y, pred_c, res_y, res_cb, res_cr) on the card:
    random_weighted_abi with per-slice tables ("tables"), one table for
    every lane ("shared", lane stride 0, as unpack_wire ships it) or
    dense wp/logwd ("dense"); random uint8 predictions and int32
    residuals -300..300."""
    a = {k: torch.from_numpy(v).to(dev) for k, v in random_weighted_abi(
        mb_w, mb_h, B, seed, weights == "dense").items()}
    if weights == "shared":
        a["wtab"] = a["wtab"][:1].expand_as(a["wtab"])
    H, W = 16 * mb_h, 16 * mb_w
    g = torch.Generator(device=dev).manual_seed(seed)
    pred = [torch.randint(0, 256, s, generator=g, device=dev,
                          dtype=torch.uint8)
            for s in ((B, 2, H, W), (B, 2, 2, H // 2, W // 2))]
    res = [torch.randint(-300, 300, s, generator=g, device=dev,
                         dtype=torch.int32)
           for s in ((B, H, W), (B, H // 2, W // 2), (B, H // 2, W // 2))]
    return a, *pred, *res


@pytest.mark.parametrize("weights", ["tables", "shared", "dense"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mb_w,mb_h", STAGE_GRIDS)
def test_inter_combine_kernel(dev, mb_w, mb_h, B, weights):
    """K10 == ops/inter.py::inter_init_plain: explicit and implicit
    weights, logwd 0..7, list-1-only cells, refidx -1 and past 31, dense
    wp; intra MBs come out 0."""
    case = _combine_case(mb_w, mb_h, B, mb_w * 3 + B, dev, weights)
    n0 = kernels.LAUNCHES["inter_combine"]
    got = inter_combine(*case, mb_w, mb_h)
    assert kernels.LAUNCHES["inter_combine"] == n0 + 1
    want = inter_init_plain(*case, mb_w, mb_h)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32 and torch.equal(g, w)


def test_inter_combine_refuses_unaligned(dev):
    """Inputs whose addresses the kernel's row accesses cannot take (a
    residual plane 4 bytes off 16, a luma prediction 1 byte off 4, a
    weight table off 16) raise and launch nothing: no fallback to the
    plain version on the card."""
    a, *rest = _combine_case(7, 5, 2, 3, dev, "tables")
    pred_y, pred_c, res_y, res_cb, res_cr = rest

    def off(t, nbytes):
        """t's values in a buffer, nbytes past its start."""
        flat = torch.empty(t.numel() * t.element_size() + 16,
                           dtype=torch.uint8, device=dev)
        return flat[nbytes:nbytes + t.numel() * t.element_size()].view(
            t.dtype).view(t.shape).copy_(t)

    n0 = dict(kernels.LAUNCHES)
    for args in ((a, pred_y, pred_c, off(res_y, 4), res_cb, res_cr),
                 (a, off(pred_y, 1), pred_c, res_y, res_cb, res_cr),
                 ({**a, "wtab": off(a["wtab"], 8)}, pred_y, pred_c, res_y,
                  res_cb, res_cr)):
        with pytest.raises(ValueError):
            inter_combine(*args, 7, 5)
    assert kernels.LAUNCHES == n0


def _pictures(mb_w, mb_h, B, seed, dev):
    H, W = 16 * mb_h, 16 * mb_w
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randint(0, 256, s, generator=g, device=dev,
                          dtype=torch.uint8)
            for s in ((B, H, W), (B, H // 2, W // 2), (B, H // 2, W // 2))]


def _store_case(mb_w, mb_h, B, S, seed, dev):
    """DPBs [B, S, ...] on the card full of random bytes."""
    H, W = 16 * mb_h, 16 * mb_w
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    return [torch.randint(0, 256, s, generator=g, device=dev,
                          dtype=torch.uint8)
            for s in ((B, S, 4, H + 2 * PAD, W + 2 * PAD),
                      (B, S, 2, H // 2 + 2 * PADC, W // 2 + 2 * PADC))]


def _check_store(dpbs, lanes, slots, pics):
    want = [d.clone() for d in dpbs]
    store_refs_plain(*want, lanes, slots, *pics)
    n0 = kernels.LAUNCHES["store_refs"]
    store_refs(*dpbs, lanes, slots, *pics)
    assert kernels.LAUNCHES["store_refs"] == n0 + 1
    for g, w in zip(dpbs, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lanes,slots", [([0], [0]), ([2, 0], [1, 2]),
                                         ([1, 2, 0], [0, 0, 1])])
@pytest.mark.parametrize("mb_w,mb_h", STAGE_GRIDS)
def test_store_refs_kernel(dev, mb_w, mb_h, lanes, slots):
    """K11 == ops/inter.py::store_refs_plain into DPBs full of other
    bytes: the storing lanes' slots get G, b, h, j and the padded chroma
    (borders and corners included), every other byte stays."""
    dpbs = _store_case(mb_w, mb_h, 3, 3, mb_w + len(lanes), dev)
    _check_store(dpbs, lanes, slots, _pictures(mb_w, mb_h, 3, mb_h, dev))


def test_store_refs_kernel_many_lanes(dev):
    """More storing lanes than one launch takes (kMaxLanes, 64)."""
    B = 70
    dpbs = _store_case(2, 1, B, 2, 5, dev)
    _check_store(dpbs, list(range(B)), [i % 2 for i in range(B)],
                 _pictures(2, 1, B, 6, dev))


def test_store_refs_kernel_lane_strides(dev):
    """Pictures that are slots of a [B, S, H, W] stack, as the bench's
    reference_dpb stores them."""
    B, S, mb_w, mb_h = 2, 3, 7, 5
    H, W = 16 * mb_h, 16 * mb_w
    g = torch.Generator(device=dev).manual_seed(9)
    y = torch.randint(0, 256, (B, S, H, W), generator=g, device=dev,
                      dtype=torch.uint8)
    c = torch.randint(0, 256, (B, S, 2, H // 2, W // 2), generator=g,
                      device=dev, dtype=torch.uint8)
    dpbs = _store_case(mb_w, mb_h, B, S, 9, dev)
    for s in range(S):
        _check_store(dpbs, [0, 1], [s, s], (y[:, s], c[:, s, 0], c[:, s, 1]))


@pytest.mark.parametrize("mb_w,mb_h,B", [(11, 9, 3), (240, 135, 4)])
def test_store_refs_kernel_sizes(dev, mb_w, mb_h, B):
    """K11 at QCIF (an odd mb_w: 8-byte chroma stores; tiles ragged on
    both axes) and at 3840x2160 with four storing lanes."""
    dpbs = _store_case(mb_w, mb_h, B, 2, mb_w, dev)
    _check_store(dpbs, list(range(B)), [1] * B,
                 _pictures(mb_w, mb_h, B, mb_h, dev))


def test_store_refs_kernel_unaligned_pictures(dev):
    """Pictures whose lanes start off 16-byte (luma) and 8-byte (chroma)
    boundaries: the kernel stages and copies them byte by byte."""
    mb_w, mb_h, B = 11, 9, 2
    pics = []
    for p in _pictures(mb_w, mb_h, B, 4, dev):
        buf = torch.empty(p.numel() + 8, dtype=torch.uint8, device=dev)
        pics.append(buf[3:3 + p.numel()].view(p.shape).copy_(p))
    assert all(p.data_ptr() % 8 == 3 for p in pics)
    _check_store(_store_case(mb_w, mb_h, B, 2, 5, dev), [1, 0], [0, 1],
                 pics)


def test_store_refs_refuses_unaligned_dpb(dev):
    """K11 writes 16-byte groups: a DPB view off a 16-byte boundary is
    refused with a ValueError, never launched."""
    mb_w, mb_h, B = 7, 5, 1
    dpbs = _store_case(mb_w, mb_h, B, 2, 1, dev)
    pics = _pictures(mb_w, mb_h, B, 1, dev)
    n0 = dict(kernels.LAUNCHES)
    for i in range(2):
        buf = torch.empty(dpbs[i].numel() + 8, dtype=torch.uint8, device=dev)
        bad = list(dpbs)
        bad[i] = buf[8:].view(dpbs[i].shape)
        with pytest.raises(ValueError, match="16-byte"):
            store_refs(*bad, [0], [1], *pics)
    assert kernels.LAUNCHES == n0


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
    >= S clamps to S - 1).  partitions: each MB one MV and slot a list,
    or split 16x8, 8x16, 8x8 or into its 16 cells, one MV and slot a part
    (slots up to MC_SLOTS + 1), so the kernels' shared windows and their
    per-cell windows meet in one block; edge_mbs: partitions, with every
    MB on the picture's border reading, with one MV for the MB, from
    beyond the padding on the side of that border."""
    n = mb_w * mb_h
    rng = np.random.default_rng(seed)
    shape = (B, n, 4, 4, 2, 2)
    if mvs in ("partitions", "edge_mbs"):
        mv, rs = (np.stack(a) for a in zip(*(
            partitioned_motion(mb_w, mb_h, seed + i, tuple(SPLITS),
                               n_slots=MC_SLOTS + 2, bi_frac=0.5)
            for i in range(B))))
        if mvs == "edge_mbs":
            mx, my = np.meshgrid(np.arange(mb_w), np.arange(mb_h))
            side = np.stack([(mx == mb_w - 1).astype(int) - (mx == 0),
                             (my == mb_h - 1).astype(int) - (my == 0)],
                            -1).reshape(n, 2)          # [n, (x, y)]
            far = rng.integers(PAD + 1, PAD + 40, (B, n, 1, 1, 2, 2))
            out = side[None, :, None, None, None] * (far * 4) \
                + rng.integers(0, 4, (B, n, 1, 1, 2, 2))
            border = (side != 0).any(-1)[None, :, None, None, None, None]
            mv = np.where(border, np.broadcast_to(out, mv.shape), mv)
            rs = np.where(border[..., 0], rs[:, :, :1, :1], rs)
        return (torch.from_numpy(mv.astype(np.int32)).to(dev),
                torch.from_numpy(rs.astype(np.int32)).to(dev))
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
@pytest.mark.parametrize("mvs", MC_MOTION)
@pytest.mark.parametrize("B", [1, 3])
def test_mc_kernels(dev, mb_w, mb_h, mvs, B):
    seed = 5 + mb_w + 3 * B
    dy, dc = _mc_dpbs(mb_w, mb_h, B, seed, dev)
    mv, rs = _mc_motion(mb_w, mb_h, B, mvs, seed, dev)
    _mc_equal(dy, dc, mv, rs, mb_w, mb_h)


@pytest.mark.parametrize("mb_w,mb_h", MC_SIZES)
@pytest.mark.parametrize("mvs", MC_MOTION)
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


@pytest.mark.parametrize("mb_w,mb_h", MC_STRIPS)
@pytest.mark.parametrize("mvs", MC_MOTION)
@pytest.mark.parametrize("B", [1, 3])
def test_mc_kernels_strips(dev, mb_w, mb_h, mvs, B):
    """Pictures whose last strip of MBs is cut short, with random
    cross-parity chroma offsets."""
    seed = 9 + mb_w + 3 * B
    dy, dc = _mc_dpbs(mb_w, mb_h, B, seed, dev)
    mv, rs = _mc_motion(mb_w, mb_h, B, mvs, seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    cvoff = (torch.randint(-1, 2, (B, MC_SLOTS), generator=g, device=dev,
                           dtype=torch.int32) * 2)
    _mc_equal(dy, dc, mv, rs, mb_w, mb_h, cvoff)


@pytest.mark.parametrize("mvs", ["synthetic", "partitions", "edge_mbs"])
def test_mc_kernels_unaligned_copies(dev, mvs):
    """A DPB 4-byte but not 8-byte aligned and an mv 8-byte but not
    16-byte aligned (what the wrappers take): the kernels stage them in
    4-byte copies, and still equal the plain versions."""
    dy, dc = _mc_dpbs(7, 5, 2, 3, dev)
    mv, rs = _mc_motion(7, 5, 2, mvs, 3, dev)

    def shifted(t, by):
        flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=dev)
        view = flat[by:by + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    dy4, dc4 = shifted(dy, 4), shifted(dc, 4)
    mv8, rs4 = shifted(mv, 2), shifted(rs, 1)
    assert dy4.data_ptr() % 8 == 4 and dc4.data_ptr() % 8 == 4
    assert mv8.data_ptr() % 16 == 8 and rs4.data_ptr() % 16 == 4
    _mc_equal(dy4, dc4, mv8, rs4, 7, 5)


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


@pytest.mark.parametrize("fn", [intra_phase, intra_raster])
def test_intra_wrappers_refuse_unaligned_residual(dev, fn):
    """The intra kernels copy residual rows 16 bytes at a time: a residual
    plane that does not start on 16 bytes is refused, never launched."""
    _, a = synthetic_batch(7, 5, 1, dev)
    res = _residual(a, 7, 5, dev)
    shifted = torch.empty(res[0].numel() + 1, dtype=torch.int32,
                          device=dev)[1:].view(res[0].shape)
    shifted.copy_(res[0])
    n0 = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        fn(a, shifted, *res[1:], None, None, None, 7, 5)
    assert kernels.LAUNCHES == n0


@pytest.mark.parametrize("fn", [deblock_phase, deblock_raster])
def test_deblock_wrappers_refuse_unaligned(dev, fn):
    """The deblock kernels copy 8- and 16-byte pieces of the planes and
    tables: a plane or a table that does not start on 16 bytes is
    refused, never launched."""
    planes, tables = [torch.zeros(s, dtype=torch.uint8, device=dev)
                      for s in ((1, 80, 112), (1, 40, 56), (1, 40, 56))], \
        {k: torch.from_numpy(v).to(dev)
         for k, v in random_deblock_tables(7, 5, 1, 0).items()}
    shifted = torch.empty(planes[1].numel() + 4, dtype=torch.uint8,
                          device=dev)[4:].view(planes[1].shape)
    n0 = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        fn(planes[0], shifted, planes[2], tables, 7, 5)
    word = torch.empty(tables["a_c"].numel() + 1, dtype=torch.int32,
                       device=dev)[1:].view(tables["a_c"].shape)
    with pytest.raises(ValueError, match="16-byte"):
        fn(*planes, {**tables, "a_c": word}, 7, 5)
    assert kernels.LAUNCHES == n0


@pytest.mark.parametrize("order,path", [
    ("phase", {"intra_phase", "deblock_phase", "mc_luma", "mc_chroma"}),
    ("raster", {"intra_raster", "deblock_raster", "mc_luma", "mc_chroma"})])
def test_decoder_cuda_smoke_stream(dev, order, path):
    """The smoke stream on the card: its golden MD5s; the order's kernels,
    K3/K4, K7 (deblock_tables), K8 (unpack_bm8), K9 (residual), K10
    (inter_combine), K11 (store_refs) and K12 (unpack_wire) launched and
    no other; K7, K9 and K12 once a picture, K8 once a bm8 class of each
    picture's wire, K10 with K3/K4, K11 once a reference picture's
    store."""
    from arrow_h264_tpu_torch.api import Decoder
    meta = json.loads(SMOKE.with_suffix(".json").read_text())
    kernels.reset_launches()
    with bm8_tally() as tally:
        md5 = [hashlib.md5(f.planar()).hexdigest()
               for f in Decoder(device=dev, order=order).decode_annexb(
                   SMOKE.read_bytes())]
    assert md5 == meta["md5"]
    assert {k for k, v in kernels.LAUNCHES.items() if v} == \
        path | {"deblock_tables", "unpack_bm8", "residual", "inter_combine",
                "store_refs", "unpack_wire"}, kernels.LAUNCHES
    assert tally["unpacks"] == kernels.LAUNCHES["deblock_tables"] == \
        kernels.LAUNCHES["residual"] == kernels.LAUNCHES["unpack_wire"] == \
        len(md5)
    assert kernels.LAUNCHES["unpack_bm8"] == tally["bm8"]
    assert kernels.LAUNCHES["inter_combine"] == kernels.LAUNCHES["mc_luma"]
    assert kernels.LAUNCHES["store_refs"] == tally["stores"] > 0


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("stream", FIELD_1080I, ids=lambda p: p.stem)
def test_decoder_cuda_field_stream(dev, stream, order):
    """A committed 1080i PAFF stream on the card: every woven frame equal
    to its libavcodec MD5; the order's intra and deblock kernels and K7
    launched once a field, K3/K4 once a P or B field (all but the I
    pair), K8 once a bm8 class of each field's wire."""
    from arrow_h264_tpu_torch.api import Decoder
    meta = json.loads(stream.with_suffix(".json").read_text())
    kernels.reset_launches()
    with bm8_tally() as tally:
        md5 = [hashlib.md5(f.planar()).hexdigest()
               for f in Decoder(device=dev, order=order).decode_annexb(
                   stream.read_bytes())]
    assert md5 == meta["md5"]
    fields = 2 * len(md5)
    assert tally["unpacks"] == fields
    assert kernels.LAUNCHES == want_launches(
        kernels.LAUNCHES, order, fields, fields - 2, tally["bm8"],
        stores=tally["stores"], unpacks=tally["unpacks"])


@pytest.mark.parametrize("order", ORDERS)
def test_batch_decoder_cuda(dev, order):
    """BatchDecoder(4) on the card: every lane equal to the port's CPU
    decode of the same bytes and to its golden hashes; the order's intra
    and deblock kernels and K7 launched once a round and K3/K4 once a
    round with an inter lane, not once a lane; K8 once a bm8 class of
    each round's wire."""
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    datas = [p.read_bytes() for p in QCIF_LANES]
    kernels.reset_launches()
    with bm8_tally() as tally, \
            BatchDecoder(len(datas), device=dev, order=order) as bd:
        outs = bd.decode(datas)
    launches = dict(kernels.LAUNCHES)
    assert bd.errors == [None] * len(datas)
    assert bd.rounds == 5 and 0 < bd.inter_rounds < bd.rounds
    assert tally["unpacks"] == bd.wire_rounds == bd.rounds
    assert launches == want_launches(launches, order, bd.rounds,
                                     bd.inter_rounds, tally["bm8"],
                                     stores=tally["stores"],
                                     unpacks=tally["unpacks"])
    for p, data, frames in zip(QCIF_LANES, datas, outs):
        meta = json.loads(p.with_suffix(".json").read_text())
        ours = [f.planar() for f in frames]
        assert [hashlib.md5(b).hexdigest() for b in ours] == meta["md5"]
        assert ours == [f.planar() for f in Decoder(
            device="cpu", order=order).decode_annexb(data)]


# the committed feature streams (tools/feature_streams.py) and the lanes
# of BatchDecoder runs over them: (lanes, rounds, rounds with an inter lane)
FEATURES = sorted(p.stem for p in SMOKE.parent.glob("feat_*.json"))
FEATURE_BATCHES = [
    (("feat_wp18", "feat_wp18"), 3, 2),
    (("feat_wp18", "feat_wp_table"), 3, 2),
    (("feat_cif_cfg2", "feat_cif_cfg3", "feat_cif_cfg4"), 4, 3),
    (("feat_fmo1080_interleave", "feat_fmo1080_explicit"), 3, 2),
    (("feat_lossless_qcif", "feat_lossless_qcif"), 5, 4),
    (("feat_qcif_cfg2", "batch_qcif_s3"), 5, 4),
]




@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", FEATURES)
def test_decoder_cuda_feature_stream(dev, name, order):
    """A committed feature stream (lossless, CIF, widths 512 and 976,
    FMO/ASO, concealment, dense weights) on the card: MD5s equal to its
    JSON's expected output, the order's intra and deblock kernels
    launched once a picture and K3/K4 once a picture with inter MBs,
    `concealed` as in the JSON."""
    from arrow_h264_tpu_torch.api import Decoder
    path = SMOKE.parent / f"{name}.264"
    meta = json.loads(path.with_suffix(".json").read_text())
    dec = Decoder(device=dev, order=order, conceal="concealed" in meta)
    kernels.reset_launches()
    with bm8_tally() as tally:
        md5 = [hashlib.md5(f.planar()).hexdigest()
               for f in dec.decode_annexb(path.read_bytes())]
    assert md5 == meta["md5"]
    assert kernels.LAUNCHES == want_launches(
        kernels.LAUNCHES, order, len(meta["structure"]),
        meta["mc_pictures"], tally["bm8"], stores=tally["stores"],
        unpacks=tally["unpacks"])
    if "concealed" in meta:
        assert [list(c) for c in dec.concealed] == meta["concealed"]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("lanes,rounds,inter", FEATURE_BATCHES,
                         ids=lambda v: "+".join(v) if isinstance(v, tuple)
                         else None)
def test_batch_decoder_cuda_features(dev, lanes, rounds, inter, order):
    """BatchDecoder over feature lanes on the card: dense weights beside
    dense or table weights, the CIF configs, the 1080p FMO streams,
    lossless lanes, and lanes of 2 and 5 DPB slots (the batch's DPB is
    sized for the largest; with lane 0's, lane 1 failed): every lane
    equal to its MD5s, one launch a round."""
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    kernels.reset_launches()
    with bm8_tally() as tally, \
            BatchDecoder(len(lanes), device=dev, order=order) as bd:
        outs = bd.decode([(SMOKE.parent / f"{n}.264").read_bytes()
                          for n in lanes])
    assert bd.errors == [None] * len(lanes)
    assert (bd.rounds, bd.inter_rounds) == (rounds, inter)
    assert tally["unpacks"] == bd.wire_rounds
    assert kernels.LAUNCHES == want_launches(kernels.LAUNCHES, order, rounds,
                                             inter, tally["bm8"],
                                             stores=tally["stores"],
                                             unpacks=tally["unpacks"])
    for n, frames in zip(lanes, outs):
        meta = json.loads((SMOKE.parent / f"{n}.json").read_text())
        assert [hashlib.md5(f.planar()).hexdigest() for f in frames] \
            == meta["md5"], n


@pytest.mark.parametrize("order", ORDERS)
def test_cli_cuda(dev, tmp_path, order):
    """`python -m arrow_h264_tpu_torch decode` of the smoke stream on the
    card writes its golden frames and exits 0; `info` exits 0; `--ref`
    against a reference with one byte flipped exits 1."""
    import subprocess
    import sys
    repo = SMOKE.parent.parent.parent
    meta = json.loads(SMOKE.with_suffix(".json").read_text())
    out = tmp_path / "out.yuv"

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "arrow_h264_tpu_torch",
                               *args], cwd=repo, capture_output=True,
                              text=True, timeout=600).returncode

    assert cli("decode", str(SMOKE), str(out), "--order", order) == 0
    yuv = out.read_bytes()
    size = meta["width"] * meta["height"] * 3 // 2
    assert [hashlib.md5(yuv[i:i + size]).hexdigest()
            for i in range(0, len(yuv), size)] == meta["md5"]
    assert cli("info", str(SMOKE)) == 0
    flipped = bytearray(yuv)
    flipped[len(flipped) // 3] ^= 0x10
    (tmp_path / "ref.yuv").write_bytes(flipped)
    assert cli("decode", str(SMOKE), str(out), "--order", order, "--ref",
               str(tmp_path / "ref.yuv")) == 1


def test_wire_upload_cuda(dev, monkeypatch):
    """upload_wire on the card at B = 4 (four pictures of a QCIF lane, I,
    P and B, under one merged spec) gives upload_batch's tensors: every
    key equal, refid by its equality structure (ops.wire.unpack_wire)."""
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.models import pipeline
    from arrow_h264_tpu_torch.models.pipeline import (
        upload_batch, upload_wire,
    )
    from arrow_h264_tpu_torch.ops.wire import merge_specs, pack_wire_raw
    abis = []
    orig = pipeline.DevicePipeline.decode_frame

    def spy(self, abi):
        abis.append({k: v.copy() for k, v in abi.items()
                     if isinstance(v, np.ndarray)})
        return orig(self, abi)

    monkeypatch.setattr(pipeline.DevicePipeline, "decode_frame", spy)
    list(Decoder(device=dev).decode_annexb(QCIF_LANES[2].read_bytes()))
    abis = abis[:4]
    assert any((a["kind"] >= 4).any() for a in abis)
    mb_w, mb_h = 11, 9
    packs = [pack_wire_raw(a, mb_w, mb_h) for a in abis]
    target = merge_specs([s for _, s in packs])
    got = upload_wire(packs, target, mb_w, mb_h, dev, 4)
    want = upload_batch(abis, dev, 4)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.device == w.device and g.dtype == w.dtype, k
        if k == "refid":
            assert torch.equal(g < 0, w < 0)
            gf, wf = g.reshape(4, -1), w.reshape(4, -1)
            assert torch.equal(gf[:, :, None] == gf[:, None, :128],
                               wf[:, :, None] == wf[:, None, :128])
        else:
            assert torch.equal(g, w), k


@pytest.mark.parametrize("order", ORDERS)
def test_batch_decoder_cuda_two_shards(dev, order):
    """BatchDecoder(4) with two shards on one card: every lane equal to
    its golden hashes, every round through the wire, and the order's
    intra and deblock kernels and K7 launched twice a round (once a
    shard), K8 once a bm8 class of each shard's wire."""
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    datas = [p.read_bytes() for p in QCIF_LANES]
    kernels.reset_launches()
    with bm8_tally() as tally, \
            BatchDecoder(len(datas), device=dev, mesh=(dev, dev),
                         order=order) as bd:
        outs = bd.decode(datas)
    assert bd.errors == [None] * len(datas)
    assert (bd.rounds, bd.wire_rounds, bd.dense_rounds) == (5, 5, 0)
    assert tally["unpacks"] == 2 * bd.rounds
    assert kernels.LAUNCHES == want_launches(
        kernels.LAUNCHES, order, bd.rounds, bd.inter_rounds, tally["bm8"],
        shards=2, stores=tally["stores"], unpacks=tally["unpacks"])
    for p, frames in zip(QCIF_LANES, outs):
        meta = json.loads(p.with_suffix(".json").read_text())
        assert [hashlib.md5(f.planar()).hexdigest() for f in frames] \
            == meta["md5"], p.name


# the committed conformance streams (tools/conformance_streams.py)
CONF_4K_LANES = ["conf_c5", "batch_2160p_s1"] * 2
GOP_LANES = ["gop_720p_s0", "gop_720p_s1"]


def _conformance(names, order, batch, upload="wire"):
    """tools/gpu_conformance.py's decode of the committed streams `names`
    on the card, as the lanes of one BatchDecoder if `batch`: every frame
    equal to its MD5s, the kernels launched as its check_counts says."""
    from tools.gpu_conformance import check_counts, decode, report
    kernels.reset_launches()
    r = decode(names, order, "cuda", batch, upload)
    assert not r["bad"], report("+".join(names), r)
    assert check_counts(r, names, order, batch, upload,
                        dict(kernels.LAUNCHES)) == ""


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("cfg", range(1, 7))
def test_decoder_cuda_conformance(dev, cfg, order):
    """Config `cfg`'s committed stream (QCIF to 3840x2160) through
    Decoder on the card."""
    _conformance([f"conf_c{cfg}"], order, False)


@pytest.mark.parametrize("order", ORDERS)
def test_batch_decoder_cuda_2160p(dev, order):
    """BatchDecoder(4) over the 4K lanes (3 and 2 frames, twice)."""
    _conformance(CONF_4K_LANES, order, True)


@pytest.mark.parametrize("order,upload", [("phase", "wire"),
                                          ("raster", "wire"),
                                          ("phase", "dense")])
def test_batch_decoder_cuda_gop_lanes(dev, order, upload):
    """BatchDecoder(2) over the 720p lanes of two GOPs each, whose rounds
    put a lane's mid-stream IDR beside the other's P/B picture."""
    from tools.gpu_conformance import rounds_of
    assert rounds_of(GOP_LANES)[2]
    _conformance(GOP_LANES, order, True, upload)


def test_gpu_conformance_cuda(dev):
    """The gate's command line on config 1 with both orders, alone and as
    BatchDecoder(2) lanes on the card: exit 0, ALL BIT-EXACT."""
    import subprocess
    import sys
    r = subprocess.run([sys.executable, "tools/gpu_conformance.py", "1",
                        "--order", "both", "--batch", "2"],
                       cwd=SMOKE.parents[2], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ALL BIT-EXACT"
