"""K8, the wire's bm8 expansion kernel (csrc/unpack_bm8.cu), on the CPU.

`chunked_scan` is a numpy model of the kernel's two launches over a
table of classes, as the wrapper lays them out (their sections read at
byte addresses of one memory, lanes a stride apart): the scan blocks
(kChunk rows of one class and lane: each row's set bits, its first
position within the chunk from the exclusive scan of its thread's rows,
the chunk's total, the row map entries) and the expand blocks (a tile of
dense rows of one class and lane: the row map entries that name a row
whose index is that dense row, over a row map full of stale entries; the
totals of the chunks before each live row's, scanned 32 chunks a warp;
each group of 4 words' values read as the one or two aligned words that
hold them, or value by value past the lane's last; every word written
once).  Its constants are parsed from the .cu, or smaller ones, so that
chunks and tiles cut every lane and class.  It must equal the port's
plain ops/wire.py::_scatter_bm8, the JAX package's _scatter_bm8 lane by
lane and the host's ops/wire.py::_expand_bm8_np, one class at a time and
every bm8 class of wire rounds (from pack_wire_raw of the ABIs of
committed streams, every class forced to bm8, or bm8 beside zero and
dense classes) laid out by ops/kernels/unpack_wire.py::bm8_table, which
must also equal the port's unpack_wire on the CPU.  Every comparison is
exact (atol 0).
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu.ops import wire as jwire
from arrow_h264_tpu_torch.ops import wire
from arrow_h264_tpu_torch.ops.kernels import LAUNCHES
from arrow_h264_tpu_torch.ops.kernels import unpack_bm8 as k8
from arrow_h264_tpu_torch.ops.kernels import unpack_wire as k12
from arrow_h264_tpu_torch.ops.kernels.unpack_bm8 import unpack_bm8
from arrow_h264_tpu_torch.ops.synthetic import wire_round
from tests.torch_ref import decode_port
from tools import stage_probe

CU_DIR = Path(wire.__file__).resolve().parents[1] / "csrc"
CU = (CU_DIR / "unpack_bm8.cu").read_text()
(THREADS, ROWS, SHIFT, TILE_ROWS, MAX_CHUNKS, MAX_CLASSES) = (
    int(re.search(rf"constexpr int {k} = (\d+);", CU)[1])
    for k in ("kThreads", "kRowsPerThread", "kChunkShift", "kTileRows",
              "kMaxChunks", "kMaxClasses"))
DATA = Path(__file__).resolve().parent / "data"
# (threads a scan block, rows a thread, words and rows an expand block):
# the kernel's, and small ones (whole warps; chunks of a power of two
# rows)
CHUNKINGS = [(THREADS, ROWS, k8.TILE_WORDS, TILE_ROWS), (32, 1, 128, 8),
             (64, 2, 64, 2)]
F = {f: i for i, f in enumerate(k8.FIELDS)}


def table(classes, B: int, chunking=CHUNKINGS[0]) -> k8.Table:
    """ops/kernels/unpack_bm8.py::class_table with `chunking`'s chunks and
    tiles."""
    threads, rows, tile_words, tile_rows = chunking
    chunk = threads * rows
    out, blocks1, blocks2, scratch = [], 0, 0, 0
    for idx, bm, vals, s_idx, s_bm, s_vals, br, bv, grid, w, at in classes:
        chunks = -(-br // chunk)
        per_tile = min(tile_words // w, tile_rows)
        regions = []
        for words in (B * grid, B * br, B * chunks):
            regions.append(scratch)
            scratch += -(-words // 4) * 4
        out.append([idx, bm, vals, s_idx, s_bm, s_vals, br, (w + 15) // 16,
                    bv, grid, w, at, *regions, chunks, -(-grid // per_tile),
                    per_tile, blocks1, blocks2])
        blocks1 += chunks
        blocks2 += -(-grid // per_tile)
    return k8.Table(np.array(out, np.int64).reshape(-1, len(F)), blocks1,
                    blocks2, scratch)


UNWRITTEN = -(1 << 40)      # a word no launch wrote
LOG = ("zeros", "live", "one_word", "two_words", "clamped")


def chunked_scan(mem: np.ndarray, t: k8.Table, B: int, words: int,
                 chunking=CHUNKINGS[0], seed: int = 0,
                 log: dict | None = None) -> np.ndarray:
    """The kernel's two launches over table t: mem is the byte memory
    (uint8) the sections' addresses index; -> the output [words] int64,
    UNWRITTEN where no launch wrote.  The scratch starts as random words
    (a row map entry may name any row).  log (if given) counts the expand
    blocks by what they did (zeros: no live row; live) and the groups of
    4 words whose values it read as one aligned word, as two, or clamped
    past the lane's last value, value by value."""
    threads, rows = chunking[:2]
    chunk = threads * rows
    shift = chunk.bit_length() - 1
    assert chunk == 1 << shift and chunk * 64 <= 1 << 17
    rng = np.random.default_rng(seed)
    scratch = rng.integers(-2**31, 2**31, max(t.scratch, 1), np.int64)
    scratch[rng.random(len(scratch)) < 0.5] %= 64     # in-range rows too
    out = np.full(words, UNWRITTEN, np.int64)
    log = dict.fromkeys(LOG, 0) if log is None else log

    def lane(c, b):
        """(idx [br], each row's first w bits [br, w] bool, vals [bv]) of
        lane b of class row c, read at their addresses."""
        br, bmw, bv, w = (int(c[F[k]]) for k in ("br", "bmw", "bv", "w"))
        a = c[F["idx"]] + b * c[F["s_idx"]]
        idx = mem[a:a + 4 * br].view(np.int32).astype(np.int64)
        a = c[F["bm"]] + b * c[F["s_bm"]]
        bm = mem[a:a + 2 * bmw * br].view(np.uint16).reshape(br, bmw)
        bits = ((bm[:, :, None] >> np.arange(16)) & 1).reshape(br, -1)
        a = c[F["vals"]] + b * c[F["s_vals"]]
        return idx, bits[:, :w].astype(bool), mem[a:a + bv].view(np.int8)

    # launch 1: a block a (class, lane, chunk) of `chunk` rows; warp wp
    # its rows wp * 32 * rows.., lane l row 32 * r + l of them in round r
    # (a scan across the lanes, carried over the rounds), then the warps'
    # totals before it
    for c in t.rows:
        br, grid, chunks = (int(c[F[k]]) for k in ("br", "grid", "chunks"))
        for b in range(B):
            idx, bits, _ = lane(c, b)
            cnt = np.zeros(chunks * chunk, np.int64)
            cnt[:br] = bits.sum(1)
            per = cnt.reshape(chunks, threads // 32, rows, 32)
            inc = np.cumsum(per, 3)                      # a round's scan
            rsum = inc[..., -1]
            carry = np.cumsum(rsum, 2) - rsum            # rounds before
            wsum = rsum.sum(2)
            wbefore = np.cumsum(wsum, 1) - wsum          # warps before
            first = (wbefore[:, :, None, None] + carry[..., None] + inc
                     - per).reshape(-1)[:br]
            assert (first < 1 << 17).all()
            f0 = c[F["first"]] + b * br
            scratch[f0:f0 + br] = first
            s0 = c[F["sums"]] + b * chunks
            scratch[s0:s0 + chunks] = wsum.sum(1)
            ok = (idx >= 0) & (idx < grid)
            scratch[c[F["rowmap"]] + b * grid + idx[ok]] = \
                np.arange(br)[ok]
    # launch 2: a block a (class, lane, tile) of R dense rows
    for c in t.rows:
        br, bv, grid, w, R, chunks = (int(c[F[k]]) for k in (
            "br", "bv", "grid", "w", "rows", "chunks"))
        for b in range(B):
            idx, bits, vals = lane(c, b)
            j = scratch[c[F["rowmap"]] + b * grid:][:grid]
            ok = (j >= 0) & (j < br)
            ok[ok] = idx[j[ok]] == np.arange(grid)[ok]   # the row's own
            jj = np.where(ok, j, 0)
            set_ = np.where(ok[:, None], bits[jj], False)       # [grid, w]
            live = set_.any(1)
            sums = np.zeros(-(-chunks // 32) * 32, np.int64)
            sums[:chunks] = scratch[c[F["sums"]] + b * chunks:][:chunks]
            groups = sums.reshape(-1, 32)          # a warp's 32 chunks
            cex = (np.cumsum(groups, 1) - groups).reshape(-1)
            before = np.cumsum(groups.sum(1)) - groups.sum(1)
            at = scratch[c[F["first"]] + b * br + jj] | \
                (jj >> shift) << 17
            ch = at >> 17
            pos = np.where(live, cex[np.where(live, ch, 0)] + before[
                np.where(live, ch, 0) >> 5] + (at & 0x1ffff), 0)
            pk = pos[:, None] + np.cumsum(set_, 1) - set_         # [grid, w]
            v = np.where(set_, vals[np.minimum(pk, bv - 1)].astype(
                np.int64), 0)
            # each group of 4 words: its first value's position and count
            gp = pk.reshape(grid, -1, 4)[..., 0]
            gn = set_.reshape(grid, -1, 4).sum(2)
            addr = c[F["vals"]] + b * c[F["s_vals"]] + gp
            for tile in range(int(c[F["tiles"]])):
                g = slice(tile * R, min(tile * R + R, grid))
                dst = c[F["out"]] + (b * grid + g.start) * w
                span = out[dst:dst + (g.stop - g.start) * w]
                assert (span == UNWRITTEN).all()          # written once
                if not live[g].any():
                    log["zeros"] += 1
                    span[:] = 0
                    continue
                log["live"] += 1
                n_, p_, a_ = gn[g], gp[g], addr[g]
                ok_ = (n_ > 0) & (p_ + n_ <= bv)
                log["clamped"] += int(((n_ > 0) & ~ok_).sum())
                two = ok_ & ((a_ & 3) + n_ > 4)
                log["two_words"] += int(two.sum())
                log["one_word"] += int((ok_ & ~two).sum())
                span[:] = v[g].reshape(-1)
    return out


def _mem(idx, bm, vals):
    """(memory, class entry without its output offset) of one class's
    arrays, each section a lane stride apart in its own part of the
    memory (lanes padded so that they lie 4 bytes off 16)."""
    parts, entry, at = [], [], 0
    for a in (idx, bm.view(np.uint8).reshape(len(bm), -1),
              vals.view(np.uint8)):
        lanes = a.reshape(len(a), -1).view(np.uint8)
        stride = -(-lanes.shape[1] // 4) * 4 + 20
        block = np.zeros((len(a), stride), np.uint8)
        block[:, :lanes.shape[1]] = lanes
        parts.append(block.reshape(-1))
        entry += [at, stride]
        at += block.size
    mem = np.concatenate(parts)
    return mem, entry[0::2] + entry[1::2]


def _case(name: str, w: int, B: int, seed: int):
    """(idx, bm, vals, grid) numpy: B lanes of one class, as the wire
    ships them (rows of nonzero blocks, then padding rows at idx ==
    grid), with what `name` asks for."""
    rng = np.random.default_rng(seed)
    bmw = (w + 15) // 16
    grid = {"small": 40, "cut": 3000, "sparse": 30000}.get(name, 700)
    br = {"small": 32, "cut": 2500, "sparse": 64}.get(name, 600)
    counts = rng.integers(br // 3, br, B)          # lanes' real rows differ
    counts[0] = br                                 # one lane has no padding
    idx = np.full((B, br), grid, np.int32)
    bm = rng.integers(0, 1 << 16, (B, br, bmw)).astype(np.uint16)
    for b, k in enumerate(counts):
        idx[b, :k] = np.sort(rng.choice(grid, k, replace=False))
        bm[b, k:] = 0                              # padding rows are empty
    if name == "full_and_empty":
        bm[:, ::3] = 0xFFFF
        bm[:, 1::3] = 0
    if name == "dirty_padding":                    # padding bits still count
        bm[:, -5:] = rng.integers(1, 1 << 16, (B, 5, bmw))
    if name == "unsorted":
        for b in range(B):
            perm = rng.permutation(br)
            idx[b], bm[b] = idx[b, perm], bm[b, perm]
    need = int(max(((bm[b, :, :, None] >> np.arange(16)) & 1)
                   .reshape(br, -1)[:, :w].sum() for b in range(B)))
    bv = need if name == "clamped" else need + int(rng.integers(0, 40))
    if name == "clamped":                          # positions past the end
        bv = max(1, need // 2)
    vals = rng.integers(-128, 128, (B, bv)).astype(np.int8)
    return idx, bm, vals, grid


CASES = ["random", "small", "cut", "sparse", "full_and_empty",
         "dirty_padding", "unsorted", "clamped"]


@pytest.mark.parametrize("chunking", CHUNKINGS, ids=lambda c: "x".join(
    map(str, c)))
@pytest.mark.parametrize("w", [8, 16, 64])
@pytest.mark.parametrize("name", CASES)
def test_chunked_scan(name, w, chunking):
    B = 3
    idx, bm, vals, grid = _case(name, w, B, seed=100 * CASES.index(name) + w)
    br, bv = idx.shape[1], vals.shape[1]
    mem, secs = _mem(idx, bm, vals)
    words = B * grid * w
    t = table([(*secs, br, bv, grid, w, 0)], B, chunking)
    if chunking == CHUNKINGS[0]:                   # the wrapper's own table
        want_t = k8.class_table([(*secs, br, bv, grid, w, 0)], B)
        assert np.array_equal(t.rows, want_t.rows) and t[1:] == want_t[1:]
    log = dict.fromkeys(LOG, 0)
    got = chunked_scan(mem, t, B, words, chunking, seed=w, log=log)
    got = got.reshape(B, grid, w)
    tt = (torch.from_numpy(idx), torch.from_numpy(bm.view(np.int16)),
          torch.from_numpy(vals))
    plain = wire._scatter_bm8(*tt, grid, w)
    assert plain.dtype == torch.int32 and plain.shape == (B, grid, w)
    assert np.array_equal(got, plain.numpy())
    before = dict(LAUNCHES)
    wrapped = unpack_bm8(*tt, grid, w)
    assert LAUNCHES == before                  # CPU tensors: plain version
    assert torch.equal(wrapped, plain)
    for b in range(B):
        want = jwire._scatter_bm8(jnp.asarray(idx[b]), jnp.asarray(bm[b]),
                                  jnp.asarray(vals[b]), grid, w)
        assert np.array_equal(got[b], np.asarray(want)), f"lane {b} vs JAX"
        if name != "clamped":                  # the host's needs no clamp
            assert np.array_equal(got[b], wire._expand_bm8_np(
                idx[b], bm[b], vals[b], grid, w)), f"lane {b} vs host"
    threads, rows, tile_words, _ = chunking
    if name == "cut":
        assert br > threads * rows             # the chunks cut every lane
    if name in ("random", "cut"):
        assert log["one_word"] and log["two_words"]
    if name == "clamped":
        assert log["clamped"] > 0
    if name == "sparse":
        assert log["zeros"] > 0                # tiles no row maps to


def test_unpack_wire_sections_on_cpu():
    """unpack_wire's bm8 sections are strided views of the wire buffer:
    the wrapper on them equals the plain version on copies, and so does
    the model on a table of the buffer's addresses."""
    B, n, w, br, bv = 3, 20, 16, 32, 64
    rng = np.random.default_rng(5)
    idx = np.stack([np.sort(rng.choice(n * 16, br, replace=False))
                    for _ in range(B)]).astype(np.int32)
    bm = rng.integers(0, 1 << 16, (B, br, 1)).astype(np.uint16)
    vals = rng.integers(-128, 128, (B, bv)).astype(np.int8)
    total = 4 * br + 2 * br + bv + 24
    buf = torch.zeros((B, total), dtype=torch.uint8)
    buf[:, :4 * br] = torch.from_numpy(idx.view(np.uint8).reshape(B, -1))
    buf[:, 4 * br:6 * br] = torch.from_numpy(bm.view(np.uint8)
                                             .reshape(B, -1))
    buf[:, 6 * br:6 * br + bv] = torch.from_numpy(vals.view(np.uint8))
    views = (buf[:, :4 * br].view(torch.int32),
             buf[:, 4 * br:6 * br].view(torch.int16).reshape(B, br, 1),
             buf[:, 6 * br:6 * br + bv].view(torch.int8))
    assert not views[0].is_contiguous()
    want = wire._scatter_bm8(*(v.contiguous() for v in views), n * 16, w)
    assert torch.equal(unpack_bm8(*views, n * 16, w), want)
    for chunking in CHUNKINGS:
        t = table([(0, 4 * br, 6 * br, total, total, total, br, bv, n * 16,
                    w, 0)], B, chunking)
        got = chunked_scan(buf.numpy().reshape(-1), t, B, B * n * 16 * w,
                           chunking)
        assert np.array_equal(got.reshape(B, n * 16, w), want.numpy())


@functools.lru_cache(maxsize=None)
def _stream_abis(name: str):
    """(mb_w, mb_h, ABIs) of the pictures of committed stream `name`."""
    capture = []
    decode_port(str(DATA / f"{name}.264"), capture=capture)
    pipe = capture[0][1]
    return pipe.mb_w, pipe.mb_h, [a for a, *_ in capture]


# lanes ((stream, picture) each) and the schemes forced on their classes
# (raised, never lowered): every class bm8 (picture 3 of the 512x80 High
# stream ships four with rows, luma DC has none); bm8 beside int32 dense
# and dense16 classes; bm8 beside zero and dense16 classes (QCIF High)
ROUND_CASES = {
    "all_bm8": ((("feat_w512_high", 3),) * 2, {"ldc": ("bm8", (32, 32))}),
    "mixed": ((("feat_w512_high", 1), ("feat_w512_high", 2),
               ("feat_w512", 1)), {"l8": ("dense", 0)}),
    "zero_dense16": ((("batch_qcif_s1", 1), ("batch_qcif_s1", 2),
                      ("batch_qcif_s2", 1)), {}),
    "one_lane": ((("batch_qcif_s2", 2),), {"ca": ("dense16", 0)}),
}


@pytest.mark.parametrize("chunking", CHUNKINGS[:2],
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("case", ROUND_CASES)
def test_wire_round_classes(case, chunking):
    """Every bm8 class of a wire round of real pictures in one model run
    over the round's table (ops/kernels/unpack_wire.py::bm8_table: the
    sections at their offsets in the lanes, a row stride apart, the
    outputs in their regions of unpack_wire's allocation) equals the
    port's unpack_wire on the CPU and the JAX package's _scatter_bm8
    lane by lane; the zero and dense classes are not K8's."""
    lanes, force = ROUND_CASES[case]
    mb_w, mb_h, _ = _stream_abis(lanes[0][0])
    buf, spec = wire_round([_stream_abis(name)[2][i] for name, i in lanes],
                           mb_w, mb_h, force, seed=len(lanes))
    B, n = len(lanes), mb_w * mb_h
    sd = {f: (sch, b) for f, sch, b in spec}
    shipped = {f: sch for f, (sch, _) in sd.items()
               if f in wire._COEFF_SHAPES}
    want_schemes = {"all_bm8": {"bm8"}, "mixed": {"bm8", "dense", "dense16"},
                    "zero_dense16": {"bm8", "zero", "dense16"}}
    assert set(shipped.values()) == want_schemes.get(
        case, set(shipped.values()))
    p = k12.plan(spec, n, B)
    t = k12.bm8_table(spec, n, B, buf.strides[0])
    assert len(t.rows) == len(p.bm8) == sum(s == "bm8"
                                            for s in shipped.values())
    if chunking != CHUNKINGS[0]:
        t = table([(i, bm, v, buf.strides[0], buf.strides[0],
                    buf.strides[0], *rest)
                   for _, _, (i, bm, v, *rest) in p.bm8], B, chunking)
    mem = buf.base.reshape(-1) if buf.base is not None else buf.reshape(-1)
    got = chunked_scan(mem, t, B, p.words, chunking, seed=B)
    want = k12.unpack_wire(torch.from_numpy(np.ascontiguousarray(buf)),
                           mb_w, mb_h, spec)
    assert set(want) >= k12.bm8_keys(spec)
    for (name, piece, (i, bm, v, br, bv, grid, w, at)), c in zip(p.bm8,
                                                                t.rows):
        assert at == sum(p.split[:piece]) and at % 4 == 0
        mine = got[at:at + B * grid * w].reshape(want[name].shape)
        assert np.array_equal(mine, want[name].numpy()), name
        f = next(f for f, key, *_ in wire._COEFF_FIELDS if key == name)
        table_, _ = wire._offsets(spec, n)
        for b in range(B):
            lane = np.ascontiguousarray(buf[b])
            sec = {sfx: np.frombuffer(lane[table_[f + sfx][0]:][
                :int(np.prod(table_[f + sfx][2])) *
                np.dtype(table_[f + sfx][1]).itemsize],
                table_[f + sfx][1]).reshape(table_[f + sfx][2])
                for sfx in ("_idx", "_bm", "_val")}
            j = jwire._scatter_bm8(jnp.asarray(sec["_idx"]),
                                   jnp.asarray(sec["_bm"].view(np.int16)),
                                   jnp.asarray(sec["_val"].view(np.int8)),
                                   grid, w)
            assert np.array_equal(mine[b].reshape(grid, w), np.asarray(j)), \
                (name, b)
    # the words of K12's keys are not K8's: only its regions were written
    k8_words = sum(B * grid * w for *_, (_, _, _, _, _, grid, w, _)
                   in p.bm8)
    assert (got != UNWRITTEN).sum() == k8_words


def test_class_table_refuses():
    """class_table raises on what the kernel cannot take: more classes
    than its table holds, widths that are no multiple of 4 or past 64, no
    values, an output off 16 bytes, and more chunks than a lane's scan
    holds."""
    ok = (0, 0, 0, 4, 4, 4, 10, 5, 20, 16, 0)
    assert k8.class_table([ok], 2).blocks2 == 1
    for bad in ([ok] * (MAX_CLASSES + 1),
                [ok[:9] + (6,) + ok[10:]], [ok[:9] + (68,) + ok[10:]],
                [ok[:7] + (0,) + ok[8:]], [ok[:10] + (2,)],
                [ok[:6] + (k8.CHUNK * MAX_CHUNKS + 1,) + ok[7:]]):
        with pytest.raises(ValueError):
            k8.class_table(bad, 2)


def test_constants_agree():
    """The wrapper's constants are the kernel's."""
    assert k8.CHUNK == THREADS * ROWS == 1 << SHIFT
    assert (k8.TILE_ROWS, k8.MAX_CHUNKS, k8.MAX_CLASSES) == \
        (TILE_ROWS, MAX_CHUNKS, MAX_CLASSES)
    assert len(k8.FIELDS) == len(re.search(
        r"struct Bm8Class \{\n  long long ([^;]*);", CU)[1].split(","))
    assert k8.DEVICE_LAUNCHES == CU.count("<<<")


@pytest.mark.parametrize("variant", [v for v in stage_probe.VARIANTS
                                     if not v.startswith("old_")])
def test_probe_edits_apply(variant):
    """Every edit of tools/stage_probe.py's variants of the current K8 and
    K10 sources occurs in its source once (the old_* variants edit the
    sources before this design)."""
    for f, old, _ in stage_probe.VARIANTS[variant]:
        assert (CU_DIR / f).read_text().count(old) == 1, (variant, f)
