"""K12, the wire unpack kernel (csrc/unpack_wire.cu), on the CPU.

`thread_program` is a numpy model of the kernel's two launches over the
segment table that the wrapper's `plan` builds: each block finds its
segment by the kernel's loop and its block_words words (from 0-3 words
before the segment where its lane's words are not 16-byte aligned),
stages the
span of its rows (which must fit kStageBytes), and each thread makes
kGroups groups of 4 words, each word's row from the segment's multiplier
and shift, read only from its block's staged rows (or the slice table),
and stores a group as one 16-byte aligned int4 or, at an unaligned head
or tail, word by word; the op codes, kThreads, kGroups, kMaxSegs and
kStageBytes are parsed from the .cu.  Launch 1 must write every word of
every output once; launch 2 writes the sparse rows over their MBs, a
group of one row a store.
The model must equal the port's plain ops/wire.py::unpack_wire_plain and
the JAX package's unpack_fn(mb_w, mb_h, spec, batched=True) key by key,
on wire rounds made from numpy seeds through pack_wire_raw, merge_specs
and emit_wire with target specs that force every scheme: intra
zero/sparse/dense; inter zero/base/base with sparse rows/dense; dense and
dense16 coefficient classes (bm8 ones are K8's); pcm zero/sparse/dense;
wtab zero/sparse; with padding rows, unsorted sparse rows, NX_FLAG refs
and the per-MB deblock override, at 1x1, 11x9 and 120x68 MBs, B = 1 and
3, lanes a row stride apart.  Every comparison is exact (atol 0).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu.ops import wire as jwire
from arrow_h264_tpu_torch.ops import wire
from arrow_h264_tpu_torch.ops.kernels import LAUNCHES
from arrow_h264_tpu_torch.ops.kernels import unpack_wire as k12
from arrow_h264_tpu_torch.ops.synthetic import WIRE_CASES, forced_wire_round

CU = (Path(wire.__file__).resolve().parents[1] / "csrc" /
      "unpack_wire.cu").read_text()
THREADS, GROUPS, MAX_SEGS = (
    int(re.search(rf"constexpr int {k} = (\d+);", CU)[1])
    for k in ("kThreads", "kGroups", "kMaxSegs"))
BLOCK_WORDS = THREADS * 4 * GROUPS
STAGE_BYTES = 6 * BLOCK_WORDS + 32
# the .cu's `enum Op`: name (kCamelCase) -> code
ENUM = {m[1]: int(m[2]) for m in re.finditer(
    r"\b(k[A-Z]\w*) = (\d+)", CU[CU.index("enum Op"):CU.index("};",
                                                       CU.index("enum Op"))])}
JAX_PATCH = ("patch", "zero", 0)     # the JAX spec's last entry, no bytes


def _code(name: str) -> int:
    """The .cu's code of the wrapper's op `name` (kRefIdxRows: refidx_rows)."""
    (code,) = [c for k, c in ENUM.items()
               if k[1:].lower() == name.replace("_", "")]
    return code


def test_constants_match_the_kernel():
    assert (BLOCK_WORDS, MAX_SEGS, STAGE_BYTES) == (
        k12.BLOCK_WORDS, k12.MAX_SEGS, k12.STAGE_BYTES)
    assert "constexpr int kBlockWords = kThreads * 4 * kGroups;" in CU
    assert "constexpr int kStageBytes = 6 * kBlockWords + 32;" in CU
    assert len(ENUM) == len(k12.OPS)
    assert [_code(name) for name in k12.OPS] == list(range(len(k12.OPS)))
    seg = CU[CU.index("struct Seg {"):CU.index("};", CU.index("struct Seg"))]
    assert re.findall(r"\w+", seg.replace("long long", ""))[2:] == \
        list(k12.FIELDS)


# ---- the model -------------------------------------------------------------

class Lane:
    """A lane's wire bytes, read as the kernel reads them (little-endian,
    vectorised over byte offsets).  With `staged` (per word: the first
    and end byte of its block's staged rows) and `tab` (the slice table's
    offset, where the op reads it), every read must lie in one of them,
    as the kernel's reads of shared memory do."""

    def __init__(self, row: np.ndarray, staged=None, tab=None):
        self.b = row
        self.staged = staged
        self.tab = tab

    def _at(self, off, size):
        if self.staged is not None:
            lo, hi = self.staged
            ok = (off >= lo) & (off + size <= hi)
            if self.tab is not None:
                ok |= (off >= self.tab) & (off + size <= self.tab + 96)
            assert ok.all(), "a read outside the block's staged bytes"
        return off

    def u8(self, off):
        return self.b[self._at(off, 1)].astype(np.int64)

    def i8(self, off):
        return self.b[self._at(off, 1)].view(np.int8).astype(np.int64)

    def i16(self, off):
        off = self._at(off, 2)
        v = self.b[off].astype(np.int64) | (self.b[off + 1].astype(np.int64)
                                             << 8)
        return np.where(v >= 1 << 15, v - (1 << 16), v)

    def i32(self, off):
        off = self._at(off, 4)
        v = sum(self.b[off + k].astype(np.int64) << (8 * k) for k in range(4))
        return np.where(v >= 1 << 31, v - (1 << 32), v)


def word(op: int, lane: Lane, row, tab: int, j):
    """csrc/unpack_wire.cu word(): word j of the row at byte offsets `row`
    (None: the op's absent value), the slice table at byte `tab`."""
    c = _code
    if row is None:
        return np.full(j.shape, -1 if op in (
            c("refidx_rows"), c("refid_rows"), c("refslot_rows")) else 0)
    u8, i8, i16 = lane.u8, lane.i8, lane.i16
    if op in (c("kind"), c("qp")):
        return u8(row + (op == c("qp")))
    sb = u8(row + 2)
    fl = u8(row + 3)
    simple = {c("slice_id"): lambda: sb & 15, c("tr8"): lambda: fl & 1,
              c("mb_avail"): lambda: (fl >> (1 + j)) & 1,
              c("i16_mode"): lambda: (fl >> 4) & 3,
              c("chroma_mode"): lambda: (fl >> 6) & 3,
              c("disable_idc"): lambda: np.where(
                  (sb >> 4) & 1 == 1, 1, i8(tab + (sb & 15) * 6)),
              c("alpha_off"): lambda: i8(tab + (sb & 15) * 6 + 1),
              c("beta_off"): lambda: i8(tab + (sb & 15) * 6 + 2),
              c("nz"): lambda: (u8(row + 4 + j // 8) >> (j % 8)) & 1}
    if op in simple:
        return simple[op]()
    if op == c("slogwd"):
        return i8(row + (j // 2) * 6 + 3 + j % 2)
    if op == c("i4_modes"):
        return u8(row + j)
    if op == c("i4_avail"):
        return (u8(row + 16 + j // 4) >> (j % 4)) & 1
    if op == c("i8_modes"):
        return u8(row + 32 + j)
    if op == c("i8_avail"):
        return (u8(row + 36 + j // 4) >> (j % 4)) & 1
    if op == c("mv_base"):
        return i16(row + 2 * (j % 4))
    if op == c("mv_rows"):
        return i16(row + 2 * j)
    ref = {c("refidx_base"): lambda: i8(row + j % 2),
           c("refidx_rows"): lambda: i8(row + j),
           c("refid_base"): lambda: i8(row + 2 + j % 2),
           c("refid_rows"): lambda: i8(row + 32 + j),
           c("refslot_base"): lambda: i8(row + 2 + j % 2),
           c("refslot_rows"): lambda: i8(row + 32 + j)}
    if op in ref:
        r = ref[op]()
        if op in (c("refslot_base"), c("refslot_rows")):
            r = np.where(r >= 0, r & 63, r)
        return r
    if op == c("u8"):
        return u8(row + j)
    if op == c("i16"):
        return i16(row + 2 * j)
    if op == c("i32"):
        return lane.i32(row + 4 * j)
    raise AssertionError(f"op {op}")


def thread_program(buf: np.ndarray, mb_w: int, mb_h: int, spec,
                   log: dict | None = None) -> dict:
    """K12's two launches over the plan's segments, on numpy buffers
    [B, total] uint8 -> {key: [B, ...] int32} of K12's outputs.  log (if
    given) counts the int4 and the word stores."""
    n = mb_w * mb_h
    B = buf.shape[0]
    p = k12.plan(spec, n, B)
    table, _ = wire._offsets(spec, n)
    tab = table["slice8"][0]
    F = {f: i for i, f in enumerate(k12.FIELDS)}
    out = np.zeros(p.words, np.int64)
    written = np.zeros(p.words, np.int64)
    log = {"int4": 0, "word": 0} if log is None else log
    reads_tab = {_code(k) for k in ("disable_idc", "alpha_off", "beta_off")}
    for launch, segs, blocks in ((0, p.segs[:p.n1], p.blocks1),
                                 (1, p.segs[p.n1:], p.blocks2)):
        assert len(segs) <= MAX_SEGS
        if not len(segs):
            assert blocks == 0
            continue
        # each block's segment, by the kernel's loop
        x = np.arange(blocks)
        s = np.zeros(blocks, np.int64)
        moving = np.ones(blocks, bool)
        for k in range(1, len(segs)):
            moving &= segs[k, F["block0"]] <= x
            s += moving
        for k, g in enumerate(segs):
            g = dict(zip(k12.FIELDS, (int(v) for v in g)))
            xs = x[s == k]
            wpm, words = g["wpm"], g["rows"] * g["wpm"]
            mul, shift = np.uint64(g["mul"]), np.uint64(g["shift"])

            def row_of(i):
                return (np.asarray(i).astype(np.uint64) * mul >> shift) \
                    .astype(np.int64)
            assert np.array_equal(row_of(np.arange(words)),
                                  np.arange(words) // wpm)
            for b in range(B):
                base = g["out"] + b * g["lane_words"]
                # the blocks' first positions, 16-byte aligned in the
                # output, and their words [lo, hi)
                bw = g["block_words"]
                assert bw % 4 == 0 and 0 < bw <= BLOCK_WORDS
                first = (xs - g["block0"]) * bw - (
                    0 if launch else base % 4)
                lo = np.maximum(first, 0)
                hi = np.minimum(first + bw, words)
                assert (lo < hi).any() or not words
                r_lo, r_hi = row_of(lo), row_of(np.maximum(hi - 1, 0))
                staged = None
                if g["src"] >= 0 and g["op"] != _code("wtab"):
                    span_lo = g["src"] + r_lo * g["row_bytes"]
                    span_hi = g["src"] + (r_hi + 1) * g["row_bytes"]
                    addr = buf.ctypes.data + b * buf.strides[0]
                    live = lo < hi
                    assert ((((addr + span_hi + 15) & ~15) -
                             ((addr + span_lo) & ~15))[live] <=
                            STAGE_BYTES).all()
                    staged = (span_lo, span_hi)
                # thread t's group q: words i0 .. i0 + 3 of its block
                at = 4 * np.arange(GROUPS * THREADS)
                i0 = first[:, None] + at
                i = i0[..., None] + np.arange(4)            # [X, G T, 4]
                valid = (i >= lo[:, None, None]) & (i < hi[:, None, None]) \
                    & (at < bw)[None, :, None]
                blk = np.broadcast_to(np.arange(len(xs))[:, None, None],
                                      i.shape)[valid]
                i, grp = i[valid], np.broadcast_to(i0[..., None],
                                                   valid.shape)[valid]
                if not launch:
                    assert np.array_equal(np.sort(i), np.arange(words))
                r, j = row_of(i), i - row_of(i) * wpm
                lane = Lane(buf[b], staged and (staged[0][blk],
                                                 staged[1][blk]),
                            tab if g["op"] in reads_tab else None)
                if g["op"] == _code("wtab"):
                    idx = lane.i32(g["idx"] + 4 * np.arange(g["nidx"]))
                    hit = idx[None, :] == r[:, None]
                    at = np.where(hit.any(1), hit.argmax(1), -1)
                    v = np.where(at >= 0, lane.i16(
                        g["src"] + np.maximum(at, 0) * g["row_bytes"] +
                        2 * j), (j & 1) == 0)
                else:
                    row = None if g["src"] < 0 else \
                        g["src"] + r * g["row_bytes"]
                    v = word(g["op"], lane, row, tab, j)
                full = valid.all(-1)
                dst = base + i
                if launch:
                    # a group is one row's words j0 .. j0 + 3
                    assert full[valid.any(-1)].all()
                    r0 = row_of(grp)
                    assert np.array_equal(r, r0)
                    m = Lane(buf[b]).i32(g["idx"] + 4 * r)   # in place
                    keep = (m >= 0) & (m < g["lane_words"] // wpm)
                    dst = (base + m * wpm + j)[keep]
                    v = v[keep]
                    assert (dst[::4] % 4 == 0).all()        # int4 stores
                    log["int4"] += len(dst) // 4
                else:
                    assert ((base + i0[full]) % 4 == 0).all()
                    log["int4"] += int(full.sum())
                    log["word"] += int(valid[~full].sum())
                out[dst] = v
                written[dst] += 1
    got = {}
    for name, shape, at in p.outputs:
        if at is None:
            continue
        size = B * int(np.prod(shape))
        assert written[at:at + size].min() >= 1, f"{name}: words unwritten"
        got[name] = out[at:at + size].astype(np.int32).reshape((B,) + shape)
    return got


# ---- wire rounds that force every scheme (ops/synthetic.py) ---------------

CASES = WIRE_CASES
# (case, mb_w, mb_h, B): every case at 1x1 and 11x9, B = 1 and 3, and at
# 120x68 B = 1; the mixed and dense rounds also at 120x68 B = 3
ROUNDS = [(c, *g, B) for c in CASES for g in ((1, 1), (11, 9), (120, 68))
          for B in (1, 3) if g != (120, 68) or B == 1 or c in ("mixed",
                                                                "dense")]
# the rounds also held to the JAX package's unpack
JAX_ROUNDS = [(c, *g, B) for c in CASES
              for g, B in (((1, 1), 3), ((11, 9), 1), ((11, 9), 3))] + [
    (c, 120, 68, 1) for c in ("sparse", "dense")]


def _lanes(case, mb_w, mb_h, B, seed):
    return forced_wire_round(case, mb_w, mb_h, B, seed)


def _plain(buf, mb_w, mb_h, spec):
    return wire.unpack_wire_plain(torch.from_numpy(np.ascontiguousarray(
        buf)), mb_w, mb_h, spec)


def _check_model(buf, mb_w, mb_h, spec, want: dict):
    got = thread_program(buf, mb_w, mb_h, spec)
    bm8 = k12.bm8_keys(spec)
    wtab_zero = dict((e[0], e[1]) for e in spec)["wtab"] == "zero"
    assert set(got) == set(want) - bm8 - ({"wtab"} if wtab_zero else set())
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.shape == w.shape, k
        assert np.array_equal(v, w), k


@pytest.mark.parametrize("case,mb_w,mb_h,B", ROUNDS)
def test_thread_program_matches_plain(case, mb_w, mb_h, B):
    """The model of K12's threads equals unpack_wire_plain on every key
    it writes; K8's bm8 classes and a zero wtab are not K12's."""
    buf, spec = _lanes(case, mb_w, mb_h, B, seed=7 * B + mb_w)
    want = _plain(buf, mb_w, mb_h, spec)
    assert all(v.dtype == torch.int32 for v in want.values())
    _check_model(buf, mb_w, mb_h, spec, {k: v.numpy()
                                         for k, v in want.items()})


def test_cases_force_every_scheme():
    """The rounds of CASES reach every scheme K12 reads (at 11x9)."""
    seen = {}
    for case in CASES:
        _, spec = _lanes(case, 11, 9, 3, seed=1)
        for f, sch, b in spec:
            seen.setdefault(f, set()).add((sch, bool(b)))
    assert {"zero", "sparse", "dense"} <= {s for s, _ in seen["intra"]}
    assert {("zero", False), ("base", False), ("base", True),
            ("dense", False)} <= seen["inter"]
    coeff = set().union(*(seen[f] for f in wire._COEFF_SHAPES))
    assert {("dense", False), ("dense16", False), ("bm8", True),
            ("zero", False)} <= coeff
    assert {("zero", False), ("sparse", True), ("dense", False)} <= \
        seen["pcm"]
    assert {("zero", False), ("sparse", True)} <= seen["wtab"]


@pytest.mark.parametrize("case,mb_w,mb_h,B", JAX_ROUNDS)
def test_thread_program_matches_jax(case, mb_w, mb_h, B):
    """The model equals the JAX package's unpack (vmapped, jit on the
    CPU) of the same bytes, its spec ending in an empty patch entry; the
    port's refid is the JAX refid and its refslot the JAX refslot."""
    buf, spec = _lanes(case, mb_w, mb_h, B, seed=5 * B + mb_h)
    want = jwire.unpack_fn(mb_w, mb_h, spec + (JAX_PATCH,), batched=True)(
        jnp.asarray(np.ascontiguousarray(buf)))
    want = {k: np.asarray(v) for k, v in want.items() if k != "patch"}
    assert set(want) == set(_plain(buf, mb_w, mb_h, spec))
    _check_model(buf, mb_w, mb_h, spec, want)


def test_nx_refs_and_override_reach_the_outputs():
    """The rounds carry what the unpack must map: refids with NX_FLAG
    whose refslot drops it, and MBs whose deblock override sets
    disable_idc to 1 over their slice row's value."""
    buf, spec = _lanes("sparse", 11, 9, 1, seed=3)
    got = thread_program(buf, 11, 9, spec)
    nx = got["refid"] >= wire.NX_FLAG
    assert nx.any() and np.array_equal(got["refslot"][nx],
                                       got["refid"][nx] - wire.NX_FLAG)
    meta = buf[0, :6 * 99].reshape(99, 6)
    dbo = (meta[:, 2] >> 4) & 1 == 1
    assert dbo.any() and (got["disable_idc"][0][dbo] == 1).all()
    tab = buf[0, wire._offsets(spec, 99)[0]["slice8"][0]:][:96] \
        .view(np.int8).reshape(16, 6)
    assert (tab[meta[~dbo, 2] & 15, 0] != 1).any()


def test_padding_and_unsorted_rows():
    """Sparse sections carry padding rows (index n, 16 for wtab) and rows
    out of order, and the model drops and places them as the plain
    version does (test_thread_program_matches_plain)."""
    buf, spec = _lanes("sparse", 11, 9, 1, seed=3)
    table, _ = wire._offsets(spec, 99)
    for idx, pad in (("in_idx", 99), ("nu_idx", 99), ("pcm_idx", 99),
                     ("wt_idx", 16)):
        off, _, (b,) = table[idx]
        v = buf[0, off:off + 4 * b].view(np.int32)
        live = v[v != pad]
        assert (v == pad).any() and len(set(live)) == len(live), idx
        if len(live) > 2:
            assert (np.diff(live) < 0).any(), f"{idx} sorted"


@pytest.mark.parametrize("case", ["sparse", "dense", "mixed"])
def test_wrapper_on_strided_cpu_views(case):
    """On the CPU the wrapper is the plain version, on lanes a row stride
    apart too, and launches nothing."""
    buf, spec = _lanes(case, 11, 9, 3, seed=11)
    view = torch.from_numpy(buf.base if buf.base is not None else buf)[
        :, :buf.shape[1]]
    assert view.stride(0) > view.shape[1]
    before = dict(LAUNCHES)
    got = k12.unpack_wire(view, 11, 9, spec)
    assert LAUNCHES == before
    want = _plain(buf, 11, 9, spec)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(wire.unpack_wire(view, 11, 9, spec)["mv"], want["mv"])
    alone = k12.unpack_wire(view, 11, 9, spec, bm8=False)
    assert set(alone) == set(want) - k12.bm8_keys(spec)
    assert k12.bm8_keys(spec) or case != "sparse"


def test_plan_layout():
    """Every output of a plan lies in its own 16-byte aligned region of
    the allocation; launch 2 runs only where a section ships sparse rows;
    a launch's segments fit the kernel's table."""
    for case in CASES:
        buf, spec = _lanes(case, 11, 9, 3, seed=2)
        p = k12.plan(spec, 99, 3)
        regions = sorted((at, at + 3 * int(np.prod(shape)))
                         for _, shape, at in p.outputs if at is not None)
        assert all(a % 4 == 0 for a, _ in regions)
        assert all(e <= a for (_, e), (a, _) in zip(regions, regions[1:]))
        assert regions[-1][1] <= p.words
        assert sum(p.split) == p.words
        for (_, shape, at), piece in zip(p.outputs, p.pieces):
            assert (piece is None) == (at is None)
            if at is not None:
                assert sum(p.split[:piece]) == at
                assert p.split[piece] == 3 * int(np.prod(shape))
        assert p.n1 <= MAX_SEGS and len(p.segs) - p.n1 <= MAX_SEGS
        sparse = any(s in ("sparse",) or (f == "inter" and b)
                     for f, s, b in spec if f in ("intra", "inter", "pcm"))
        assert (p.blocks2 > 0) == sparse == (k12.device_launches(spec, 99)
                                             == 2), case


@pytest.mark.parametrize("wpm", [1, 2, 3, 4, 16, 32, 40, 64, 384, 13068])
def test_row_divisor(wpm):
    """The plan's multiplier and shift give i // wpm for every i < 2^31:
    checked at each multiple of wpm near the ends and in between, one
    word either side, and at random words."""
    mul, shift = k12.row_divisor(wpm)
    rng = np.random.default_rng(wpm)
    q = np.concatenate([np.arange(4096), (2**31 - 1) // wpm - np.arange(
        4096), rng.integers(0, (2**31 - 1) // wpm, 4096)])
    i = np.concatenate([q * wpm - 1, q * wpm, q * wpm + 1,
                        rng.integers(0, 2**31, 4096)])
    i = i[(i >= 0) & (i < 2**31)].astype(np.uint64)
    got = (i * np.uint64(mul)) >> np.uint64(shift)
    assert np.array_equal(got, i // np.uint64(wpm))
    assert mul < 2**33                        # i * mul < 2^64


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mb_w,mb_h", [(11, 9), (7, 5)])
@pytest.mark.parametrize("case", ["sparse", "dense"])
def test_heads_and_tails(case, mb_w, mb_h, B):
    """n = 99 and 35 MBs: the one-word keys' segments end off a 16-byte
    boundary, and at B = 3 the lanes start off it too; those words are
    stored one by one, every other group as one int4."""
    buf, spec = _lanes(case, mb_w, mb_h, B, seed=13)
    log = {"int4": 0, "word": 0}
    got = thread_program(buf, mb_w, mb_h, spec, log)
    want = _plain(buf, mb_w, mb_h, spec)
    for k, v in got.items():
        assert np.array_equal(v, want[k].numpy()), k
    assert 0 < log["word"] < 4 * log["int4"]


def test_block_words_of_wide_rows():
    """At 1920x1088 the 40-byte intra rows of i8_modes (4 words) would
    overflow a block's staging buffer at BLOCK_WORDS words: its blocks
    make fewer, so that the rows they touch fit; the rest make
    BLOCK_WORDS."""
    _, spec = _lanes("dense", 120, 68, 1, seed=1)
    p = k12.plan(spec, 120 * 68, 1)
    F = {f: i for i, f in enumerate(k12.FIELDS)}
    short = {k12.OPS[g[F["op"]]] for g in p.segs
             if g[F["block_words"]] < BLOCK_WORDS}
    assert short == {"i8_modes"}
    for g in p.segs:
        if g[F["src"]] >= 0 and k12.OPS[g[F["op"]]] != "wtab":
            bw, wpm = g[F["block_words"]], g[F["wpm"]]
            rows = (bw + wpm - 2) // wpm + 1
            assert rows * g[F["row_bytes"]] + 30 <= STAGE_BYTES
