"""K10, the inter combine kernel (csrc/inter_combine.cu), on the CPU.

`thread_program` is a model of the kernel in Python: one thread a 4x4
luma cell (and the 2x2 chroma cells under it), in the kernel's order
(kThreads parsed from the .cu), with its flat index arithmetic, the MB's
fields read by the first of its four threads and shuffled to the others,
its weight lookup (three 16-byte loads of the per-slice table's entry at
slice_id and the clamped refidx, with a lane stride of 0 for a table
shared by every lane, or of the dense wp; the logwd pair at slice_id or
the MB) and its combine, every access of the width and alignment the
kernel's (a row of a cell one load of each list, one residual load, one
store).  It must
equal the port's plain ops/inter.py::inter_init_plain, which must equal
the JAX package's `_mc_combine` followed by `_post_mc`'s residual add and
clip (arrow_h264_tpu/models/pipeline.py, with its own residual planes of
the same ABI), on `random_weighted_abi`: explicit and implicit weights,
logwd 0 and > 0, list-1-only cells, refidx -1 and past 31, and dense
wp.  Every comparison is exact (atol 0).
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu.models import pipeline as jp
from arrow_h264_tpu.ops.pallas.mc_kernel import _mc_combine
from arrow_h264_tpu.ops.synthetic import synthetic_abi_p
from arrow_h264_tpu.ops.transforms import make_ws_consts
from arrow_h264_tpu_torch import convert
from arrow_h264_tpu_torch.ops import inter as ti
from arrow_h264_tpu_torch.ops import transforms as tt
from arrow_h264_tpu_torch.ops.kernels import LAUNCHES
from arrow_h264_tpu_torch.ops.kernels.inter_combine import inter_combine
from arrow_h264_tpu_torch.ops.synthetic import random_weighted_abi
from tests.torch_ref import FLAT4, FLAT8, assert_same

GRIDS = [(4, 3), (5, 2), (1, 1)]
CU = (Path(ti.__file__).resolve().parents[1] / "csrc" /
      "inter_combine.cu").read_text()
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", CU)[1])
RES_KEYS = ("luma4", "luma_dc", "chroma_dc", "chroma_ac")


def _clip(v):
    return min(max(v, 0), 255)


def _combine(p0, p1, w, lw, both, only1):
    w0, o0, w1, o1 = w
    if both:
        return _clip(((p0 * w0 + p1 * w1 + (1 << lw)) >> (lw + 1))
                     + ((o0 + o1 + 1) >> 1))
    p, ww, o = (p1, w1, o1) if only1 else (p0, w0, o0)
    return _clip(((p * ww + (1 << (lw - 1))) >> lw) + o if lw >= 1
                 else p * ww + o)


class Memory:
    """A tensor's bytes as the kernel addresses them: every access is of
    1, 2, 4, 8 or 16 bytes at a byte offset that is a multiple of its
    size (the wrapper checks the tensors' own alignment), counted in
    `log` by kind and size; a store writes each word once."""

    def __init__(self, arr, log: dict, out: bool = False):
        self.words = np.full(arr.size, -1, np.int64) if out else None
        self.bytes = None if out else np.ascontiguousarray(arr).view(
            np.uint8).reshape(-1)
        self.log = log

    def load(self, off: int, nbytes: int, dtype):
        assert off % nbytes == 0, (off, nbytes)
        self.log[f"load{nbytes}"] = self.log.get(f"load{nbytes}", 0) + 1
        return self.bytes[off:off + nbytes].view(dtype).astype(np.int64)

    def store(self, word: int, values):
        nbytes = 4 * len(values)
        assert (4 * word) % nbytes == 0, (word, nbytes)
        self.log[f"store{nbytes}"] = self.log.get(f"store{nbytes}", 0) + 1
        assert (self.words[word:word + len(values)] == -1).all()
        self.words[word:word + len(values)] = values


def thread_program(abi: dict, pred_y, pred_c, res, mb_w: int, mb_h: int,
                   shared_wtab: bool = False, log: dict | None = None):
    """inter_combine_kernel, thread by thread: numpy inputs -> (init_y,
    init_cb, init_cr) int64 numpy.  A thread a 4x4 cell (a block of
    kThreads, the threads past the end standing in for cell 0 until the
    warp's shuffles are done): the first of an MB row's four threads
    reads kind, slice_id and the logwd pair (slogwd at slice_id, or the
    dense logwd) and the others take them from it, while each reads its
    cell's refslot and refidx pairs (8-byte loads); an inter cell's
    weights are three 16-byte loads; each
    luma row a 4-byte load of each list it reads, a 16-byte residual load
    and a 16-byte store, each chroma row 2-byte, 8-byte and 8-byte ones.
    shared_wtab: every lane reads lane 0's weight table (a lane stride of
    0).  log (if given) counts the accesses by kind and size."""
    log = {} if log is None else log
    m = {k: Memory(np.asarray(v), log) for k, v in abi.items()}
    py, pc = Memory(pred_y, log), Memory(pred_c, log)
    ry, rcb, rcr = (Memory(r, log) for r in res)
    B = np.asarray(pred_y).shape[0]
    n = mb_w * mb_h
    H, W = 16 * mb_h, 16 * mb_w
    Hc, Wc = H // 2, W // 2
    cw, ch = 4 * mb_w, 4 * mb_h
    out_y = Memory(np.zeros(B * H * W), log, out=True)
    out_c = [Memory(np.zeros(B * Hc * Wc), log, out=True) for _ in "cc"]
    dense = "wp" in abi or "wtab" not in abi
    stride = 0 if shared_wtab else 16 * 33 * 33 * 12
    total = B * ch * cw

    def cell_of(t):
        tc = t if t < total else 0
        cx, cy, b = tc % cw, (tc // cw) % ch, tc // (cw * ch)
        mb = b * n + (cy >> 2) * mb_w + (cx >> 2)
        return cx, cy, b, mb, mb * 16 + (cy & 3) * 4 + (cx & 3)

    def i32(k, word, count):
        return m[k].load(4 * word, 4 * count, np.int32)

    threads = -(-total // THREADS) * THREADS
    for t in range(threads):
        cx, cy, b, mb, cell = cell_of(t)
        # the MB row's first thread (lanes 4k..4k+3 of the same warp)
        lead = t - (t & 3)
        assert lead // 32 == t // 32
        _, _, lb, lmb, _ = cell_of(lead)
        assert t >= total or lmb == mb
        kind, = i32("kind", lmb, 1)
        if dense:
            sid, lw = 0, tuple(i32("logwd", lmb * 2, 2))
        else:
            sid, = i32("slice_id", lmb, 1)
            lw = tuple(i32("slogwd", (lb * 16 + sid) * 2, 2))
        # each thread's pair of lists (and of refidx), before the shuffles
        slot = i32("refslot", cell * 2, 2)
        ri = None if dense else i32("refidx", cell * 2, 2)
        if t >= total:
            continue
        yo = (b * H + cy * 4) * W + cx * 4
        co = (b * Hc + cy * 2) * Wc + cx * 2
        if kind < 4:
            for r in range(4):
                out_y.store(yo + r * W, [0] * 4)
            for r in range(2):
                for o in out_c:
                    o.store(co + r * Wc, [0] * 2)
            continue
        # an inter cell's other loads, all before its first store
        res_y = [ry.load(4 * (yo + r * W), 16, np.int32) for r in range(4)]
        res_c = [[rc.load(4 * (co + r * Wc), 8, np.int32) for r in range(2)]
                 for rc in (rcb, rcr)]
        u0, u1 = slot[0] >= 0, slot[1] >= 0
        both, only1 = u0 and u1, not u0
        read0, read1 = not only1, u1 or only1
        if dense:
            q = np.concatenate([i32("wp", cell * 12 + 4 * i, 4)
                                for i in range(3)])
            w = [(q[2 * pl], q[2 * pl + 1], q[6 + 2 * pl], q[7 + 2 * pl])
                 for pl in range(3)]
        else:
            r0, r1 = (min(max(v, -1), 31) + 1 for v in ri)
            e = b * stride + ((sid * 33 + r0) * 33 + r1) * 12
            q = np.concatenate([i32("wtab", e + 4 * i, 4) for i in range(3)])
            w = [tuple(q[4 * pl:4 * pl + 4]) for pl in range(3)]
        plane = H * W
        for r in range(4):
            o = b * 2 * plane + (cy * 4 + r) * W + cx * 4
            p0 = py.load(o, 4, np.uint8) if read0 else [0] * 4
            p1 = py.load(plane + o, 4, np.uint8) if read1 else [0] * 4
            out_y.store(yo + r * W, [
                _clip(_combine(p0[x], p1[x], w[0], lw[0], both, only1)
                      + res_y[r][x]) for x in range(4)])
        plane = Hc * Wc
        for pl, oc in enumerate(out_c):
            for r in range(2):
                o = b * 4 * plane + (cy * 2 + r) * Wc + cx * 2
                p0 = pc.load(pl * plane + o, 2, np.uint8) if read0 \
                    else [0] * 2
                p1 = pc.load((2 + pl) * plane + o, 2, np.uint8) if read1 \
                    else [0] * 2
                oc.store(co + r * Wc, [
                    _clip(_combine(p0[x], p1[x], w[1 + pl], lw[1], both,
                                   only1) + res_c[pl][r][x])
                    for x in range(2)])
    assert (out_y.words >= 0).all() and all((o.words >= 0).all()
                                            for o in out_c)
    return (out_y.words.reshape(B, H, W),
            *(o.words.reshape(B, Hc, Wc) for o in out_c))


@functools.lru_cache(maxsize=None)
def _jax_init(mb_w, mb_h, keys):
    """The JAX package's _mc_combine (after its resolve_weights), then
    _post_mc (residual planes of the ABI, the add and the clip): the
    init planes of one picture."""
    def run(abi, py, pc, ws4, ws8):
        a = jp.resolve_weights(abi)
        preds = _mc_combine(a, (py[0], py[1]), ((pc[0, 0], pc[0, 1]),
                                                (pc[1, 0], pc[1, 1])),
                            mb_w, mb_h, (0, 1))
        out = jp._post_mc(abi, preds, mb_w=mb_w, mb_h=mb_h, ws4=ws4,
                          ws8=ws8, cqp_off=(0, 0), pallas=True)
        return out[:3]
    return jax.jit(run)


def _case(mb_w, mb_h, B, seed, dense=False):
    """(full ABI [B, n, ...] numpy with the weighted fields of
    random_weighted_abi over synthetic_abi_p's, pred_y, pred_c uint8)."""
    w = random_weighted_abi(mb_w, mb_h, B, seed, dense)
    lanes = []
    for b in range(B):
        a = synthetic_abi_p(mb_w, mb_h, seed + b, qp=20 + 7 * b,
                            bi_frac=0.3)
        full = {k: np.asarray(v) for k, v in a.items()
                if isinstance(v, np.ndarray)}
        full.update({k: v[b] for k, v in w.items()})
        if dense:
            del full["wtab"], full["slogwd"]
        full.pop("patch", None)
        lanes.append(full)
    abi = {k: np.ascontiguousarray(np.stack([a[k] for a in lanes]), np.int32)
           for k in lanes[0]}
    rng = np.random.default_rng(seed)
    H, W = 16 * mb_h, 16 * mb_w
    return (abi, rng.integers(0, 256, (B, 2, H, W), np.uint8),
            rng.integers(0, 256, (B, 2, 2, H // 2, W // 2), np.uint8))


def _check(abi, pred_y, pred_c, mb_w, mb_h, shared_wtab=False):
    ws4, ws8 = make_ws_consts(FLAT4, FLAT8)
    tws4, tws8 = convert.ws_from_jax(ws4, ws8)
    ta = {k: torch.from_numpy(v) for k, v in abi.items()}
    if shared_wtab:                    # one table for every lane, as the
        ta["wtab"] = ta["wtab"][:1].expand_as(ta["wtab"])   # wire ships it
    res = tt.residual_planes(ta, mb_w, mb_h, tws4, tws8)
    tpy, tpc = torch.from_numpy(pred_y), torch.from_numpy(pred_c)
    plain = ti.inter_init_plain(ta, tpy, tpc, *res, mb_w, mb_h)
    before = dict(LAUNCHES)
    wrapped = inter_combine(ta, tpy, tpc, *res, mb_w, mb_h)
    assert LAUNCHES == before                 # CPU tensors: plain version
    log = {}
    got = thread_program(abi, pred_y, pred_c, [r.numpy() for r in res],
                         mb_w, mb_h, shared_wtab, log)
    cells = abi["kind"].size * 16
    # every row of a cell one store: 16 bytes luma, 8 bytes chroma
    assert {k: v for k, v in log.items() if k.startswith("store")} == \
        {"store16": 4 * cells, "store8": 4 * cells}
    assert "load1" not in log
    for g, p, w, name in zip(got, plain, wrapped, ("y", "cb", "cr")):
        assert p.dtype == w.dtype == torch.int32
        assert torch.equal(w, p), name
        assert_same(g, p, f"model init_{name}")
    for b in range(abi["kind"].shape[0]):
        ja = {k: jnp.asarray(ta[k][b].numpy()) for k in abi}
        want = _jax_init(mb_w, mb_h, tuple(sorted(ja)))(
            ja, jnp.asarray(pred_y[b], jnp.int32),
            jnp.asarray(pred_c[b], jnp.int32), jnp.asarray(ws4),
            jnp.asarray(ws8))
        for g, w, name in zip(got, want, ("y", "cb", "cr")):
            assert_same(g[b], w, f"init_{name}[{b}] vs JAX")
    return got


@pytest.mark.parametrize("dense", [False, True], ids=["tables", "dense"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mb_w,mb_h", GRIDS)
def test_thread_program(mb_w, mb_h, B, dense):
    abi, py, pc = _case(mb_w, mb_h, B, seed=90 + B, dense=dense)
    got = _check(abi, py, pc, mb_w, mb_h)
    inter = np.repeat(np.repeat((abi["kind"] >= 4).reshape(B, mb_h, mb_w),
                                16, 1), 16, 2)
    assert not got[0][~inter].any()           # intra MBs come out 0


def test_thread_program_shared_table():
    """One weight table for every lane (lane stride 0), as unpack_wire
    gives it when no lane ships weights."""
    abi, py, pc = _case(4, 3, 3, seed=95)
    _check(abi, py, pc, 4, 3, shared_wtab=True)


@pytest.mark.parametrize("pattern", ["l0", "l1", "bi", "none"])
@pytest.mark.parametrize("logwd", [0, 1, 7])
def test_thread_program_one_pattern(pattern, logwd):
    """Every inter cell with one list pattern (list 1 only reads list 1's
    weights even though list 0 is unused; no list reads list 0's) and
    every slice at one logwd."""
    mb_w, mb_h = 4, 3
    abi, py, pc = _case(mb_w, mb_h, 2, seed=96)
    use = {"l0": (1, 0), "l1": (0, 1), "bi": (1, 1), "none": (0, 0)}[pattern]
    for lst, u in enumerate(use):
        abi["refslot"][..., lst] = 1 if u else -1
    abi["kind"][:] = 4 + (np.arange(mb_w * mb_h) % 2)
    abi["slogwd"][:] = logwd
    _check(abi, py, pc, mb_w, mb_h)
