"""K10, the inter combine kernel (csrc/inter_combine.cu), on the CPU.

`thread_program` is a model of the kernel in Python: one thread a 4x4
luma cell (and the 2x2 chroma cells under it), in the kernel's order,
with its flat index arithmetic, its weight lookup (the per-slice tables
at slice_id and the clamped refidx, with a lane stride of 0 for a table
shared by every lane, or the dense wp/logwd) and its combine.  It must
equal the port's plain ops/inter.py::inter_init_plain, which must equal
the JAX package's `_mc_combine` followed by `_post_mc`'s residual add and
clip (arrow_h264_tpu/models/pipeline.py, with its own residual planes of
the same ABI), on `random_weighted_abi`: explicit and implicit weights,
logwd 0 and > 0, list-1-only cells, refidx -1 and past 31, and dense
wp.  Every comparison is exact (atol 0).
"""

import functools

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


def thread_program(abi: dict, pred_y, pred_c, res, mb_w: int, mb_h: int,
                   shared_wtab: bool = False):
    """inter_combine_kernel, thread by thread: numpy inputs -> (init_y,
    init_cb, init_cr) int64 numpy.  shared_wtab: every lane reads lane
    0's weight table (a lane stride of 0)."""
    f = {k: np.asarray(v).reshape(-1).astype(np.int64).tolist()
         for k, v in abi.items()}
    py = np.asarray(pred_y).reshape(-1).tolist()
    pc = np.asarray(pred_c).reshape(-1).tolist()
    ry, rcb, rcr = (np.asarray(r).reshape(-1).tolist() for r in res)
    B = np.asarray(pred_y).shape[0]
    n = mb_w * mb_h
    H, W = 16 * mb_h, 16 * mb_w
    Hc, Wc = H // 2, W // 2
    cw, ch = 4 * mb_w, 4 * mb_h
    dense = "wp" in abi or "wtab" not in abi
    stride = 0 if shared_wtab else 16 * 33 * 33 * 12
    out_y = np.full(B * H * W, -1, np.int64)
    out_c = [np.full(B * Hc * Wc, -1, np.int64) for _ in "cc"]
    for t in range(B * ch * cw):
        cx, cy, b = t % cw, (t // cw) % ch, t // (cw * ch)
        mb = b * n + (cy >> 2) * mb_w + (cx >> 2)
        cell = mb * 16 + (cy & 3) * 4 + (cx & 3)
        yo = (b * H + cy * 4) * W + cx * 4
        co = (b * Hc + cy * 2) * Wc + cx * 2
        if f["kind"][mb] < 4:
            for r in range(4):
                for x in range(4):
                    out_y[yo + r * W + x] = 0
            for r in range(2):
                for x in range(2):
                    out_c[0][co + r * Wc + x] = out_c[1][co + r * Wc + x] = 0
            continue
        u0, u1 = f["refslot"][cell * 2] >= 0, f["refslot"][cell * 2 + 1] >= 0
        both, only1 = u0 and u1, not u0
        if dense:
            p = cell * 12
            w = [(f["wp"][p + pl * 2], f["wp"][p + pl * 2 + 1],
                  f["wp"][p + 6 + pl * 2], f["wp"][p + 6 + pl * 2 + 1])
                 for pl in range(3)]
            lw = (f["logwd"][mb * 2], f["logwd"][mb * 2 + 1])
        else:
            sid = f["slice_id"][mb]
            r0 = min(max(f["refidx"][cell * 2], -1), 31) + 1
            r1 = min(max(f["refidx"][cell * 2 + 1], -1), 31) + 1
            p = b * stride + ((sid * 33 + r0) * 33 + r1) * 12
            w = [tuple(f["wtab"][p + pl * 4 + i] for i in range(4))
                 for pl in range(3)]
            lw = (f["slogwd"][(b * 16 + sid) * 2],
                  f["slogwd"][(b * 16 + sid) * 2 + 1])
        plane = H * W
        for r in range(4):
            for x in range(4):
                o = (cy * 4 + r) * W + cx * 4 + x
                v = _combine(py[b * 2 * plane + o],
                             py[b * 2 * plane + plane + o], w[0], lw[0],
                             both, only1)
                out_y[yo + r * W + x] = _clip(v + ry[yo + r * W + x])
        plane = Hc * Wc
        for pl, rc in enumerate((rcb, rcr)):
            for r in range(2):
                for x in range(2):
                    o = (cy * 2 + r) * Wc + cx * 2 + x
                    v = _combine(pc[b * 4 * plane + pl * plane + o],
                                 pc[b * 4 * plane + (2 + pl) * plane + o],
                                 w[1 + pl], lw[1], both, only1)
                    out_c[pl][co + r * Wc + x] = \
                        _clip(v + rc[co + r * Wc + x])
    return (out_y.reshape(B, H, W),
            *(c.reshape(B, Hc, Wc) for c in out_c))


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
    model_abi = dict(abi)
    got = thread_program(model_abi, pred_y, pred_c,
                         [r.numpy() for r in res], mb_w, mb_h, shared_wtab)
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
