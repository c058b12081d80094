"""Synthetic frame ABIs for kernel checks and timing (no bitstream).

`synthetic_abi` / `synthetic_abi_p` make numpy ABIs, the same as the JAX
package's `arrow_h264_tpu.ops.synthetic`: a random I frame, or a P/B frame
with a bounded MV palette and sparse intra MBs.  `synthetic_batch` uploads
one; `random_intra_abi` draws the intra fields with no structure at all,
`random_deblock_abi` the fields the deblocking tables read,
`random_deblock_tables` the deblocking tables, `random_residual_abi` the
fields the residual stage reads and `random_weighted_abi` those of the
inter combine.  `forced_wire_round` makes a round of wire buffers whose
spec is forced to the schemes of one of `WIRE_CASES` (`random_wire_abi`
lanes through `wire_round`).
"""

from __future__ import annotations

import numpy as np

from .abi import (
    MAX_SLICES, KIND_B, KIND_I4x4, KIND_I16, KIND_IPCM, KIND_P, FrameABI,
    empty_frame_abi, identity_wtab, patch_capacity,
)
from .deblock import TABLE_SHAPES
from .wire import _ORDER, emit_wire, merge_specs, pack_wire_raw, wire_total
from ..models.pipeline import upload_abi


def synthetic_abi(mb_w: int, mb_h: int, seed: int = 0,
                  qp: int = 26) -> FrameABI:
    """A structurally valid single-slice I-frame ABI with random content."""
    rng = np.random.default_rng(seed)
    n = mb_w * mb_h
    kind = rng.choice([KIND_I4x4, KIND_I16], n).astype(np.int32)
    abi = FrameABI(
        kind=kind,
        qp=np.full(n, qp, np.int32),
        luma4=rng.integers(-8, 9, (n, 16, 4, 4)).astype(np.int32),
        luma8=np.zeros((n, 4, 8, 8), np.int32),
        luma_dc=rng.integers(-16, 17, (n, 4, 4)).astype(np.int32),
        chroma_dc=rng.integers(-8, 9, (n, 2, 2, 2)).astype(np.int32),
        chroma_ac=rng.integers(-4, 5, (n, 2, 2, 2, 4, 4)).astype(np.int32),
        i4_modes=np.full((n, 16), 2, np.int32),
        i8_modes=np.full((n, 4), 2, np.int32),
        i16_mode=rng.integers(0, 3, n).astype(np.int32),
        chroma_mode=np.zeros(n, np.int32),
        i4_avail=np.zeros((n, 16, 4), np.int32),
        i8_avail=np.zeros((n, 4, 4), np.int32),
        mb_avail=np.zeros((n, 3), np.int32),
        pcm=np.zeros((n, 384), np.int32),
        nz=(rng.random((n, 4, 4)) < 0.5).astype(np.int32),
        tr8=np.zeros(n, np.int32),
        slice_id=np.zeros(n, np.int32),
        disable_idc=np.zeros(n, np.int32),
        alpha_off=np.zeros(n, np.int32),
        beta_off=np.zeros(n, np.int32),
        mv=np.zeros((n, 4, 4, 2, 2), np.int32),
        refid=np.full((n, 4, 4, 2), -1, np.int32),
        refslot=np.full((n, 4, 4, 2), -1, np.int32),
        refidx=np.full((n, 4, 4, 2), -1, np.int32),
        wtab=identity_wtab().copy(),
        slogwd=np.zeros((MAX_SLICES, 2), np.int32),
        patch=np.full(patch_capacity(mb_w, mb_h), -1, np.int32),
        mb_w=mb_w, mb_h=mb_h,
    )
    # geometric availability (single slice, raster order, no constrained intra)
    for my in range(mb_h):
        for mx in range(mb_w):
            a = my * mb_w + mx
            abi["mb_avail"][a] = [mx > 0, my > 0, mx > 0 and my > 0]
            for y4 in range(4):
                for x4 in range(4):
                    bx, by = mx * 4 + x4, my * 4 + y4
                    r = y4 * 4 + x4
                    al = bx > 0
                    at = by > 0
                    atl = al and at
                    # top-right availability per spec block order: unavailable
                    # for in-MB blocks whose TR neighbor decodes later
                    atr = by > 0 and bx + 1 < mb_w * 4 and not (
                        y4 > 0 and (x4 == 3 or (x4 % 2 == 1 and y4 % 2 == 1)))
                    abi["i4_avail"][a, r] = [al, at, atl, atr]
                    mode = int(rng.integers(0, 9))
                    if mode != 2:
                        # keep modes consistent with availability
                        need_t = mode in (0, 3, 7)
                        need_l = mode in (1, 8)
                        need_both = mode in (4, 5, 6)
                        if (need_t and not at) or (need_l and not al) or \
                                (need_both and not (al and at and atl)) or \
                                (mode in (3, 7) and not at):
                            mode = 2
                    abi["i4_modes"][a, r] = mode
    return abi


def synthetic_abi_p(mb_w: int, mb_h: int, seed: int = 0, qp: int = 26,
                    intra_frac: float = 0.05, n_slots: int = 2,
                    n_mv: int = 24, bi_frac: float = 0.0) -> FrameABI:
    """A P/B-realistic ABI: mostly inter MBs with a bounded MV palette
    (respects the Pallas MC path's per-band candidate cap), sparse intra,
    moderate residuals.  Models a typical 1080p P-frame workload."""
    base = synthetic_abi(mb_w, mb_h, seed=seed, qp=qp)
    rng = np.random.default_rng(seed + 1000)
    n = mb_w * mb_h
    inter = rng.random(n) >= intra_frac
    base["kind"] = np.where(inter, KIND_P, base["kind"]).astype(np.int32)
    # quarter-pel MV palette within the kernel envelope (int +-16)
    palette = rng.integers(-64, 65, (n_mv, 2)).astype(np.int32)
    mv_sel = rng.integers(0, n_mv, (n, 4, 4))
    mv = palette[mv_sel]                           # [n,4,4,2]
    base["mv"][..., 0, :] = mv
    slot = rng.integers(0, n_slots, (n, 4, 4)).astype(np.int32)
    im = inter[:, None, None]
    base["refslot"][..., 0] = np.where(im, slot, -1)
    base["refid"][..., 0] = np.where(im, slot, -1)
    base["refidx"][..., 0] = np.where(im, slot, -1)
    if bi_frac > 0:
        bi = (rng.random((n, 4, 4)) < bi_frac) & im
        base["mv"][..., 1, :] = palette[rng.integers(0, n_mv, (n, 4, 4))]
        slot1 = rng.integers(0, n_slots, (n, 4, 4)).astype(np.int32)
        base["refslot"][..., 1] = np.where(bi, slot1, -1)
        base["refid"][..., 1] = np.where(bi, slot1, -1)
        base["refidx"][..., 1] = np.where(bi, slot1, -1)
    # sparse inter residuals (~2/3 of inter blocks are all-zero)
    zero = rng.random((n, 16)) < 0.66
    base["luma4"][inter] = np.where(zero[inter, :, None, None], 0,
                                    base["luma4"][inter] // 2)
    base["nz"] = (base["luma4"] != 0).any((2, 3)).reshape(n, 4, 4) \
        .astype(np.int32)
    return base


def synthetic_batch(mb_w: int, mb_h: int, seed: int, device,
                    inter: bool = False, **kw) -> tuple[dict, dict]:
    """(host FrameABI, device ABI dict with a leading stream axis B = 1)."""
    abi = synthetic_abi_p(mb_w, mb_h, seed, **kw) if inter else \
        synthetic_abi(mb_w, mb_h, seed, **kw)
    return abi, {k: v[None] for k, v in upload_abi(abi, device).items()}


def random_intra_abi(mb_w: int, mb_h: int, seed: int) -> dict:
    """Intra ABI fields (numpy int32) with every kind, random modes and
    random availability bits, so reads at the picture border happen too
    (they read 0).  PCM MBs need raw samples (0..255) as residual."""
    rng = np.random.default_rng(seed)
    n = mb_w * mb_h
    return dict(
        kind=rng.choice([0, 1, 2, 3, 4], n, p=[.3, .25, .2, .05, .2])
        .astype(np.int32),
        i4_modes=rng.integers(0, 9, (n, 16)).astype(np.int32),
        i4_avail=rng.integers(0, 2, (n, 16, 4)).astype(np.int32),
        i8_modes=rng.integers(0, 9, (n, 4)).astype(np.int32),
        i8_avail=rng.integers(0, 2, (n, 4, 4)).astype(np.int32),
        i16_mode=rng.integers(0, 4, n).astype(np.int32),
        chroma_mode=rng.integers(0, 4, n).astype(np.int32),
        mb_avail=rng.integers(0, 2, (n, 3)).astype(np.int32))


def random_deblock_abi(mb_w: int, mb_h: int, B: int, seed: int) -> dict:
    """The ABI fields that ops/deblock.py::deblock_tables reads (numpy
    int32 [B, n, ...]) with every MB kind (two thirds inter, so that most
    edges take the MV and reference rules) and every rule in play: slices
    of ~10 MBs (ids 0..15) with disable_idc 0, 1 or 2 and their own
    alpha and beta offsets (even, -12..12), qp 0..51 (a quarter of the
    MBs at 0 or 51), tr8, nz counts 0..2, refids -1, 0..3 and NX_FLAG
    (64) | 0..1 with both lists often on one picture, and MVs of -7..7
    quarter samples, so that differences fall on both sides of the
    limits 2 and 4."""
    rng = np.random.default_rng(seed)
    n = mb_w * mb_h
    g = (B, n)
    sid = np.cumsum(rng.random(g) < 0.1, 1) % MAX_SLICES
    per_slice = lambda lo, hi: np.take_along_axis(
        rng.integers(lo, hi, (B, MAX_SLICES)), sid, 1)
    qp = rng.integers(0, 52, g)
    qp = np.where(rng.random(g) < 0.25, rng.choice([0, 51], g), qp)
    ref = rng.choice([-1, -1, 0, 1, 2, 3, 64, 65], g + (4, 4, 2))
    same = rng.random(g + (4, 4)) < 0.25         # both lists on one picture
    ref[..., 1] = np.where(same, ref[..., 0], ref[..., 1])
    return {k: np.ascontiguousarray(v, np.int32) for k, v in dict(
        kind=rng.choice(6, g, p=[.1, .1, .1, .05, .35, .3]), qp=qp,
        slice_id=sid,
        disable_idc=per_slice(0, 3), alpha_off=2 * per_slice(-6, 7),
        beta_off=2 * per_slice(-6, 7), tr8=rng.integers(0, 2, g),
        nz=rng.choice([0, 0, 0, 1, 2], g + (4, 4)),
        mv=rng.integers(-7, 8, g + (4, 4, 2, 2)), refid=ref).items()}


def random_deblock_tables(mb_w: int, mb_h: int, B: int, seed: int) -> dict:
    """Deblocking tables (numpy int32, the keys and shapes of
    ops/deblock.py::deblock_tables, [B, n, ...]) with no structure: bS
    0..4, tc0 0..25, alpha and beta 0..255 on every edge, but bS 0 on the
    edges at the picture's left and top border, as deblock_tables
    guarantees."""
    rng = np.random.default_rng(seed)
    n = mb_w * mb_h
    hi = {"bs": 5, "tc": 26, "a_": 256, "b_": 256}
    t = {k: rng.integers(0, hi[k[:2]], (B, n) + s).astype(np.int32)
         for k, s in TABLE_SHAPES.items()}
    t["bs_v"].reshape(B, mb_h, mb_w, 4, 4)[:, :, 0, 0] = 0
    t["bs_h"].reshape(B, mb_h, mb_w, 4, 4)[:, 0, :, 0] = 0
    t["bs_c"].reshape(B, mb_h, mb_w, 2, 2, 4)[:, :, 0, 0, 0] = 0
    t["bs_c"].reshape(B, mb_h, mb_w, 2, 2, 4)[:, 0, :, 1, 0] = 0
    return t


def random_residual_abi(mb_w: int, mb_h: int, B: int, seed: int) -> dict:
    """The ABI fields that ops/transforms.py::residual_planes reads (numpy
    int32 [B, n, ...]) with every rule in play: every MB kind (I4x4,
    I8x8, I16, I_PCM, P, B), qp 0..51 with a third of the MBs at 0 (the
    lossless bypass MBs) and more at the dequant switches 23/24 and 35/36
    and at 51, tr8 on half the MBs, levels of every class inside the
    spec's ranges (7.4.5.3: a quarter of the 4x4 and 8x8 blocks all
    zero, the DC classes up to +-600), PCM samples 0..255, and every
    prediction mode the DPCM reads (i4/i8 modes 0..8, i16 and chroma
    modes 0..3).  Callers drop classes to test their absence."""
    rng = np.random.default_rng(seed)
    n = mb_w * mb_h
    g = (B, n)
    qp = rng.integers(0, 52, g)
    qp = np.where(rng.random(g) < 0.2, rng.choice([23, 24, 35, 36, 51], g),
                  qp)
    qp = np.where(rng.random(g) < 0.33, 0, qp)

    def levels(shape, hi):
        v = rng.integers(-hi, hi + 1, g + shape)
        big = rng.random(g + shape) < 0.02         # a few large levels
        v = np.where(big, rng.integers(-2000, 2001, g + shape), v)
        zero = rng.random(g + shape[:1]) < 0.25    # all-zero blocks
        return np.where(zero.reshape(g + shape[:1] + (1,) *
                                     (len(shape) - 1)), 0, v)

    return {k: np.ascontiguousarray(v, np.int32) for k, v in dict(
        kind=rng.choice(6, g, p=[.25, .15, .2, .1, .2, .1]), qp=qp,
        tr8=rng.integers(0, 2, g),
        luma4=levels((16, 4, 4), 40), luma8=levels((4, 8, 8), 40),
        luma_dc=rng.integers(-600, 601, g + (4, 4)),
        chroma_dc=rng.integers(-600, 601, g + (2, 2, 2)),
        chroma_ac=levels((2, 2, 2, 4, 4), 30),
        pcm=rng.integers(0, 256, g + (384,)),
        i4_modes=rng.integers(0, 9, g + (16,)),
        i8_modes=rng.integers(0, 9, g + (4,)),
        i16_mode=rng.integers(0, 4, g),
        chroma_mode=rng.integers(0, 4, g)).items()}


def random_weighted_abi(mb_w: int, mb_h: int, B: int, seed: int,
                        dense: bool = False) -> dict:
    """The ABI fields that the inter combine reads (numpy int32 [B, n,
    ...]): kind (a quarter intra), refslot and refidx with every list
    pattern a 4x4 cell can have (both lists, list 0 only, list 1 only,
    neither; refidx -1..31 and past it, which the lookup clamps), slices
    of ~6 MBs (ids 0..15), and per-slice weight tables (wtab [B, 16, 33,
    33, 3, 4], slogwd [B, 16, 2]) whose rows are explicit (w -128..127, o
    -128..127, logwd 0..7), implicit (logwd 5, w0 + w1 = 64, o 0) or the
    identity (logwd 0, w 1, o 0).  dense: also wp [B, n, 4, 4, 2, 3, 2]
    and logwd [B, n, 2] drawn per cell and MB, with no tables (the dense
    upload's fields)."""
    rng = np.random.default_rng(seed)
    n = mb_w * mb_h
    g = (B, n)
    kind = rng.choice(6, g, p=[.1, .05, .05, .05, .45, .3])
    pattern = rng.choice(4, g + (4, 4), p=[.4, .3, .2, .1])  # bi, l0, l1, -
    slot = rng.integers(0, 4, g + (4, 4, 2))
    use = np.stack([np.isin(pattern, (0, 1)), np.isin(pattern, (0, 2))], -1)
    refslot = np.where(use, slot, -1)
    refidx = np.where(use, rng.integers(0, 34, g + (4, 4, 2)), -1)
    refidx = np.where(rng.random(refidx.shape) < 0.05,
                      rng.integers(-3, 40, refidx.shape), refidx)
    sid = np.cumsum(rng.random(g) < 0.16, 1) % MAX_SLICES
    out = dict(kind=kind, refslot=refslot, refidx=refidx, slice_id=sid)
    if dense:
        out["wp"] = np.stack([rng.integers(-128, 128, g + (4, 4, 2, 3)),
                              rng.integers(-128, 128, g + (4, 4, 2, 3))], -1)
        out["logwd"] = rng.integers(0, 8, g + (2,))
    else:
        wtab = np.broadcast_to(identity_wtab().astype(np.int64),
                               (B,) + identity_wtab().shape).copy()
        slogwd = np.zeros((B, MAX_SLICES, 2), np.int64)
        for b in range(B):
            for s in range(MAX_SLICES):
                row = rng.choice(3)              # explicit, implicit, identity
                if row == 0:
                    wtab[b, s] = rng.integers(-128, 128, wtab.shape[2:])
                    slogwd[b, s] = rng.integers(0, 8, 2)
                elif row == 1:
                    w0 = rng.integers(-64, 129, wtab.shape[2:4] + (1,))
                    wtab[b, s, ..., 0] = w0
                    wtab[b, s, ..., 2] = 64 - w0
                    wtab[b, s, ..., 1] = wtab[b, s, ..., 3] = 0
                    slogwd[b, s] = 5
        out.update(wtab=wtab, slogwd=slogwd)
    return {k: np.ascontiguousarray(v, np.int32) for k, v in out.items()}


def random_wire_abi(mb_w: int, mb_h: int, seed: int, *, intra="sparse",
                    inter="nu", coeff="bm8", pcm="sparse",
                    wtab="sparse") -> FrameABI:
    """A host ABI of random content with the sections that the knobs ask
    for: intra zero/sparse/dense side-info; inter zero (no P/B MB),
    base (one motion a MB), nu (a few sub-partitioned MBs) or dense
    (every MB); coefficients zero, bm8 (int8 levels), dense16 or dense
    (levels past int8 or int16); pcm zero/sparse; wtab zero/sparse.
    Slices, the deblock override and NX_FLAG refs are random too."""
    rng = np.random.default_rng(seed)
    n = mb_w * mb_h
    a = empty_frame_abi(mb_w, mb_h)
    kinds = [KIND_I4x4, KIND_I16] if inter == "zero" else \
        [KIND_I4x4, KIND_I16, KIND_P, KIND_B]
    a["kind"] = rng.choice(kinds, n).astype(np.int32)
    if inter != "zero":
        a["kind"][0] = KIND_P
    a["qp"] = rng.integers(0, 52, n).astype(np.int32)
    sid = rng.integers(0, 16, n).astype(np.int32)
    a["slice_id"] = sid
    rows = rng.integers(-12, 13, (16, 3)).astype(np.int32)
    rows[:, 0] = rng.integers(0, 3, 16)
    a["disable_idc"], a["alpha_off"], a["beta_off"] = rows[sid].T.copy()
    a["deblock_off"] = (rng.random(n) < 0.2).astype(np.int32)
    a["tr8"] = rng.integers(0, 2, n).astype(np.int32)
    a["mb_avail"] = rng.integers(0, 2, (n, 3)).astype(np.int32)
    a["i16_mode"] = rng.integers(0, 4, n).astype(np.int32)
    a["chroma_mode"] = rng.integers(0, 4, n).astype(np.int32)
    a["nz"] = rng.integers(0, 2, (n, 4, 4)).astype(np.int32)
    a["slogwd"] = rng.integers(-128, 128, (16, 2)).astype(np.int32)

    side = {"zero": 0.0, "sparse": 0.1, "dense": 1.0}[intra]
    has = rng.random(n) < side
    if intra != "zero":
        has[0] = True
    for k, hi, shape in (("i4_modes", 9, (16,)), ("i4_avail", 2, (16, 4)),
                         ("i8_modes", 9, (4,)), ("i8_avail", 2, (4, 4))):
        v = rng.integers(0, hi, (n,) + shape).astype(np.int32)
        a[k] = np.where(has.reshape((n,) + (1,) * len(shape)), v, 0)

    if inter != "zero":
        live = a["kind"] >= KIND_P
        mv = rng.integers(-600, 600, (n, 1, 1, 2, 2))
        slot = rng.integers(0, 5, (n, 1, 1, 2))
        slot[:, :, :, 1] = np.where(rng.random((n, 1, 1)) < 0.5, -1,
                                    slot[:, :, :, 1])
        mvs = np.broadcast_to(mv, (n, 4, 4, 2, 2)).copy()
        slots = np.broadcast_to(slot, (n, 4, 4, 2)).copy()
        split = {"base": 0.0, "nu": 0.1, "dense": 1.0}[inter]
        nu = (rng.random(n) < split) & live
        if inter in ("nu", "dense"):
            nu[0] = True
        mvs[nu] = rng.integers(-600, 600, (nu.sum(), 4, 4, 2, 2))
        slots[nu] = rng.integers(-1, 5, (nu.sum(), 4, 4, 2))
        cell = live[:, None, None, None]
        a["mv"] = np.where(cell[..., None], mvs, 0).astype(np.int32)
        a["refslot"] = np.where(cell, slots, -1).astype(np.int32)
        a["refidx"] = np.where(a["refslot"] >= 0, a["refslot"] % 3,
                               -1).astype(np.int32)
        a["refid"] = np.where(a["refslot"] >= 0, 100 + a["refslot"],
                              -1).astype(np.int32)
        a["nx_uids"] = np.array([102], np.int64)    # slot 2: non-existing

    if coeff != "zero":
        hi = {"bm8": 100, "dense16": 3000, "dense": 70000}[coeff]
        dens = 0.01 if coeff == "bm8" else 0.1     # bm8: few nonzero rows
        for k in ("luma4", "luma_dc", "chroma_dc", "chroma_ac"):
            v = rng.integers(-hi, hi + 1, a[k].shape)
            a[k] = np.where(rng.random(a[k].shape) < dens, v,
                            0).astype(np.int32)
        a["luma4"].reshape(-1)[0] = hi

    if pcm != "zero":
        ipcm = rng.random(n) < 0.05
        ipcm[-1] = True
        a["kind"][ipcm] = KIND_IPCM
        a["pcm"] = np.where(ipcm[:, None], rng.integers(0, 256, (n, 384)),
                            0).astype(np.int32)

    if wtab != "zero":
        wt = identity_wtab().copy()
        for s in rng.choice(16, 3, replace=False):
            wt[s, rng.integers(0, 33), :, 1] = rng.integers(
                -128, 128, (33, 4))
        a["wtab"] = wt
    return a


def _shuffled(raw: dict, rng) -> dict:
    """raw with every sparse section's rows in a random order."""
    raw = dict(raw)
    for idx, vals in (("in_idx", ("in_ext",)),
                      ("nu_idx", ("nu_mv", "nu_ref")),
                      ("pcm_idx", ("pcm_val",)), ("wt_idx", ("wt_val",))):
        if idx in raw:
            perm = rng.permutation(len(raw[idx]))
            raw[idx] = raw[idx][perm]
            for v in vals:
                raw[v] = raw[v][perm]
    return raw


def wire_round(lanes: list, mb_w: int, mb_h: int, force: dict, seed: int,
               pad: int = 24):
    """(buf [B, total] uint8, a view of a wider array: lanes a row stride
    apart; the target spec): each lane's ABI packed, its sparse rows
    shuffled, emitted per the lanes' merged spec raised to `force`
    ({field: (scheme, bucket)}: a scheme no lower, buckets no smaller)."""
    n = mb_w * mb_h
    rng = np.random.default_rng(seed)
    packed = {id(a): pack_wire_raw(a, mb_w, mb_h) for a in lanes}
    packs = [packed[id(a)] for a in lanes]
    merged = merge_specs([sp for _, sp in packs])
    target = []
    for f, sch, b in merged:
        fs, fb = force.get(f, (sch, b))
        if _ORDER[fs] > _ORDER[sch]:
            sch, b = fs, fb
        elif fs == sch and _ORDER[sch] == 1:
            b = tuple(map(max, b, fb)) if isinstance(b, tuple) else max(b, fb)
        target.append((f, sch, b))
    target = tuple(target)
    total = wire_total(target, n)
    wide = np.zeros((len(lanes), total + pad), np.uint8)
    for i, (raw, sp) in enumerate(packs):
        emit_wire(_shuffled(raw, rng), sp, target, n, out=wide[i, :total])
    return wide[:, :total], target


# case -> (the lanes' random_wire_abi knobs, one dict a lane; the forced
# target entries of wire_round)
WIRE_CASES = {
    "zero": ([dict(intra="zero", inter="zero", coeff="zero", pcm="zero",
                   wtab="zero")], {}),
    "sparse": ([dict()], {"intra": ("sparse", 40), "inter": ("base", 48),
                          "pcm": ("sparse", 24), "wtab": ("sparse", 6)}),
    "base": ([dict(inter="base", intra="dense", pcm="zero", wtab="zero")],
             {}),
    "dense": ([dict(coeff="dense16", inter="dense", pcm="sparse")],
              {"intra": ("dense", 0), "inter": ("dense", 0),
               "pcm": ("dense", 0), "l8": ("dense", 0)}),
    "dense32": ([dict(coeff="dense", intra="zero", inter="base")],
                {"inter": ("base", 40), "wtab": ("sparse", 16)}),
    "mixed": ([dict(intra="zero", inter="zero", coeff="zero", pcm="zero",
                    wtab="zero"), dict(), dict(inter="base", coeff="dense16",
                                           pcm="zero")],
              {"pcm": ("sparse", 8)}),
}


def forced_wire_round(case: str, mb_w: int, mb_h: int, B: int, seed: int,
                      distinct: int | None = None):
    """wire_round of B lanes of WIRE_CASES[case] (their knobs cycled over
    the lanes), each lane's ABI from its own seed; with `distinct`, only
    that many ABIs, cycled over the lanes."""
    knobs, force = WIRE_CASES[case]
    k = B if distinct is None else min(B, distinct)
    abis = [random_wire_abi(mb_w, mb_h, seed + i, **knobs[i % len(knobs)])
            for i in range(k)]
    return wire_round([abis[i % k] for i in range(B)], mb_w, mb_h, force,
                      seed)
