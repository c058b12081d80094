"""Synthetic frame ABIs for kernel checks and timing (no bitstream).

`synthetic_abi` / `synthetic_abi_p` make numpy ABIs, the same as the JAX
package's `arrow_h264_tpu.ops.synthetic`: a random I frame, or a P/B frame
with a bounded MV palette and sparse intra MBs.  `synthetic_batch` uploads
one; `random_intra_abi` draws the intra fields with no structure at all.
"""

from __future__ import annotations

import numpy as np

from .abi import (
    MAX_SLICES, KIND_I4x4, KIND_I16, KIND_P, FrameABI, identity_wtab,
    patch_capacity,
)
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
