"""Intra reconstruction: the knight-move wavefront in plain PyTorch.

Port of `arrow_h264_tpu.ops.intra`, and the plain version of the intra
kernel (`ops/kernels/intra_phase.py`, `csrc/intra_phase.cu`).  MBs of one
phase (phase = 2*mb_y + mb_x) are mutually independent; within an MB, 4x4
blocks advance through sub-steps 2*y4 + x4 and 8x8 blocks in raster order,
which respects the spec's left/top/top-left/top-right dependencies.

Each phase selects the jobs of each kind with boolean masks and runs them
as one batch over (stream, MB, block); eager PyTorch takes the dynamic
shapes that the JAX version had to mask instead.  Samples outside the
picture read as 0 (the zero border of the work buffers), as in the
reference.
"""

from __future__ import annotations

import torch

from .abi import KIND_I4x4, KIND_I8x8, KIND_I16, KIND_IPCM
from .intra_tables import R4, R8, S4, S8, W4, W8

# substep -> luma 4x4 blocks (x4, y4) with 2*y4 + x4 == s
_SUBSTEP_BLOCKS = [[(x, y) for y in range(4) for x in range(4)
                    if 2 * y + x == s] for s in range(10)]

_TABLES = {4: (torch.from_numpy(W4), torch.from_numpy(S4),
               torch.from_numpy(R4)),
           8: (torch.from_numpy(W8), torch.from_numpy(S8),
               torch.from_numpy(R8))}


def build_schedule(mb_w: int, mb_h: int):
    """Knight-move wavefront schedule.  Returns (mb_idx [F, P] int64,
    active [F, P] bool); F = mb_w + 2*(mb_h - 1) phases."""
    n_phases = 2 * (mb_h - 1) + mb_w
    per_phase = [[my * mb_w + (p - 2 * my) for my in range(mb_h)
                  if 0 <= p - 2 * my < mb_w] for p in range(n_phases)]
    pmax = max(len(m) for m in per_phase)
    mb_idx = torch.zeros((n_phases, pmax), dtype=torch.int64)
    active = torch.zeros((n_phases, pmax), dtype=torch.bool)
    for p, mbs in enumerate(per_phase):
        mb_idx[p, :len(mbs)] = torch.tensor(mbs)
        active[p, :len(mbs)] = True
    return mb_idx, active


def _win(buf, b, y, x, h: int, w: int):
    """Windows [J, h, w] of buf [B, Hb, Wb] at buffer coords (y, x)."""
    ar_h = torch.arange(h, device=buf.device)
    ar_w = torch.arange(w, device=buf.device)
    return buf[b[:, None, None], y[:, None, None] + ar_h[None, :, None],
               x[:, None, None] + ar_w[None, None, :]]


def _put(buf, b, y, x, val):
    """buf[b, y+1+i, x+1+j] = val[:, i, j] (frame coords -> buffer)."""
    h, w = val.shape[1:]
    ar_h = torch.arange(h, device=buf.device)
    ar_w = torch.arange(w, device=buf.device)
    buf[b[:, None, None], y[:, None, None] + 1 + ar_h[None, :, None],
        x[:, None, None] + 1 + ar_w[None, None, :]] = val.to(buf.dtype)


def _dc(st, sl, al, at, n: int):
    """DC of an n x n block from the top sum st and left sum sl."""
    sh = {4: 3, 8: 4, 16: 5}[n]
    both = (st + sl + n) >> sh
    lonly = (sl + n // 2) >> (sh - 1)
    tonly = (st + n // 2) >> (sh - 1)
    return torch.where(at & al, both, torch.where(
        al, lonly, torch.where(at, tonly, torch.full_like(st, 128))))


def _linear_pred(v, mode, n: int):
    """v [J, 1+3n] references -> [J, n*n] directional prediction."""
    W, S, R = (t.to(v.device) for t in _TABLES[n])
    m = mode.long()
    lin = (W[m] * v[:, None, :]).sum(-1, dtype=torch.int32)
    return (lin + R[m]) >> S[m]


def _job_luma4(yb, res_y, b, y, x, mode, avail):
    """4x4 intra-luma jobs at frame coords (y, x)."""
    win = _win(yb, b, y, x, 5, 9)          # buffer (y, x) == frame (y-1, x-1)
    al, at = avail[:, 0] > 0, avail[:, 1] > 0
    atl, atr = avail[:, 2] > 0, avail[:, 3] > 0
    tl = torch.where(atl, win[:, 0, 0], 0)
    top = torch.where(at[:, None], win[:, 0, 1:9], 0)
    top[:, 4:] = torch.where((at & ~atr)[:, None], top[:, 3:4], top[:, 4:])
    left = torch.where(al[:, None], win[:, 1:5, 0], 0)
    v = torch.cat([tl[:, None], top, left], 1)
    pred = _linear_pred(v, mode, 4)
    dc = _dc(top[:, :4].sum(1, dtype=torch.int32),
             left.sum(1, dtype=torch.int32), al, at, 4)
    pred = torch.where((mode == 2)[:, None], dc[:, None], pred)
    res = _win(res_y, b, y, x, 4, 4)
    _put(yb, b, y, x, torch.clamp(pred.reshape(-1, 4, 4) + res, 0, 255))


def _filter8_refs(tl, top, left, al, at, atl):
    """Intra_8x8 reference filtering (spec 8.3.2.2.1) over [J, ...]."""
    t, l = top, left
    ft0 = torch.where(atl, (tl + 2 * t[:, 0] + t[:, 1] + 2) >> 2,
                      (3 * t[:, 0] + t[:, 1] + 2) >> 2)
    mid = (t[:, :-2] + 2 * t[:, 1:-1] + t[:, 2:] + 2) >> 2    # x = 1..14
    ft15 = (t[:, 14] + 3 * t[:, 15] + 2) >> 2
    ft = torch.cat([ft0[:, None], mid, ft15[:, None]], 1)
    ft = torch.where(at[:, None], ft, t)
    ftl = torch.where(at & al, (t[:, 0] + 2 * tl + l[:, 0] + 2) >> 2,
                      torch.where(at, (3 * tl + t[:, 0] + 2) >> 2,
                                  torch.where(al, (3 * tl + l[:, 0] + 2) >> 2,
                                              tl)))
    ftl = torch.where(atl, ftl, tl)
    fl0 = torch.where(atl, (tl + 2 * l[:, 0] + l[:, 1] + 2) >> 2,
                      (3 * l[:, 0] + l[:, 1] + 2) >> 2)
    lmid = (l[:, :-2] + 2 * l[:, 1:-1] + l[:, 2:] + 2) >> 2   # y = 1..6
    fl7 = (l[:, 6] + 3 * l[:, 7] + 2) >> 2
    fl = torch.cat([fl0[:, None], lmid, fl7[:, None]], 1)
    fl = torch.where(al[:, None], fl, l)
    return ftl, ft, fl


def _job_luma8(yb, res_y, b, y, x, mode, avail):
    win = _win(yb, b, y, x, 9, 17)
    al, at = avail[:, 0] > 0, avail[:, 1] > 0
    atl, atr = avail[:, 2] > 0, avail[:, 3] > 0
    tl = torch.where(atl, win[:, 0, 0], 0)
    top = torch.where(at[:, None], win[:, 0, 1:17], 0)
    top[:, 8:] = torch.where((at & ~atr)[:, None], top[:, 7:8], top[:, 8:])
    left = torch.where(al[:, None], win[:, 1:9, 0], 0)
    ftl, ft, fl = _filter8_refs(tl, top, left, al, at, atl)
    v = torch.cat([ftl[:, None], ft, fl], 1)
    pred = _linear_pred(v, mode, 8)
    dc = _dc(ft[:, :8].sum(1, dtype=torch.int32),
             fl.sum(1, dtype=torch.int32), al, at, 8)
    pred = torch.where((mode == 2)[:, None], dc[:, None], pred)
    res = _win(res_y, b, y, x, 8, 8)
    _put(yb, b, y, x, torch.clamp(pred.reshape(-1, 8, 8) + res, 0, 255))


def _plane_pred(tl, top, left, n: int):
    """Intra16x16 (n=16) or chroma (n=8) plane prediction (8.3.3.4, 8.3.4.4)."""
    half = n // 2
    te = torch.cat([tl[:, None], top], 1)
    le = torch.cat([tl[:, None], left], 1)
    xs = torch.arange(half, device=top.device)
    h = ((xs + 1) * (te[:, half + 1:n + 1] - te[:, half - 1 - xs])) \
        .sum(1, dtype=torch.int32)
    vv = ((xs + 1) * (le[:, half + 1:n + 1] - le[:, half - 1 - xs])) \
        .sum(1, dtype=torch.int32)
    a = 16 * (left[:, n - 1] + top[:, n - 1])
    k = 5 if n == 16 else 34
    bb = (k * h + 32) >> 6
    c = (k * vv + 32) >> 6
    g = torch.arange(n, device=top.device, dtype=torch.int32) - (half - 1)
    return torch.clamp((a[:, None, None] + bb[:, None, None] * g[None, None, :]
                        + c[:, None, None] * g[None, :, None] + 16) >> 5,
                       0, 255)


def _job_luma16(yb, res_y, b, y, x, mode, mb_avail):
    win = _win(yb, b, y, x, 17, 17)
    al, at = mb_avail[:, 0] > 0, mb_avail[:, 1] > 0
    atl = mb_avail[:, 2] > 0
    tl = torch.where(atl, win[:, 0, 0], 0)
    top = torch.where(at[:, None], win[:, 0, 1:17], 0)
    left = torch.where(al[:, None], win[:, 1:17, 0], 0)
    J = top.shape[0]
    vert = top[:, None, :].expand(J, 16, 16)
    hor = left[:, :, None].expand(J, 16, 16)
    dcv = _dc(top.sum(1, dtype=torch.int32), left.sum(1, dtype=torch.int32),
              al, at, 16)
    dc = dcv[:, None, None].expand(J, 16, 16)
    preds = torch.stack([vert, hor, dc, _plane_pred(tl, top, left, 16)], 1)
    pred = preds[torch.arange(J, device=yb.device), mode.long()]
    res = _win(res_y, b, y, x, 16, 16)
    _put(yb, b, y, x, torch.clamp(pred + res, 0, 255))


def _job_chroma(cbuf, res_c, b, y, x, mode, mb_avail, is_pcm):
    """One chroma plane for all intra kinds (PCM with zero prediction)."""
    win = _win(cbuf, b, y, x, 9, 9)
    al, at = mb_avail[:, 0] > 0, mb_avail[:, 1] > 0
    atl = mb_avail[:, 2] > 0
    tl = torch.where(atl, win[:, 0, 0], 0)
    top = torch.where(at[:, None], win[:, 0, 1:9], 0)
    left = torch.where(al[:, None], win[:, 1:9, 0], 0)
    J = top.shape[0]
    # DC per 4x4 sub-block (spec 8.3.4.1)
    i32 = dict(dtype=torch.int32)
    st = torch.stack([top[:, :4].sum(1, **i32), top[:, 4:].sum(1, **i32)], 1)
    sl = torch.stack([left[:, :4].sum(1, **i32), left[:, 4:].sum(1, **i32)], 1)
    c128 = torch.full_like(st[:, 0], 128)
    dc = torch.empty((J, 8, 8), dtype=torch.int32, device=cbuf.device)
    for by in range(2):
        for bx in range(2):
            t_, l_ = st[:, bx], sl[:, by]
            both = (t_ + l_ + 4) >> 3
            tonly = (t_ + 2) >> 2
            lonly = (l_ + 2) >> 2
            if (bx, by) == (0, 0) or (bx > 0 and by > 0):
                v = torch.where(at & al, both, torch.where(
                    al, lonly, torch.where(at, tonly, c128)))
            elif bx > 0:
                v = torch.where(at, tonly, torch.where(al, lonly, c128))
            else:
                v = torch.where(al, lonly, torch.where(at, tonly, c128))
            dc[:, 4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = v[:, None, None]
    hor = left[:, :, None].expand(J, 8, 8)
    vert = top[:, None, :].expand(J, 8, 8)
    preds = torch.stack([dc, hor, vert, _plane_pred(tl, top, left, 8)], 1)
    pred = preds[torch.arange(J, device=cbuf.device), mode.long()]
    pred = torch.where(is_pcm[:, None, None], 0, pred)
    res = _win(res_c, b, y, x, 8, 8)
    _put(cbuf, b, y, x, torch.clamp(pred + res, 0, 255))


def intra_reconstruct(abi, res_y, res_cb, res_cr, mb_w: int, mb_h: int,
                      init_y=None, init_cb=None, init_cr=None):
    """Run the intra/PCM reconstruction wavefront over [B] streams.

    abi: [B, n, ...] tensors with the keys of models.pipeline.INTRA_ABI_KEYS.
    res_*: [B, H, W] / [B, H/2, W/2] int32 residual planes.
    `init_*` planes carry already reconstructed inter-MB samples (MC
    stage); intra/PCM jobs overwrite their own MBs and may read inter
    neighbours.  Returns (y, cb, cr) int32 planes.
    """
    B = res_y.shape[0]
    dev = res_y.device
    H, W = mb_h * 16, mb_w * 16
    # +1 top/left zero border for edge reads, +8 right for top-right reads
    yb = torch.zeros((B, H + 1, W + 9), dtype=torch.int32, device=dev)
    cbb = torch.zeros((B, H // 2 + 1, W // 2 + 1), dtype=torch.int32,
                      device=dev)
    crb = torch.zeros_like(cbb)
    if init_y is not None:
        yb[:, 1:H + 1, 1:W + 1] = init_y
        cbb[:, 1:, 1:] = init_cb
        crb[:, 1:, 1:] = init_cr
    mb_idx, active = build_schedule(mb_w, mb_h)
    kind_all = abi["kind"]
    for p in range(mb_idx.shape[0]):
        idx = mb_idx[p][active[p]].to(dev)
        P = idx.shape[0]
        b = torch.arange(B, device=dev).repeat_interleave(P)
        m = idx.repeat(B)
        kind = kind_all[b, m]
        mby, mbx = m // mb_w, m % mb_w

        def sel(k):
            s = torch.nonzero(kind == k)[:, 0] if k is not None else \
                torch.nonzero(kind <= KIND_IPCM)[:, 0]
            return s if s.numel() else None

        s = sel(KIND_I16)
        if s is not None:
            _job_luma16(yb, res_y, b[s], mby[s] * 16, mbx[s] * 16,
                        abi["i16_mode"][b[s], m[s]],
                        abi["mb_avail"][b[s], m[s]])
        s = sel(KIND_IPCM)
        if s is not None:
            _put(yb, b[s], mby[s] * 16, mbx[s] * 16,
                 _win(res_y, b[s], mby[s] * 16, mbx[s] * 16, 16, 16))
        s = sel(None)
        if s is not None:
            for cbuf, res_c in ((cbb, res_cb), (crb, res_cr)):
                _job_chroma(cbuf, res_c, b[s], mby[s] * 8, mbx[s] * 8,
                            abi["chroma_mode"][b[s], m[s]],
                            abi["mb_avail"][b[s], m[s]],
                            kind[s] == KIND_IPCM)
        s = sel(KIND_I4x4)
        if s is not None:
            for blocks in _SUBSTEP_BLOCKS:
                r = torch.tensor([y4 * 4 + x4 for x4, y4 in blocks],
                                 device=dev)
                ox = torch.tensor([x4 * 4 for x4, _ in blocks], device=dev)
                oy = torch.tensor([y4 * 4 for _, y4 in blocks], device=dev)
                bs, ms = b[s][:, None], m[s][:, None]
                _job_luma4(yb, res_y, bs.expand(-1, len(blocks)).reshape(-1),
                           (mby[s][:, None] * 16 + oy).reshape(-1),
                           (mbx[s][:, None] * 16 + ox).reshape(-1),
                           abi["i4_modes"][bs, ms, r].reshape(-1),
                           abi["i4_avail"][bs, ms, r].reshape(-1, 4))
        s = sel(KIND_I8x8)
        if s is not None:
            for b8 in range(4):
                _job_luma8(yb, res_y, b[s], mby[s] * 16 + (b8 // 2) * 8,
                           mbx[s] * 16 + (b8 % 2) * 8,
                           abi["i8_modes"][b[s], m[s], b8],
                           abi["i8_avail"][b[s], m[s], b8])
    return yb[:, 1:H + 1, 1:W + 1], cbb[:, 1:, 1:], crb[:, 1:, 1:]
