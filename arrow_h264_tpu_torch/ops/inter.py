"""Inter prediction: quarter-pel MC over precomputed half-pel planes.

Port of `arrow_h264_tpu.ops.inter`.  Each reference picture's half-pel
planes (b horizontal, h vertical, j diagonal; spec 8.4.2.2.1) are computed
once, when the picture is stored into the device DPB (`halfpel_planes`);
per-sample luma MC then reads at most two stored samples and averages
them.  Chroma is 1/8-pel bilinear (8.4.2.2.2).

The DPB is dense uint8: luma [B, S, 4, H + 2*PAD, W + 2*PAD] holding the
(G, b, h, j) planes of each slot, chroma [B, S, 2, H/2 + 2*PADC,
W/2 + 2*PADC].  The planes are edge-padded, and reads clamp to the padded
planes: that is exactly the spec's edge extension for any MV.

`mc_luma_plain` and `mc_chroma_plain` are the plain versions of the MC
kernels (`ops/kernels/mc.py`, `csrc/mc.cu`); `inter_init_plain` (the
weight lookup, `mc_combine`'s weighted / bi-prediction and the residual
add) is the plain version of the inter combine kernel
(`ops/kernels/inter_combine.py`, `csrc/inter_combine.cu`), and
`store_refs_plain` (`halfpel_planes`, `pad_chroma`) that of the
reference store kernel (`ops/kernels/store_ref.py`, `csrc/store_ref.cu`).
"""

from __future__ import annotations

import torch

from .abi import KIND_P
from .transforms import _mb_mask_to_plane, cells_to_plane, mb_to_plane

PAD = 32            # luma padding; chroma uses PAD // 2
PADC = PAD // 2

# plane/offset table per (yf, xf): (plane1, dy1, dx1, plane2, dy2, dx2)
# planes: 0 G, 1 b, 2 h, 3 j  (spec 8.4.2.2.1 quarter-pel positions)
LUMA_TAB = [
    # yf = 0
    [0, 0, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0], [1, 0, 0, 1, 0, 0],
    [1, 0, 0, 0, 0, 1],
    # yf = 1
    [0, 0, 0, 2, 0, 0], [1, 0, 0, 2, 0, 0], [1, 0, 0, 3, 0, 0],
    [1, 0, 0, 2, 0, 1],
    # yf = 2
    [2, 0, 0, 2, 0, 0], [2, 0, 0, 3, 0, 0], [3, 0, 0, 3, 0, 0],
    [3, 0, 0, 2, 0, 1],
    # yf = 3
    [0, 1, 0, 2, 0, 0], [1, 1, 0, 2, 0, 0], [3, 0, 0, 1, 1, 0],
    [1, 1, 0, 2, 0, 1],
]


def edge_pad(p, pad: int):
    """Replicate the border of [..., H, W] by `pad` samples on each side."""
    H, W = p.shape[-2:]
    ys = torch.clamp(torch.arange(-pad, H + pad, device=p.device), 0, H - 1)
    xs = torch.clamp(torch.arange(-pad, W + pad, device=p.device), 0, W - 1)
    return p[..., ys, :][..., xs]


def _tap6(v, dim: int):
    """6-tap (1, -5, 20, 20, -5, 1) along dim; output length = len - 5."""
    n = v.shape[dim]
    taps = (1, -5, 20, 20, -5, 1)
    return sum(c * v.narrow(dim, k, n - 5) for k, c in enumerate(taps))


def halfpel_planes(y_plane):
    """[..., H, W] uint8 (unpadded) -> (G, b, h, j) [..., Hp, Wp] uint8.

    G is the padded integer plane; b/h/j are the spec 8.4.2.2.1 half-pel
    samples aligned so that plane[y + PAD, x + PAD] is the half-pel sample
    at integer position (x, y) (b at (x+0.5, y), h at (x, y+0.5), j at
    (x+0.5, y+0.5)).
    """
    yi = edge_pad(y_plane, PAD + 3).to(torch.int32)
    b1 = _tap6(yi, -1)                          # [Hp+6, Wp+1]
    b = torch.clamp((b1 + 16) >> 5, 0, 255)[..., 3:-3, 1:]
    h1 = _tap6(yi, -2)                          # [Hp+1, Wp+6]
    h = torch.clamp((h1 + 16) >> 5, 0, 255)[..., 1:, 3:-3]
    j1 = _tap6(b1, -2)                          # [Hp+1, Wp+1]
    j = torch.clamp((j1 + 512) >> 10, 0, 255)[..., 1:, 1:]
    G = yi[..., 3:-3, 3:-3]
    return tuple(p.to(torch.uint8) for p in (G, b, h, j))


def pad_chroma(p):
    return edge_pad(p, PADC)


def store_refs_plain(dpb_y_b, dpb_c_b, lanes, slots, y_b, cb_b,
                     cr_b) -> None:
    """Lane lanes[k]'s picture (y_b, cb_b, cr_b [B, ...] uint8) into slot
    slots[k] of its DPB row (dpb_y_b [B, S, 4, Hp, Wp], dpb_c_b [B, S, 2,
    Hcp, Wcp]), in place: the half-pel planes and the padded chroma of
    the storing lanes, with one index assignment per DPB."""
    li, si = (torch.tensor(v, dtype=torch.int64).to(dpb_y_b.device)
              for v in (lanes, slots))
    dpb_y_b[li, si] = torch.stack(halfpel_planes(y_b[li]), 1)
    dpb_c_b[li, si] = torch.stack((pad_chroma(cb_b[li]),
                                   pad_chroma(cr_b[li])), 1)


def _lists(mv, refslot, mb_w: int, mb_h: int, size: int):
    """Per-sample (slot, mvx, mvy) planes [B, 2, Hs, Ws] of both lists."""
    def plane(v):                         # [B, n, 4, 4, 2] -> [B, 2, Hs, Ws]
        return torch.stack([cells_to_plane(v[..., lst], mb_w, mb_h, size)
                            for lst in range(2)], 1)
    return plane(refslot), plane(mv[..., 0]), plane(mv[..., 1])


def mc_luma_plain(dpb_y, mv, refslot, mb_w: int, mb_h: int):
    """Quarter-pel luma prediction of both lists.

    dpb_y [B, S, 4, Hp, Wp] uint8; mv [B, n, 4, 4, 2, 2] int32 (y4, x4,
    list, (x, y)); refslot [B, n, 4, 4, 2] int32 (-1 unused).  Returns
    [B, 2, H, W] uint8; samples of unused lists are 0."""
    B, S, _, Hp, Wp = dpb_y.shape
    H, W = mb_h * 16, mb_w * 16
    dev = dpb_y.device
    slot, mvx, mvy = _lists(mv, refslot, mb_w, mb_h, 4)
    xi = torch.arange(W, device=dev) + (mvx >> 2) + PAD
    yi = torch.arange(H, device=dev)[:, None] + (mvy >> 2) + PAD
    sel = torch.tensor(LUMA_TAB, dtype=torch.int32, device=dev)[
        ((mvy & 3) * 4 + (mvx & 3)).long()]           # [B, 2, H, W, 6]
    base = (torch.arange(B, device=dev)[:, None, None, None] * S
            + torch.clamp(slot, 0, S - 1)).long() * 4
    flat = dpb_y.reshape(-1)

    def fetch(k):
        yy = torch.clamp(yi + sel[..., k + 1], 0, Hp - 1)
        xx = torch.clamp(xi + sel[..., k + 2], 0, Wp - 1)
        return flat[((base + sel[..., k]) * Hp + yy) * Wp + xx].to(torch.int32)

    p1, p2 = fetch(0), fetch(3)
    same = (sel[..., 0:3] == sel[..., 3:6]).all(-1)
    out = torch.where(same, p1, (p1 + p2 + 1) >> 1)
    return torch.where(slot >= 0, out, 0).to(torch.uint8)


def mc_chroma_plain(dpb_c, mv, refslot, cvoff, mb_w: int, mb_h: int):
    """1/8-pel bilinear chroma prediction of both lists and planes.

    dpb_c [B, S, 2, Hcp, Wcp] uint8; cvoff [B, S] int32, the vertical
    chroma offset of each slot in 1/8 samples (spec 8.4.1.4.1: -2 for a
    top field reading a bottom field, +2 for the reverse, else 0), added
    to the vertical MV before it splits into integer and fraction.
    Returns [B, 2 (list), 2 (plane), H/2, W/2] uint8; samples of unused
    lists are 0."""
    B, S, _, Hp, Wp = dpb_c.shape
    Hc, Wc = mb_h * 8, mb_w * 8
    dev = dpb_c.device
    slot, mvx, mvy = _lists(mv, refslot, mb_w, mb_h, 2)
    slot_c = torch.clamp(slot, 0, S - 1)
    mvy = mvy + torch.gather(cvoff, 1, slot_c.reshape(B, -1).long()) \
        .reshape(slot.shape)
    xi = torch.arange(Wc, device=dev) + (mvx >> 3) + PADC
    yi = torch.arange(Hc, device=dev)[:, None] + (mvy >> 3) + PADC
    xf, yf = mvx & 7, mvy & 7
    base = (torch.arange(B, device=dev)[:, None, None, None] * S
            + slot_c).long() * 2
    flat = dpb_c.reshape(-1)
    planes = []
    for pl in range(2):
        def g(dy, dx):
            yy = torch.clamp(yi + dy, 0, Hp - 1)
            xx = torch.clamp(xi + dx, 0, Wp - 1)
            return flat[((base + pl) * Hp + yy) * Wp + xx].to(torch.int32)

        v = ((8 - xf) * (8 - yf) * g(0, 0) + xf * (8 - yf) * g(0, 1) +
             (8 - xf) * yf * g(1, 0) + xf * yf * g(1, 1) + 32) >> 6
        planes.append(torch.where(slot >= 0, v, 0))
    return torch.stack(planes, 2).to(torch.uint8)


def weight_uni_dev(pred, w, o, log_wd):
    """Explicit unidirectional weighting (8.4.2.3.2); unit params = identity."""
    hi = ((pred * w + (1 << torch.clamp(log_wd - 1, min=0))) >> log_wd) + o
    lo = pred * w + o
    return torch.clamp(torch.where(log_wd >= 1, hi, lo), 0, 255)


def weight_bi_dev(p0, p1, w0, w1, o0, o1, log_wd):
    """Weighted bi-prediction; (1, 1, 0, 0, 0) is the default average."""
    v = ((p0 * w0 + p1 * w1 + (1 << log_wd)) >> (log_wd + 1)) + \
        ((o0 + o1 + 1) >> 1)
    return torch.clamp(v, 0, 255)


def mc_combine(pred_y, pred_c, refslot, wp, logwd, mb_w: int, mb_h: int):
    """Weighted / bi-predictive combine of the two lists' predictions.

    pred_y [B, 2, H, W], pred_c [B, 2, 2, H/2, W/2] uint8 (int32 works
    the same: the weights promote them); wp [B, n, 4, 4, 2 (list),
    3 (plane), 2 (w, o)], logwd [B, n, 2 (luma, chroma)].
    Returns (pred_y [B, H, W], pred_cb, pred_cr [B, H/2, W/2]) int32;
    intra-MB regions are garbage (masked by the caller)."""
    used = refslot >= 0

    def combine(p0, p1, plane: int, size: int, logwd_mb):
        cell = lambda v: cells_to_plane(v, mb_w, mb_h, size)
        w0, o0 = cell(wp[..., 0, plane, 0]), cell(wp[..., 0, plane, 1])
        w1, o1 = cell(wp[..., 1, plane, 0]), cell(wp[..., 1, plane, 1])
        lw = mb_to_plane(logwd_mb, mb_w, mb_h, 4 * size)
        both = cell(used[..., 0] & used[..., 1])
        only1 = cell(~used[..., 0])
        return torch.where(both, weight_bi_dev(p0, p1, w0, w1, o0, o1, lw),
                           torch.where(only1, weight_uni_dev(p1, w1, o1, lw),
                                       weight_uni_dev(p0, w0, o0, lw)))

    return (combine(pred_y[:, 0], pred_y[:, 1], 0, 4, logwd[..., 0]),
            combine(pred_c[:, 0, 0], pred_c[:, 1, 0], 1, 2, logwd[..., 1]),
            combine(pred_c[:, 0, 1], pred_c[:, 1, 1], 2, 2, logwd[..., 1]))


def resolve_weights(abi: dict) -> dict:
    """Expand the per-slice weight tables to the per-cell wp [B, n, 4, 4,
    2 (list), 3 (plane), 2 (w, o)] and logwd [B, n, 2] that the MC combine
    reads.  No-op for ABIs that already carry dense wp/logwd."""
    if "wtab" not in abi or "wp" in abi:
        return abi
    sid = abi["slice_id"].long()                                # [B, n]
    r0 = (torch.clamp(abi["refidx"][..., 0], -1, 31) + 1).long()  # [B,n,4,4]
    r1 = (torch.clamp(abi["refidx"][..., 1], -1, 31) + 1).long()
    bi = torch.arange(sid.shape[0], device=sid.device)
    t = abi["wtab"][bi[:, None, None, None], sid[:, :, None, None], r0, r1]
    out = dict(abi)
    out["wp"] = torch.stack([t[..., 0:2], t[..., 2:4]], 4)
    out["logwd"] = abi["slogwd"][bi[:, None], sid]
    return out


def inter_init_plain(abi, pred_y, pred_c, res_y, res_cb, res_cr,
                     mb_w: int, mb_h: int):
    """The init planes of inter MBs: K3's and K4's per-list predictions
    (pred_y [B, 2, H, W], pred_c [B, 2, 2, H/2, W/2] uint8) weighted and
    combined (resolve_weights, mc_combine), plus the residual (res_y [B,
    H, W], res_cb, res_cr [B, H/2, W/2] int32), clipped to 0..255 on inter
    MBs (kind >= KIND_P) and 0 elsewhere.  Returns (init_y, init_cb,
    init_cr) int32."""
    a = resolve_weights(abi)
    pred = mc_combine(pred_y, pred_c, a["refslot"], a["wp"], a["logwd"],
                      mb_w, mb_h)
    is_inter = abi["kind"] >= KIND_P
    out = []
    for p, r, size in zip(pred, (res_y, res_cb, res_cr), (16, 8, 8)):
        inter = _mb_mask_to_plane(is_inter, mb_w, mb_h, size)
        out.append(torch.where(inter, torch.clamp(p + r, 0, 255), 0))
    return tuple(out)


def inter_predict(abi, dpb_y, dpb_c, mb_w: int, mb_h: int):
    """Prediction planes of every inter block with the plain gather MC.

    abi: [B, n, ...] tensors with mv, refslot, cvoff [B, S] and the
    resolved weights wp/logwd (resolve_weights).  Returns
    (pred_y, pred_cb, pred_cr) int32 [B, ...]; intra-MB regions are
    garbage."""
    return mc_combine(
        mc_luma_plain(dpb_y, abi["mv"], abi["refslot"], mb_w, mb_h),
        mc_chroma_plain(dpb_c, abi["mv"], abi["refslot"], abi["cvoff"],
                        mb_w, mb_h),
        abi["refslot"], abi["wp"], abi["logwd"], mb_w, mb_h)
