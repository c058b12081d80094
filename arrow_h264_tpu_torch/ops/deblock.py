"""In-loop deblocking (spec 8.7) in plain PyTorch.

Port of `arrow_h264_tpu.ops.deblock`.  `deblock_tables` computes every
edge's bS, tc0, alpha and beta for the whole frame in one parallel pass;
it depends only on coding data.  It is the plain version of the table
kernel K7 (`ops/kernels/deblock_tables.py`, `csrc/deblock_tables.cu`),
which the pipeline calls: CUDA tensors go through the kernel, CPU ones
through this function.
`deblock_filter_planes` then filters samples along the knight-move
wavefront (phase = 2*mb_y + mb_x): an MB depends on its left, top and
top-right neighbours, all in earlier phases.  It is the plain version of
the deblock kernel (`ops/kernels/deblock_phase.py`, `csrc/deblock_phase.cu`).
`deblock_planes` is the two together, the counterpart of the JAX
package's `deblock_planes`.

All tensors carry a leading stream axis: ABI [B, n, ...], planes [B, H, W].
Frame pictures and field pictures (PAFF; not MBAFF): a field picture
filters like a frame, and only its bS differs (`deblock_tables(field=
True)`).
"""

from __future__ import annotations

import torch

from ..common.tables import (
    ALPHA_TABLE, BETA_TABLE, CHROMA_QP_TABLE, TC0_TABLE,
)

from .intra import build_schedule
from .transforms import device_copy

_ALPHA = torch.tensor(ALPHA_TABLE, dtype=torch.int32)
_BETA = torch.tensor(BETA_TABLE, dtype=torch.int32)
_TC0 = torch.tensor(TC0_TABLE, dtype=torch.int32)          # [3, 52]
_CQP = torch.tensor(CHROMA_QP_TABLE, dtype=torch.int32)

# deblock_tables's keys and each table's shape per MB (after [B, n])
TABLE_SHAPES = {"bs_v": (4, 4), "tc_v": (4, 4), "a_v": (4,), "b_v": (4,),
                "bs_h": (4, 4), "tc_h": (4, 4), "a_h": (4,), "b_h": (4,),
                "bs_c": (2, 2, 4), "tc_c": (2, 2, 4, 2), "a_c": (2, 2, 2),
                "b_c": (2, 2, 2)}
TABLE_KEYS = tuple(TABLE_SHAPES)


def _mv_far(a, b, limit_y: int):
    """a, b [..., 2] qpel MVs -> bool: they differ by 4 or more quarter
    samples horizontally, or `limit_y` or more vertically."""
    return ((a[..., 0] - b[..., 0]).abs() >= 4) | \
        ((a[..., 1] - b[..., 1]).abs() >= limit_y)


def _bs_pair(ip, iq, mb_edge: bool, nzp, nzq, refp, refq, mvp, mvq,
             field: bool, horiz: bool):
    """Boundary strength (spec 8.7.2.1), over [...].

    refp/refq [..., 2] picture ids (-1 unused); mvp/mvq [..., 2, 2].  In
    a field picture the MVs are in quarter FIELD samples, so the vertical
    limit of 4 quarter frame samples is 2 (the clause's NOTE), and intra
    MBs give bS 3, not 4, on horizontal MB edges."""
    limit_y = 2 if field else 4
    n_p = (refp >= 0).sum(-1)
    n_q = (refq >= 0).sum(-1)
    sets_eq = (torch.minimum(refp[..., 0], refp[..., 1]) ==
               torch.minimum(refq[..., 0], refq[..., 1])) & \
              (torch.maximum(refp[..., 0], refp[..., 1]) ==
               torch.maximum(refq[..., 0], refq[..., 1]))
    # single MV: the used list
    p_use0 = (refp[..., 0] >= 0)[..., None]
    q_use0 = (refq[..., 0] >= 0)[..., None]
    mv1p = torch.where(p_use0, mvp[..., 0, :], mvp[..., 1, :])
    mv1q = torch.where(q_use0, mvq[..., 0, :], mvq[..., 1, :])
    far1 = _mv_far(mv1p, mv1q, limit_y)
    # two MVs: two pairings
    straight = _mv_far(mvp[..., 0, :], mvq[..., 0, :], limit_y) | \
        _mv_far(mvp[..., 1, :], mvq[..., 1, :], limit_y)
    crossed = _mv_far(mvp[..., 0, :], mvq[..., 1, :], limit_y) | \
        _mv_far(mvp[..., 1, :], mvq[..., 0, :], limit_y)
    same_ref_pair = refp[..., 0] == refp[..., 1]
    # distinct refs: match q's order to p's by picture id
    q_matches = refq[..., 0] == refp[..., 0]
    far2 = torch.where(same_ref_pair, straight & crossed,
                       torch.where(q_matches, straight, crossed))
    far = torch.where(n_p == 1, far1, (n_p == 2) & far2)
    mv_bs = ((n_p != n_q) | ~sets_eq | far).to(torch.int32)
    bs = torch.where(nzp | nzq, 2, mv_bs)
    return torch.where(ip | iq,
                       4 if mb_edge and not (field and horiz) else 3, bs)


def deblock_tables(abi, mb_w: int, mb_h: int, cqp_off=(0, 0),
                   field: bool = False):
    """Per-edge bS / tc0 / alpha / beta for the whole picture; field: the
    picture is a field (_bs_pair).

    Returns a dict of int32 tensors (edge e, segment s, direction d = 0
    vertical / 1 horizontal, plane pl):
      bs_v/bs_h, tc_v/tc_h [B, n, 4(e), 4(s)]; a_v/a_h/b_v/b_h [B, n, 4(e)];
      bs_c [B, n, 2(d), 2(e), 4(s)]; tc_c [B, n, 2(d), 2(e), 4(s), 2(pl)];
      a_c/b_c [B, n, 2(d), 2(e), 2(pl)].
    Edges that are not filtered (picture border, disable_idc, slice
    border under idc 2, internal 4-sample edges of 8x8-transform MBs)
    have bS 0.
    """
    B = abi["kind"].shape[0]
    dev = abi["kind"].device
    n = mb_w * mb_h
    g = (B, mb_h, mb_w)
    is_intra = (abi["kind"] <= 3).reshape(g)
    nz = (abi["nz"] > 0).reshape(g + (4, 4))
    mv = abi["mv"].reshape(g + (4, 4, 2, 2))
    ref = abi["refid"].reshape(g + (4, 4, 2))
    qp = abi["qp"].reshape(g)
    sid = abi["slice_id"].reshape(g)
    dis = abi["disable_idc"].reshape(g)
    a_off = abi["alpha_off"].reshape(g)
    b_off = abi["beta_off"].reshape(g)
    tr8 = (abi["tr8"] > 0).reshape(g)
    alpha_t, beta_t, tc0_t, cqp_t = (device_copy(t, dev)
                                     for t in (_ALPHA, _BETA, _TC0, _CQP))

    def shift_left(a):   # value of MB (my, mx-1); column 0 is masked
        return torch.cat([a[:, :, :1], a[:, :, :-1]], 2)

    def shift_up(a):
        return torch.cat([a[:, :1], a[:, :-1]], 1)

    do_any = dis != 1
    col = torch.arange(mb_w, device=dev)
    row = torch.arange(mb_h, device=dev)
    left_ok = do_any & (col[None, None, :] > 0) & \
        ~((dis == 2) & (shift_left(sid) != sid))
    top_ok = do_any & (row[None, :, None] > 0) & \
        ~((dis == 2) & (shift_up(sid) != sid))

    def idx_ab(qp_p, qp_q):
        qpav = (qp_p + qp_q + 1) >> 1
        return (torch.clamp(qpav + a_off, 0, 51),
                torch.clamp(qpav + b_off, 0, 51))

    def one_dir(horiz: bool):
        # block (e, s) of the MB: row e of blocks for horizontal edges,
        # column e for vertical ones
        if horiz:
            sh, ok_edge0 = shift_up, top_ok
            blk = lambda a, e: a[:, :, :, e]
        else:
            sh, ok_edge0 = shift_left, left_ok
            blk = lambda a, e: a[:, :, :, :, e]
        bs_l, tc_l, a_l, b_l = [], [], [], []
        for e in range(4):
            mb_edge = e == 0
            if mb_edge:
                p = lambda a: sh(blk(a, 3))
                p_i, qp_p, mask = sh(is_intra), sh(qp), ok_edge0
            else:
                p = lambda a, e=e: blk(a, e - 1)
                p_i, qp_p = is_intra, qp
                mask = do_any & (~tr8 if e != 2 else True)
            bs = _bs_pair(p_i[..., None], is_intra[..., None], mb_edge,
                          p(nz), blk(nz, e), p(ref), blk(ref, e),
                          p(mv), blk(mv, e), field, horiz)
            bs = torch.where(mask[..., None], bs, 0)
            ia, ib = idx_ab(qp_p, qp)
            bs_l.append(bs)
            tc_l.append(tc0_t[torch.clamp(bs - 1, 0, 2), ia[..., None]])
            a_l.append(alpha_t[ia])
            b_l.append(beta_t[ib])
        return (torch.stack(bs_l, 3).reshape(B, n, 4, 4),
                torch.stack(tc_l, 3).reshape(B, n, 4, 4),
                torch.stack(a_l, 3).reshape(B, n, 4),
                torch.stack(b_l, 3).reshape(B, n, 4))

    bs_v, tc_v, a_v, b_v = one_dir(False)
    bs_h, tc_h, a_h, b_h = one_dir(True)

    # chroma edges are luma edges 0 and 8 (indices 0 and 2)
    bs_c = torch.stack([bs_v[:, :, 0::2], bs_h[:, :, 0::2]], 2)  # [B,n,2,2,4]
    tc_c, a_c, b_c = [], [], []
    for d, qp_nb in ((0, shift_left(qp)), (1, shift_up(qp))):
        tcs, as_, bs_ = [], [], []
        for e in range(2):
            qpp = qp_nb if e == 0 else qp
            tce, ae, be = [], [], []
            for pl in range(2):
                qpc_p = cqp_t[torch.clamp(qpp + cqp_off[pl], 0, 51)]
                qpc_q = cqp_t[torch.clamp(qp + cqp_off[pl], 0, 51)]
                ia, ib = idx_ab(qpc_p, qpc_q)
                ae.append(alpha_t[ia])
                be.append(beta_t[ib])
                bs_here = bs_c[:, :, d, e].reshape(g + (4,))
                tce.append(tc0_t[torch.clamp(bs_here - 1, 0, 2),
                                 ia[..., None]])
            tcs.append(torch.stack(tce, -1))        # [B,mbh,mbw,4,2]
            as_.append(torch.stack(ae, -1))         # [B,mbh,mbw,2]
            bs_.append(torch.stack(be, -1))
        tc_c.append(torch.stack(tcs, 3))            # [B,mbh,mbw,2,4,2]
        a_c.append(torch.stack(as_, 3))             # [B,mbh,mbw,2,2]
        b_c.append(torch.stack(bs_, 3))
    return {"bs_v": bs_v, "tc_v": tc_v, "a_v": a_v, "b_v": b_v,
            "bs_h": bs_h, "tc_h": tc_h, "a_h": a_h, "b_h": b_h,
            "bs_c": bs_c,
            "tc_c": torch.stack(tc_c, 3).reshape(B, n, 2, 2, 4, 2),
            "a_c": torch.stack(a_c, 3).reshape(B, n, 2, 2, 2),
            "b_c": torch.stack(b_c, 3).reshape(B, n, 2, 2, 2)}


def _filter_luma(p, q, bs, tc0, alpha, beta):
    """p [..., 4] = (p3, p2, p1, p0), q [..., 4] = (q0..q3); bs, tc0,
    alpha, beta broadcast to p[..., 0].  Spec 8.7.2.3 / 8.7.2.4."""
    p3, p2, p1, p0 = p.unbind(-1)
    q0, q1, q2, q3 = q.unbind(-1)
    filt = (bs > 0) & ((p0 - q0).abs() < alpha) & \
        ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta
    # bS < 4
    tc = tc0 + ap.int() + aq.int()
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0_w = torch.clamp(p0 + delta, 0, 255)
    nq0_w = torch.clamp(q0 - delta, 0, 255)
    avg = (p0 + q0 + 1) >> 1
    np1_w = torch.where(ap, p1 + torch.clamp((p2 + avg - (p1 << 1)) >> 1,
                                             -tc0, tc0), p1)
    nq1_w = torch.where(aq, q1 + torch.clamp((q2 + avg - (q1 << 1)) >> 1,
                                             -tc0, tc0), q1)
    # bS == 4
    strong = (p0 - q0).abs() < ((alpha >> 2) + 2)
    sp_ = strong & ap
    np0_s = torch.where(sp_, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                        (2 * p1 + p0 + q1 + 2) >> 2)
    np1_s = torch.where(sp_, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    np2_s = torch.where(sp_, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq_ = strong & aq
    nq0_s = torch.where(sq_, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                        (2 * q1 + q0 + p1 + 2) >> 2)
    nq1_s = torch.where(sq_, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    nq2_s = torch.where(sq_, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    is4 = bs == 4

    def pick(s_, w_, orig):
        return torch.where(filt, torch.where(is4, s_, w_), orig)

    return (torch.stack([p3, pick(np2_s, p2, p2), pick(np1_s, np1_w, p1),
                         pick(np0_s, np0_w, p0)], -1),
            torch.stack([pick(nq0_s, nq0_w, q0), pick(nq1_s, nq1_w, q1),
                         pick(nq2_s, q2, q2), q3], -1))


def _filter_chroma(p, q, bs, tc0, alpha, beta):
    """p [..., 2] = (p1, p0), q [..., 2] = (q0, q1)."""
    p1, p0 = p.unbind(-1)
    q0, q1 = q.unbind(-1)
    filt = (bs > 0) & ((p0 - q0).abs() < alpha) & \
        ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)
    tc = tc0 + 1
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    is4 = bs == 4
    np0 = torch.where(is4, (2 * p1 + p0 + q1 + 2) >> 2,
                      torch.clamp(p0 + delta, 0, 255))
    nq0 = torch.where(is4, (2 * q1 + q0 + p1 + 2) >> 2,
                      torch.clamp(q0 - delta, 0, 255))
    return (torch.stack([p1, torch.where(filt, np0, p0)], -1),
            torch.stack([torch.where(filt, nq0, q0), q1], -1))


def _edge(buf, b, y, x, horiz: bool, length: int, half: int, filt, *args):
    """Filter one edge of J MBs in place.  The window spans `length`
    samples along the edge and 2*half across it, starting at buffer
    coords (y, x); args are per-sample [J, length] parameters."""
    ar_l = torch.arange(length, device=buf.device)
    ar_k = torch.arange(2 * half, device=buf.device)
    if horiz:
        ys = y[:, None, None] + ar_k[None, None, :]
        xs = x[:, None, None] + ar_l[None, :, None]
    else:
        ys = y[:, None, None] + ar_l[None, :, None]
        xs = x[:, None, None] + ar_k[None, None, :]
    bb = b[:, None, None]
    win = buf[bb, ys, xs]                              # [J, length, 2*half]
    fp, fq = filt(win[..., :half], win[..., half:], *args)
    buf[bb, ys, xs] = torch.cat([fp, fq], -1)


def deblock_filter_planes(y, cb, cr, tables, mb_w: int, mb_h: int):
    """Filter [B] streams' planes with precomputed deblock_tables.

    y [B, H, W], cb/cr [B, H/2, W/2] int values 0..255.  Returns filtered
    int32 planes.  Per MB: 4 vertical then 4 horizontal luma edges, and
    2 + 2 edges per chroma plane."""
    B = y.shape[0]
    dev = y.device
    H, W = mb_h * 16, mb_w * 16
    # a 4-sample (chroma: 2-sample) top/left border keeps the windows of
    # picture-border edges (bS 0, filtered to themselves) in bounds
    yp = torch.zeros((B, H + 4, W + 4), dtype=torch.int32, device=dev)
    yp[:, 4:, 4:] = y
    cps = []
    for c in (cb, cr):
        cp = torch.zeros((B, H // 2 + 2, W // 2 + 2), dtype=torch.int32,
                         device=dev)
        cp[:, 2:, 2:] = c
        cps.append(cp)
    t = tables
    mb_idx, active = build_schedule(mb_w, mb_h)
    seg4 = torch.arange(16, device=dev) // 4
    seg2 = torch.arange(8, device=dev) // 2
    for p in range(mb_idx.shape[0]):
        idx = mb_idx[p][active[p]].to(dev)
        P = idx.shape[0]
        b = torch.arange(B, device=dev).repeat_interleave(P)
        m = idx.repeat(B)
        y0, x0 = (m // mb_w) * 16, (m % mb_w) * 16
        for horiz, k in ((False, "v"), (True, "h")):
            for e in range(4):
                bs = t["bs_" + k][b, m, e][:, seg4]
                tc0 = t["tc_" + k][b, m, e][:, seg4]
                al = t["a_" + k][b, m, e][:, None]
                be = t["b_" + k][b, m, e][:, None]
                ey, ex = (y0 + 4 * e, x0 + 4) if horiz else \
                    (y0 + 4, x0 + 4 * e)
                _edge(yp, b, ey, ex, horiz, 16, 4, _filter_luma,
                      bs, tc0, al, be)
        d_of = {False: 0, True: 1}
        for pl, cp in enumerate(cps):
            yc, xc = y0 // 2, x0 // 2
            for horiz in (False, True):
                d = d_of[horiz]
                for e in range(2):
                    bs = t["bs_c"][b, m, d, e][:, seg2]
                    tc0 = t["tc_c"][b, m, d, e, :, pl][:, seg2]
                    al = t["a_c"][b, m, d, e, pl][:, None]
                    be = t["b_c"][b, m, d, e, pl][:, None]
                    ey, ex = (yc + 4 * e, xc + 2) if horiz else \
                        (yc + 2, xc + 4 * e)
                    _edge(cp, b, ey, ex, horiz, 8, 2, _filter_chroma,
                          bs, tc0, al, be)
    return (yp[:, 4:, 4:], cps[0][:, 2:, 2:], cps[1][:, 2:, 2:])


def deblock_planes(abi, y, cb, cr, mb_w: int, mb_h: int, cqp_off=(0, 0)):
    """The full deblocking process of [B] progressive pictures: planes in,
    filtered int32 planes out."""
    return deblock_filter_planes(y, cb, cr,
                                 deblock_tables(abi, mb_w, mb_h, cqp_off),
                                 mb_w, mb_h)
