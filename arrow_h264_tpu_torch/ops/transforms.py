"""Residual stage: dequantisation and inverse transforms (PyTorch).

Port of `arrow_h264_tpu.ops.transforms`: the same integer formulas with
arithmetic shifts, bit-exact with the JAX package and with its numpy
oracle (`arrow_h264_tpu.oracle.transforms`).  Every function takes a
leading stream axis: ABI tensors are [B, n, ...] and planes [B, H, W].  There is no
dependency between macroblocks here, so this stays plain PyTorch on every
device.

`ws*` constants come from `make_ws_consts` and are already LevelScale
(weightScale x normAdjust, spec 8.5.9).
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.tables import (
    CHROMA_QP_TABLE, NORM_ADJUST_4x4, NORM_ADJUST_8x8, ZIGZAG_4x4, ZIGZAG_8x8,
)
from .abi import KIND_I4x4, KIND_I8x8, KIND_I16, KIND_IPCM

_CQP = torch.tensor(CHROMA_QP_TABLE, dtype=torch.int32)
_on_device: dict = {}


def device_copy(t, device):
    """The module constant `t` on `device`, copied once per device: a
    copy from pageable host memory at every call would wait for the
    device's queue to drain."""
    key = (id(t), device)
    if key not in _on_device:
        _on_device[key] = t.to(device)
    return _on_device[key]

# coefficient classes the upload may leave out when they are all zero in
# the frame (residual_planes then skips their dequant/IDCT path)
COEFF_KEYS = ("luma4", "luma8", "luma_dc", "chroma_dc", "chroma_ac", "pcm")


def _pos(t):
    return torch.clamp(t, min=0)


def dequant4x4_dev(c, qp, level_scale):
    """Spec 8.5.12.1.  c [..., 4, 4] int32, qp broadcastable to c[..., 0, 0],
    level_scale [..., 4, 4] already selected for qp % 6."""
    q6 = (qp // 6)[..., None, None]
    hi = (c * level_scale) << _pos(q6 - 4)
    lo = (c * level_scale + (1 << _pos(3 - q6))) >> _pos(4 - q6)
    return torch.where((qp >= 24)[..., None, None], hi, lo)


def idct4x4_dev(d):
    """[..., 4, 4] int32 -> (h + 32) >> 6, spec 8.5.12.2."""
    def rows(m):
        e0 = m[..., 0] + m[..., 2]
        e1 = m[..., 0] - m[..., 2]
        e2 = (m[..., 1] >> 1) - m[..., 3]
        e3 = m[..., 1] + (m[..., 3] >> 1)
        return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)

    f = rows(d)
    h = rows(f.transpose(-1, -2)).transpose(-1, -2)
    return (h + 32) >> 6


def hadamard4_dev(c):
    """f = H @ c @ H with H rows of +-1 (spec 8.5.10), exact in integers."""
    def h(m):
        a, b, cc, d = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
        return torch.stack([a + b + cc + d, a + b - cc - d,
                            a - b - cc + d, a - b + cc - d], dim=-1)

    return h(h(c).transpose(-1, -2)).transpose(-1, -2)


def luma_dc_dequant_dev(c, qp, ls00_6):
    """Intra16x16 luma DC (spec 8.5.10).  c [..., 4, 4], qp [...],
    ls00_6 [6] (LevelScale4x4(m, 0, 0) for each qp % 6)."""
    f = hadamard4_dev(c)
    ls = ls00_6[qp % 6][..., None, None]
    q6 = (qp // 6)[..., None, None]
    hi = (f * ls) << _pos(q6 - 6)
    lo = (f * ls + (1 << _pos(5 - q6))) >> _pos(6 - q6)
    return torch.where((qp >= 36)[..., None, None], hi, lo)


def chroma_dc_dequant_dev(c, qpc, ls00):
    """2x2 chroma DC (spec 8.5.11).  c [..., 2, 2], qpc [...], ls00 [...]."""
    a, b = c[..., 0, 0], c[..., 0, 1]
    d, e = c[..., 1, 0], c[..., 1, 1]
    f = torch.stack([torch.stack([a + b + d + e, a - b + d - e], -1),
                     torch.stack([a + b - d - e, a - b - d + e], -1)], -2)
    return ((f * ls00[..., None, None]) << (qpc // 6)[..., None, None]) >> 5


def dequant8x8_dev(c, qp, level_scale):
    """Spec 8.5.13.1.  c [..., 8, 8], level_scale [..., 8, 8] selected."""
    q6 = (qp // 6)[..., None, None]
    hi = (c * level_scale) << _pos(q6 - 6)
    lo = (c * level_scale + (1 << _pos(5 - q6))) >> _pos(6 - q6)
    return torch.where((qp >= 36)[..., None, None], hi, lo)


def idct8x8_dev(d):
    """[..., 8, 8] int32, spec 8.5.13.2."""
    def stage(m):
        d0, d1, d2, d3 = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
        d4, d5, d6, d7 = m[..., 4], m[..., 5], m[..., 6], m[..., 7]
        e0 = d0 + d4
        e1 = -d3 + d5 - d7 - (d7 >> 1)
        e2 = d0 - d4
        e3 = d1 + d7 - d3 - (d3 >> 1)
        e4 = (d2 >> 1) - d6
        e5 = -d1 + d7 + d5 + (d5 >> 1)
        e6 = d2 + (d6 >> 1)
        e7 = d3 + d5 + d1 + (d1 >> 1)
        f0 = e0 + e6
        f1 = e1 + (e7 >> 2)
        f2 = e2 + e4
        f3 = e3 + (e5 >> 2)
        f4 = e2 - e4
        f5 = (e3 >> 2) - e5
        f6 = e0 - e6
        f7 = e7 - (e1 >> 2)
        return torch.stack([f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                            f6 - f1, f4 - f3, f2 - f5, f0 - f7], dim=-1)

    f = stage(d)                                          # horizontal
    k = stage(f.transpose(-1, -2)).transpose(-1, -2)      # vertical
    return (k + 32) >> 6


def _grid_to_plane(b, mb_w: int, mb_h: int, g: int, s: int):
    """[B, n, g, g, s, s] (per-MB grid of s x s tiles) -> [B, mb_h*g*s,
    mb_w*g*s]."""
    B = b.shape[0]
    b = b.reshape(B, mb_h, mb_w, g, g, s, s)
    return b.permute(0, 1, 3, 5, 2, 4, 6).reshape(B, mb_h * g * s,
                                                   mb_w * g * s)


def blocks4_to_plane(blocks, mb_w: int, mb_h: int):
    """[B, n, 16, 4, 4] (raster 4x4 blocks) -> [B, 16*mb_h, 16*mb_w]."""
    return _grid_to_plane(blocks, mb_w, mb_h, 4, 4)


def blocks8_to_plane(blocks, mb_w: int, mb_h: int):
    """[B, n, 4, 8, 8] (raster 8x8 blocks) -> [B, 16*mb_h, 16*mb_w]."""
    return _grid_to_plane(blocks, mb_w, mb_h, 2, 8)


def blocks_c_to_plane(blocks, mb_w: int, mb_h: int):
    """[B, n, 2, 2, 4, 4] chroma raster blocks -> [B, 8*mb_h, 8*mb_w]."""
    return _grid_to_plane(blocks, mb_w, mb_h, 2, 4)


def cells_to_plane(cells, mb_w: int, mb_h: int, size: int, g: int = 4):
    """[B, n, g, g] (or [B, n, g*g]) per-block values of each MB's g x g
    block grid -> [B, g*mb_h*size, g*mb_w*size], each block's value
    repeated over its size x size samples."""
    B = cells.shape[0]
    v = cells.reshape(B, mb_h, mb_w, g, g).permute(0, 1, 3, 2, 4)
    v = v.reshape(B, mb_h * g, mb_w * g)
    return v.repeat_interleave(size, 1).repeat_interleave(size, 2)


def mb_to_plane(v, mb_w: int, mb_h: int, size: int):
    """[B, n] per-MB values -> [B, mb_h*size, mb_w*size]."""
    m = v.reshape(v.shape[0], mb_h, mb_w)
    return m.repeat_interleave(size, 1).repeat_interleave(size, 2)


def _mb_mask_to_plane(mask, mb_w: int, mb_h: int, size: int):
    """[B, n] -> [B, mb_h*size, mb_w*size] bool."""
    return mb_to_plane(mask.bool(), mb_w, mb_h, size)


def _pcm_luma_blocks(pcm):
    """[B, n, 384] -> [B, n, 16, 4, 4] raster 4x4 blocks of the luma samples."""
    B, n = pcm.shape[:2]
    y = pcm[..., :256].reshape(B, n, 4, 4, 4, 4)   # y4, py, x4, px
    return y.permute(0, 1, 2, 4, 3, 5).reshape(B, n, 16, 4, 4)


def _gather_ls(table6, qp):
    """table6 [6, k, k] -> [..., k, k] selected by qp % 6 ([...])."""
    return table6[qp % 6]


def _tile_cumsum(plane, t: int, axis: int):
    """Per-tile cumulative sum over [B, H, W]: tiles of height (axis=0) or
    width (axis=1) `t`; the FRExt lossless intra DPCM (spec 8.3.5) in
    closed form: vertical DPCM u(i,j) = p(-1,j) + sum_{k<=i} r(k,j) is the
    standard vertical prediction plus a columnwise residual cumsum."""
    B, H, W = plane.shape
    if axis == 0:
        return plane.reshape(B, H // t, t, W).cumsum(2, dtype=torch.int32) \
            .reshape(B, H, W)
    return plane.reshape(B, H, W // t, t).cumsum(3, dtype=torch.int32) \
        .reshape(B, H, W)


def residual_planes(abi, mb_w: int, mb_h: int, ws4, ws8, cqp_off=(0, 0),
                    bypass: bool = False):
    """Whole-frame residual: every MB at once, no dependencies.

    abi: dict of [B, n, ...] int32 tensors (ops.abi layout).  A coefficient
    class in COEFF_KEYS that is absent from the dict is all zero, and its
    dequant/IDCT path is skipped.
    ws4: [6, 6, 4, 4] LevelScale4x4 per list (iY, iCb, iCr, pY, pCb, pCr).
    ws8: [2, 6, 8, 8] LevelScale8x8 (intra Y, inter Y).
    bypass: SPS qpprime_y_zero_transform_bypass_flag.  MBs with QP' == 0
    skip scaling and transform (spec 8.5.15: residual = the parsed levels)
    and vertical/horizontal intra blocks add the DPCM cumsum (spec 8.3.5).
    Returns (res_y [B, H, W], res_cb, res_cr [B, H/2, W/2]) int32; intra
    MBs still need the prediction stage, inter/PCM residuals are final.
    """
    kind = abi["kind"]
    qp = abi["qp"]
    B, n = kind.shape
    dev = kind.device
    H, W = mb_h * 16, mb_w * 16
    i32 = dict(dtype=torch.int32, device=dev)
    is_intra = kind <= KIND_IPCM
    byp_mb = (qp == 0) if bypass else None

    # ---- luma 4x4 path (+ I16 DC)
    if "luma4" in abi or "luma_dc" in abi:
        if "luma4" in abi:
            ls_y = torch.where(is_intra[..., None, None],
                               _gather_ls(ws4[0], qp), _gather_ls(ws4[3], qp))
            d4 = dequant4x4_dev(abi["luma4"], qp[..., None], ls_y[:, :, None])
            raw4 = abi["luma4"].clone() if bypass else None
        else:
            d4 = torch.zeros((B, n, 16, 4, 4), **i32)
            raw4 = torch.zeros((B, n, 16, 4, 4), **i32) if bypass else None
        if "luma_dc" in abi:
            dc = luma_dc_dequant_dev(abi["luma_dc"], qp, ws4[0, :, 0, 0])
            is16 = (kind == KIND_I16)[..., None]
            d4[..., 0, 0] = torch.where(is16, dc.reshape(B, n, 16),
                                        d4[..., 0, 0])
            if bypass:
                raw4[..., 0, 0] = torch.where(
                    is16, abi["luma_dc"].reshape(B, n, 16), raw4[..., 0, 0])
        plane4 = blocks4_to_plane(idct4x4_dev(d4), mb_w, mb_h)
        if bypass:
            byp_y = _mb_mask_to_plane(byp_mb, mb_w, mb_h, 16)
            plane4 = torch.where(byp_y, blocks4_to_plane(raw4, mb_w, mb_h),
                                 plane4)
    else:
        plane4 = torch.zeros((B, H, W), **i32)
    res_y = plane4

    # ---- luma 8x8 path
    if "luma8" in abi:
        ls8 = torch.where(is_intra[..., None, None], _gather_ls(ws8[0], qp),
                          _gather_ls(ws8[1], qp))
        d8 = dequant8x8_dev(abi["luma8"], qp[..., None], ls8[:, :, None])
        plane8 = blocks8_to_plane(idct8x8_dev(d8), mb_w, mb_h)
        if bypass:
            byp_y = _mb_mask_to_plane(byp_mb, mb_w, mb_h, 16)
            plane8 = torch.where(
                byp_y, blocks8_to_plane(abi["luma8"], mb_w, mb_h), plane8)
        tr8_plane = _mb_mask_to_plane(abi["tr8"] > 0, mb_w, mb_h, 16)
        res_y = torch.where(tr8_plane, plane8, plane4)

    # ---- lossless intra DPCM (spec 8.3.5): vertical/horizontal intra
    # blocks of bypass MBs get the per-tile residual cumsum; the intra
    # stage's standard vertical/horizontal prediction then reconstructs
    # u(i,j) = pred + cumsum exactly.
    if bypass:
        i4 = ((kind == KIND_I4x4) & byp_mb)[..., None]
        i8 = ((kind == KIND_I8x8) & byp_mb)[..., None]
        i16 = (kind == KIND_I16) & byp_mb
        m4, m8, m16 = abi["i4_modes"], abi["i8_modes"], abi["i16_mode"]
        for mask, t, axis in (
                (cells_to_plane((m4 == 0) & i4, mb_w, mb_h, 4), 4, 0),
                (cells_to_plane((m4 == 1) & i4, mb_w, mb_h, 4), 4, 1),
                (cells_to_plane((m8 == 0) & i8, mb_w, mb_h, 8, 2), 8, 0),
                (cells_to_plane((m8 == 1) & i8, mb_w, mb_h, 8, 2), 8, 1),
                (_mb_mask_to_plane((m16 == 0) & i16, mb_w, mb_h, 16), 16, 0),
                (_mb_mask_to_plane((m16 == 1) & i16, mb_w, mb_h, 16), 16, 1)):
            res_y = torch.where(mask, _tile_cumsum(res_y, t, axis), res_y)

    # ---- PCM luma (residual = raw samples; prediction stage emits 0)
    if "pcm" in abi:
        pcm_plane = blocks4_to_plane(_pcm_luma_blocks(abi["pcm"]), mb_w, mb_h)
        is_pcm_plane = _mb_mask_to_plane(kind == KIND_IPCM, mb_w, mb_h, 16)
        res_y = torch.where(is_pcm_plane, pcm_plane, res_y)

    # ---- chroma
    cqp = device_copy(_CQP, dev)
    res_c = []
    for pl in range(2):
        if "chroma_ac" in abi or "chroma_dc" in abi:
            qpc = cqp[torch.clamp(qp + cqp_off[pl], 0, 51)]
            if "chroma_ac" in abi:
                ls_c = torch.where(is_intra[..., None, None],
                                   _gather_ls(ws4[1 + pl], qpc),
                                   _gather_ls(ws4[4 + pl], qpc))
                ac = abi["chroma_ac"][:, :, pl].reshape(B, n, 4, 4, 4)
                dca = dequant4x4_dev(ac, qpc[..., None], ls_c[:, :, None])
            else:
                dca = torch.zeros((B, n, 4, 4, 4), **i32)
            if "chroma_dc" in abi:
                ls00 = torch.where(is_intra, ws4[1 + pl, :, 0, 0][qpc % 6],
                                   ws4[4 + pl, :, 0, 0][qpc % 6])
                dcc = chroma_dc_dequant_dev(abi["chroma_dc"][:, :, pl], qpc,
                                            ls00)
                dca[..., 0, 0] = dcc.reshape(B, n, 4)
            rc = idct4x4_dev(dca).reshape(B, n, 2, 2, 4, 4)
            plane_c = blocks_c_to_plane(rc, mb_w, mb_h)
            if bypass:
                # raw levels (2x2 DC Hadamard bypassed too, spec 8.5.15)
                if "chroma_ac" in abi:
                    rawc = abi["chroma_ac"][:, :, pl].reshape(B, n, 4, 4, 4) \
                        .clone()
                else:
                    rawc = torch.zeros((B, n, 4, 4, 4), **i32)
                if "chroma_dc" in abi:
                    rawc[..., 0, 0] = abi["chroma_dc"][:, :, pl].reshape(B, n,
                                                                         4)
                raw_plane = blocks_c_to_plane(rawc.reshape(B, n, 2, 2, 4, 4),
                                              mb_w, mb_h)
                byp_c = _mb_mask_to_plane(byp_mb, mb_w, mb_h, 8)
                plane_c = torch.where(byp_c, raw_plane, plane_c)
                # chroma intra DPCM: mode 1 = horizontal, 2 = vertical,
                # over the whole 8x8 chroma MB (chroma pred is per MB)
                cm = abi["chroma_mode"]
                ok = is_intra & byp_mb & (kind != KIND_IPCM)
                vm = _mb_mask_to_plane((cm == 2) & ok, mb_w, mb_h, 8)
                hm = _mb_mask_to_plane((cm == 1) & ok, mb_w, mb_h, 8)
                plane_c = torch.where(vm, _tile_cumsum(plane_c, 8, 0),
                                      plane_c)
                plane_c = torch.where(hm, _tile_cumsum(plane_c, 8, 1),
                                      plane_c)
        else:
            plane_c = torch.zeros((B, H // 2, W // 2), **i32)
        if "pcm" in abi:
            pc = abi["pcm"][..., 256 + 64 * pl:256 + 64 * (pl + 1)]
            pc = pc.reshape(B, n, 2, 4, 2, 4).permute(0, 1, 2, 4, 3, 5)
            pcm_c = blocks_c_to_plane(pc, mb_w, mb_h)
            is_pcm_c = _mb_mask_to_plane(kind == KIND_IPCM, mb_w, mb_h, 8)
            plane_c = torch.where(is_pcm_c, pcm_c, plane_c)
        res_c.append(plane_c)
    return res_y, res_c[0], res_c[1]


def weight_scale_raster_4x4(weight_scale_zz) -> np.ndarray:
    ws = np.zeros((4, 4), np.int32)
    for k, pos in enumerate(ZIGZAG_4x4):
        ws[pos // 4, pos % 4] = weight_scale_zz[k]
    return ws


def weight_scale_raster_8x8(weight_scale_zz) -> np.ndarray:
    ws = np.zeros((8, 8), np.int32)
    for k, pos in enumerate(ZIGZAG_8x8):
        ws[pos // 8, pos % 8] = weight_scale_zz[k]
    return ws


def make_ws_consts(scaling_4x4, scaling_8x8):
    """Scaling lists (zig-zag order) -> LevelScale constants.

    Returns (ws4 [6, 6, 4, 4], ws8 [2, 6, 8, 8]) int32 CPU tensors:
    LevelScale(m, i, j) = weightScale(i, j) * normAdjust(m, i, j)
    (spec 8.5.9).
    """
    ws4 = np.zeros((6, 6, 4, 4), np.int32)
    for i in range(6):
        ws4[i] = weight_scale_raster_4x4(scaling_4x4[i])[None] \
            * NORM_ADJUST_4x4
    ws8 = np.zeros((2, 6, 8, 8), np.int32)
    for i in range(min(2, len(scaling_8x8))):
        ws8[i] = weight_scale_raster_8x8(scaling_8x8[i])[None] \
            * NORM_ADJUST_8x8
    return torch.from_numpy(ws4), torch.from_numpy(ws8)
