"""The decode pipeline: frame ABI -> reconstructed planes (PyTorch).

Port of `arrow_h264_tpu.models.pipeline`.  Per frame, on the device:

    residual (dequant + IDCT) -> inter MC (kernels K3/K4) + weighted
    combine -> intra (kernel K1) -> deblock tables -> deblock (kernel K2)

then `store_ref_fn` writes each reference picture's half-pel planes into
its slot of the device DPB.  With order="raster" the intra and deblock
stages run the raster-order kernels K5/K6 in place of K1/K2; every other
stage is the same.  Every function takes a leading stream axis [B, ...];
the single-stream `DevicePipeline` runs B = 1.

The host ships the dense ABI (`ABI_DEVICE_KEYS`) with
`torch.from_numpy(...).to(device)`; coefficient classes that are all zero
in the frame stay on the host and their residual paths are skipped.  A
frame runs one of two modes: no inter MBs (no MC) or inter.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream.params import PPS, SPS
from ..ops.abi import KIND_P
from ..ops.deblock import deblock_tables
from ..ops.inter import PAD, PADC, halfpel_planes, mc_combine, pad_chroma
from ..ops.kernels.deblock_phase import deblock_phase
from ..ops.kernels.deblock_raster import deblock_raster
from ..ops.kernels.intra_phase import intra_phase
from ..ops.kernels.intra_raster import intra_raster
from ..ops.kernels.mc import mc_chroma, mc_luma
from ..ops.transforms import (
    COEFF_KEYS, _mb_mask_to_plane, make_ws_consts, residual_planes,
)

ABI_DEVICE_KEYS = (
    "kind", "qp", "luma4", "luma8", "luma_dc", "chroma_dc", "chroma_ac",
    "i4_modes", "i8_modes", "i16_mode", "chroma_mode", "i4_avail", "i8_avail",
    "mb_avail", "pcm", "nz", "tr8", "slice_id", "disable_idc", "alpha_off",
    "beta_off", "mv", "refid", "refslot", "refidx", "wtab", "slogwd",
)

# order -> (intra, deblock) kernel wrappers; both pairs share one contract
ORDERS = {"phase": (intra_phase, deblock_phase),
          "raster": (intra_raster, deblock_raster)}


def upload_abi(abi, device) -> dict:
    """Host FrameABI -> dict of device tensors (no stream axis).

    All-zero coefficient classes are left out (residual_planes skips
    them).  A frame with dense per-cell weights (abi["wp"], the slice-row
    overflow fallback of ops.abi) ships those instead of the tables."""
    dense_w = "wp" in abi
    keys = [k for k in ABI_DEVICE_KEYS
            if not (dense_w and k in ("wtab", "slogwd"))]
    if dense_w:
        keys += ["wp", "logwd"]
    out = {}
    for k in keys:
        a = np.asarray(abi[k])
        if k in COEFF_KEYS and not a.any():
            continue
        a = np.require(a, dtype=np.int32, requirements=("C", "W"))
        out[k] = torch.from_numpy(a).to(device)
    return out


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


def dpb_alloc(mb_w: int, mb_h: int, n_slots: int, device):
    """Dense device DPB: luma [S, 4, H + 2*PAD, W + 2*PAD] (G, b, h, j
    planes) and chroma [S, 2, H/2 + 2*PADC, W/2 + 2*PADC] uint8."""
    H, W = mb_h * 16, mb_w * 16
    return (torch.zeros((n_slots, 4, H + 2 * PAD, W + 2 * PAD),
                        dtype=torch.uint8, device=device),
            torch.zeros((n_slots, 2, H // 2 + 2 * PADC, W // 2 + 2 * PADC),
                        dtype=torch.uint8, device=device))


def _mc_pred(abi: dict, dpb_y, dpb_c, mb_w: int, mb_h: int):
    """Inter prediction planes (pred_y, pred_cb, pred_cr) [B, ...] int32:
    K3/K4 (mc_luma, mc_chroma) predict each list as uint8, and
    mc_combine weights and averages the lists in int32."""
    a = resolve_weights(abi)
    return mc_combine(mc_luma(dpb_y, a["mv"], a["refslot"], mb_w, mb_h),
                      mc_chroma(dpb_c, a["mv"], a["refslot"], mb_w, mb_h),
                      a["refslot"], a["wp"], a["logwd"], mb_w, mb_h)


def decode_frames_batch_fn(abi_b: dict, dpb_y_b, dpb_c_b, *, mb_w: int,
                           mb_h: int, ws4, ws8, cqp_off, inter: bool,
                           bypass: bool = False, order: str = "phase"):
    """[B] frames: ABI tensors [B, n, ...] + DPBs [B, S, ...] -> (y, cb,
    cr) uint8 [B, H, W] / [B, H/2, W/2].  inter: whether any MB of the
    batch is inter (else MC is skipped).  order: "phase" runs the
    knight-move wavefront kernels K1/K2, "raster" the raster-order kernels
    K5/K6 (ORDERS)."""
    intra, deblock = ORDERS[order]
    res_y, res_cb, res_cr = residual_planes(abi_b, mb_w, mb_h, ws4, ws8,
                                            cqp_off, bypass=bypass)
    init = (None, None, None)
    if inter:
        pred_y, pred_cb, pred_cr = _mc_pred(abi_b, dpb_y_b, dpb_c_b,
                                            mb_w, mb_h)
        is_inter = abi_b["kind"] >= KIND_P
        inter_y = _mb_mask_to_plane(is_inter, mb_w, mb_h, 16)
        inter_c = _mb_mask_to_plane(is_inter, mb_w, mb_h, 8)
        init = (torch.where(inter_y, torch.clamp(pred_y + res_y, 0, 255), 0),
                torch.where(inter_c, torch.clamp(pred_cb + res_cb, 0, 255),
                            0),
                torch.where(inter_c, torch.clamp(pred_cr + res_cr, 0, 255),
                            0))
    y, cb, cr = intra(abi_b, res_y, res_cb, res_cr, *init, mb_w, mb_h)
    tables = deblock_tables(abi_b, mb_w, mb_h, cqp_off)
    return deblock(y, cb, cr, tables, mb_w, mb_h)


def decode_frame_fn(abi: dict, dpb_y, dpb_c, **kw):
    """One frame: ABI tensors [n, ...] + DPB [S, ...] -> (y, cb, cr) uint8."""
    out = decode_frames_batch_fn({k: v[None] for k, v in abi.items()},
                                 dpb_y[None], dpb_c[None], **kw)
    return tuple(p[0] for p in out)


def store_ref_fn(dpb_y, dpb_c, slot: int, y, cb, cr) -> None:
    """Write a reference picture's half-pel planes and padded chroma into
    DPB slot `slot`, in place (dpb_y [S, 4, Hp, Wp], dpb_c [S, 2, ...])."""
    dpb_y[slot] = torch.stack(halfpel_planes(y))
    dpb_c[slot, 0] = pad_chroma(cb)
    dpb_c[slot, 1] = pad_chroma(cr)


class DevicePipeline:
    """Per (sps, pps) frame reconstruction + the device DPB slots."""

    def __init__(self, sps: SPS, pps: PPS, device, order: str = "phase"):
        if order not in ORDERS:
            raise ValueError(f"order {order!r}: expected one of "
                             f"{sorted(ORDERS)}")
        if not sps.frame_mbs_only_flag:
            raise NotImplementedError(
                "interlaced SPS (field pictures) is not ported yet")
        self.sps, self.pps = sps, pps
        self.device = torch.device(device)
        self.mb_w, self.mb_h = sps.pic_width_in_mbs, sps.pic_height_in_map_units
        sl4 = pps.scaling_lists_4x4 if pps.scaling_lists_4x4 is not None \
            else sps.scaling_lists_4x4
        sl8 = pps.scaling_lists_8x8 if pps.scaling_lists_8x8 is not None \
            else sps.scaling_lists_8x8
        ws4, ws8 = make_ws_consts(sl4, sl8)
        self._kw = dict(
            mb_w=self.mb_w, mb_h=self.mb_h, ws4=ws4.to(self.device),
            ws8=ws8.to(self.device),
            cqp_off=(pps.chroma_qp_index_offset, pps.chroma_qp_offset(1)),
            bypass=bool(sps.qpprime_y_zero_transform_bypass_flag),
            order=order)
        self.n_slots = max(2, min(sps.max_num_ref_frames, 32) + 1)
        self.dpb_y, self.dpb_c = dpb_alloc(self.mb_w, self.mb_h,
                                           self.n_slots, self.device)

    def decode_frame(self, abi):
        """Host FrameABI -> (y, cb, cr) uint8 device planes (uncropped)."""
        inter = bool((np.asarray(abi["kind"]) >= KIND_P).any())
        return decode_frame_fn(upload_abi(abi, self.device), self.dpb_y,
                               self.dpb_c, inter=inter, **self._kw)

    def store_ref(self, slot: int, y, cb, cr) -> None:
        store_ref_fn(self.dpb_y, self.dpb_c, slot, y, cb, cr)
