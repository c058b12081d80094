"""The decode pipeline: frame ABI -> reconstructed planes (PyTorch).

Port of `arrow_h264_tpu.models.pipeline`.  Per frame, on the device:

    residual (dequant + IDCT) -> inter MC (kernels K3/K4) + weighted
    combine -> intra (kernel K1) -> deblock tables -> deblock (kernel K2)

then `store_ref_fn` writes each reference picture's half-pel planes into
its slot of the device DPB.  With order="raster" the intra and deblock
stages run the raster-order kernels K5/K6 in place of K1/K2; every other
stage is the same.  Every function takes a leading stream axis [B, ...];
the single-stream `DevicePipeline` runs B = 1.

Field pictures (all-field PAFF) take the same path at field height: each
reference field has its own DPB slot, K4 reads a per-slot vertical chroma
offset for references of the other parity (`cvoff`), and the deblock
tables follow the field rules (`deblock_tables(field=True)`).

The host ships the dense ABI (`ABI_DEVICE_KEYS`) through pinned staging
tensors (`upload_batch`, one per lane of a batch); coefficient classes
that are all zero in every lane stay on the host and their residual paths
are skipped.  A batch runs one of two modes: no inter MBs (no MC) or
inter.  `store_refs_fn` is the batch's one reference store a round.
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


def _stage(rows, device):
    """Host arrays of one shape, one per lane -> int32 tensor [B, ...] on
    `device`.  For a CUDA device the lanes are stacked into a pinned
    staging tensor and copied with non_blocking=True (the caching host
    allocator keeps the staging memory until the copy has run)."""
    shape = (len(rows),) + np.shape(rows[0])
    if device.type != "cuda":
        return torch.from_numpy(np.stack(rows).astype(np.int32, copy=False))
    buf = torch.empty(shape, dtype=torch.int32, pin_memory=True)
    arr = buf.numpy()
    for i, r in enumerate(rows):
        if np.shape(r) != shape[1:]:
            raise ValueError(f"lane {i}: shape {np.shape(r)}, lane 0 "
                             f"{shape[1:]}")
        arr[i] = r
    return buf.to(device, non_blocking=True)


def lane_index(values, device):
    """int64 index tensor of `values` on `device`.  For a CUDA device it
    goes through pinned memory without waiting for the device's queue, as
    a copy of torch.tensor(values) would."""
    t = torch.tensor(values, dtype=torch.int64)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def upload_batch(abis, device, n_slots: int | None = None) -> dict:
    """Host FrameABIs, one per lane -> dict of device tensors [B, ...].

    Field pictures carry `cvoff` (api.Decoder.pack_abi: one entry per DPB
    slot of the 64 the host table holds); when any lane has one, the
    batch ships cvoff [B, n_slots], zeros for lanes without.  An entry
    at or past n_slots must be 0 (no picture can be stored there).

    A coefficient class is left out only when it is all zero in every lane
    (residual_planes skips it).  Lanes ship the per-slice weight tables
    (wtab, slogwd) unless one of them carries dense per-cell weights
    (abi["wp"], the slice-row overflow fallback of ops.abi): then the
    whole batch ships wp/logwd, the other lanes' expanded on the device by
    resolve_weights from their own tables."""
    device = torch.device(device)
    dense = [i for i, a in enumerate(abis) if "wp" in a]
    keys = [k for k in ABI_DEVICE_KEYS
            if not (dense and k in ("wtab", "slogwd"))]
    out = {}
    for k in keys:
        rows = [np.asarray(a[k]) for a in abis]
        if k in COEFF_KEYS and not any(r.any() for r in rows):
            continue
        out[k] = _stage(rows, device)
    cv = [a.get("cvoff") for a in abis]
    if any(c is not None for c in cv):
        if n_slots is None:
            raise ValueError("field pictures: upload_batch needs n_slots")
        rows = [np.zeros(n_slots, np.int32) if c is None else np.asarray(c)
                for c in cv]
        for i, r in enumerate(rows):
            if r[n_slots:].any():
                raise ValueError(f"lane {i}: cvoff of a slot past the "
                                 f"{n_slots} DPB slots")
        out["cvoff"] = _stage([r[:n_slots] for r in rows], device)
    if dense:
        tables = [i for i in range(len(abis)) if i not in dense]
        for k in ("wp", "logwd"):
            rows = [np.asarray(abis[i][k]) for i in dense]
            out[k] = torch.empty((len(abis),) + rows[0].shape,
                                 dtype=torch.int32, device=device)
            out[k][lane_index(dense, device)] = _stage(rows, device)
        if tables:
            ti = lane_index(tables, device)
            sub = {k: out[k][ti] for k in ("slice_id", "refidx")}
            for k in ("wtab", "slogwd"):
                sub[k] = _stage([abis[i][k] for i in tables], device)
            sub = resolve_weights(sub)
            for k in ("wp", "logwd"):
                out[k][ti] = sub[k]
    return out


def upload_abi(abi, device, n_slots: int | None = None) -> dict:
    """Host FrameABI -> dict of device tensors (no stream axis), as
    upload_batch uploads one lane."""
    return {k: v[0] for k, v in upload_batch([abi], device, n_slots).items()}


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


def stream_params(sps: SPS, pps: PPS) -> tuple:
    """The parameters of a stream that decode_consts reads, hashable: (mb_w,
    mb_h, 4x4 and 8x8 scaling lists, chroma QP offsets, transform
    bypass, field).  mb_h counts the MB rows of a coded picture: of a
    field, for an interlaced SPS, whose pictures are all fields (MBAFF
    and frame pictures of such an SPS are rejected by the slice header
    parse).  Streams decoded in one batch must share them."""
    sl4 = pps.scaling_lists_4x4 if pps.scaling_lists_4x4 is not None \
        else sps.scaling_lists_4x4
    sl8 = pps.scaling_lists_8x8 if pps.scaling_lists_8x8 is not None \
        else sps.scaling_lists_8x8
    return (sps.pic_width_in_mbs, sps.pic_height_in_map_units,
            tuple(map(tuple, sl4)), tuple(map(tuple, sl8)),
            (pps.chroma_qp_index_offset, pps.chroma_qp_offset(1)),
            bool(sps.qpprime_y_zero_transform_bypass_flag),
            not sps.frame_mbs_only_flag)


def dpb_slots(sps: SPS) -> int:
    """Device DPB slots of a stream: its reference pictures plus the
    picture being decoded.  Of an interlaced SPS each reference frame is
    two fields, each in a slot of its own."""
    per_frame = 1 if sps.frame_mbs_only_flag else 2
    return max(2, min(sps.max_num_ref_frames * per_frame, 32) + 1)


def decode_consts(params: tuple, device, order: str = "phase") -> dict:
    """Keyword arguments of decode_frames_batch_fn other than `inter`, for
    pictures of stream_params `params` on `device`."""
    mb_w, mb_h, sl4, sl8, cqp_off, bypass, field = params
    ws4, ws8 = make_ws_consts(sl4, sl8)
    return dict(mb_w=mb_w, mb_h=mb_h, ws4=ws4.to(device), ws8=ws8.to(device),
                cqp_off=cqp_off, bypass=bypass, order=order, field=field)


def _mc_pred(abi: dict, dpb_y, dpb_c, mb_w: int, mb_h: int):
    """Inter prediction planes (pred_y, pred_cb, pred_cr) [B, ...] int32:
    K3/K4 (mc_luma, mc_chroma) predict each list as uint8, and
    mc_combine weights and averages the lists in int32.  Pictures without
    `cvoff` (frames) give K4 a zero table."""
    a = resolve_weights(abi)
    cvoff = a.get("cvoff")
    if cvoff is None:
        cvoff = torch.zeros(dpb_c.shape[:2], dtype=torch.int32,
                            device=dpb_c.device)
    return mc_combine(mc_luma(dpb_y, a["mv"], a["refslot"], mb_w, mb_h),
                      mc_chroma(dpb_c, a["mv"], a["refslot"], cvoff, mb_w,
                                mb_h),
                      a["refslot"], a["wp"], a["logwd"], mb_w, mb_h)


def decode_frames_batch_fn(abi_b: dict, dpb_y_b, dpb_c_b, *, mb_w: int,
                           mb_h: int, ws4, ws8, cqp_off, inter: bool,
                           bypass: bool = False, order: str = "phase",
                           field: bool = False):
    """[B] pictures: ABI tensors [B, n, ...] + DPBs [B, S, ...] -> (y, cb,
    cr) uint8 [B, H, W] / [B, H/2, W/2].  inter: whether any MB of the
    batch is inter (else MC is skipped).  order: "phase" runs the
    knight-move wavefront kernels K1/K2, "raster" the raster-order kernels
    K5/K6 (ORDERS).  field: the pictures are fields (deblock_tables)."""
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
    tables = deblock_tables(abi_b, mb_w, mb_h, cqp_off, field)
    return deblock(y, cb, cr, tables, mb_w, mb_h)


def decode_frame_fn(abi: dict, dpb_y, dpb_c, **kw):
    """One frame: ABI tensors [n, ...] + DPB [S, ...] -> (y, cb, cr) uint8."""
    out = decode_frames_batch_fn({k: v[None] for k, v in abi.items()},
                                 dpb_y[None], dpb_c[None], **kw)
    return tuple(p[0] for p in out)


def store_refs_fn(dpb_y_b, dpb_c_b, lanes, slots, y_b, cb_b, cr_b) -> None:
    """One reference store for a batch: lane lanes[k]'s picture (y_b,
    cb_b, cr_b [B, ...]) goes into slot slots[k] of its DPB row (dpb_y_b
    [B, S, 4, Hp, Wp], dpb_c_b [B, S, 2, ...]), in place, with one index
    assignment per DPB.  The half-pel planes are computed for the storing
    lanes only; a lane that is not in `lanes` is left untouched."""
    if not lanes:
        return
    li, si = (lane_index(v, dpb_y_b.device) for v in (lanes, slots))
    dpb_y_b[li, si] = torch.stack(halfpel_planes(y_b[li]), 1)
    dpb_c_b[li, si] = torch.stack((pad_chroma(cb_b[li]),
                                   pad_chroma(cr_b[li])), 1)


def store_ref_fn(dpb_y, dpb_c, slot: int, y, cb, cr) -> None:
    """Write a reference picture's half-pel planes and padded chroma into
    DPB slot `slot`, in place (dpb_y [S, 4, Hp, Wp], dpb_c [S, 2, ...])."""
    store_refs_fn(dpb_y[None], dpb_c[None], [0], [slot], y[None], cb[None],
                  cr[None])


class DevicePipeline:
    """Per (sps, pps) frame reconstruction + the device DPB slots."""

    def __init__(self, sps: SPS, pps: PPS, device, order: str = "phase"):
        if order not in ORDERS:
            raise ValueError(f"order {order!r}: expected one of "
                             f"{sorted(ORDERS)}")
        self.device = torch.device(device)
        self._kw = decode_consts(stream_params(sps, pps), self.device, order)
        self.n_slots = dpb_slots(sps)
        self.sps, self.pps = sps, pps
        self.mb_w, self.mb_h = self._kw["mb_w"], self._kw["mb_h"]
        self.dpb_y, self.dpb_c = dpb_alloc(self.mb_w, self.mb_h,
                                           self.n_slots, self.device)

    def decode_frame(self, abi):
        """Host FrameABI -> (y, cb, cr) uint8 device planes (uncropped; a
        field's for a field picture)."""
        inter = bool((np.asarray(abi["kind"]) >= KIND_P).any())
        return decode_frame_fn(upload_abi(abi, self.device, self.n_slots),
                               self.dpb_y, self.dpb_c, inter=inter,
                               **self._kw)

    def store_ref(self, slot: int, y, cb, cr) -> None:
        store_ref_fn(self.dpb_y, self.dpb_c, slot, y, cb, cr)
