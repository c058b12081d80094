"""The decode pipeline: frame ABI -> reconstructed planes (PyTorch).

Port of `arrow_h264_tpu.models.pipeline`.  Per frame, on the device:

    residual (dequant + IDCT, kernel K9) -> inter MC (kernels K3/K4) +
    weighted combine and residual add (kernel K10) -> intra (kernel K1)
    -> deblock tables (kernel K7) -> deblock (kernel K2)

then `store_ref_fn` writes each reference picture's half-pel planes into
its slot of the device DPB (kernel K11).  With order="raster" the intra
and deblock stages run the raster-order kernels K5/K6 in place of K1/K2;
every other stage is the same.  Every function takes a leading stream
axis [B, ...]; the single-stream `DevicePipeline` runs B = 1.

Field pictures (all-field PAFF) take the same path at field height: each
reference field has its own DPB slot, K4 reads a per-slot vertical chroma
offset for references of the other parity (`cvoff`), and the deblock
tables follow the field rules (`deblock_tables(field=True)`).

The host ships a picture as one compact uint8 buffer (ops.wire, the
default upload "wire"): `upload_wire` emits each lane's buffer into its
row of one pinned [B, total] staging tensor, copies it with one
non_blocking copy and scatters it back into the dense ABI on the device
(ops.wire.unpack_wire: kernel K12, and K8 for the bm8 coefficient
classes).  upload="dense" ships the dense int32 ABI
(`ABI_DEVICE_KEYS`) key by key instead (`upload_batch`), as does every
picture with dense per-cell weights (abi["wp"], the slice-row overflow of
ops.abi), which the wire's 4-bit slice rows cannot carry.  Either way,
coefficient classes that are all zero in every lane stay on the host and
their residual paths are skipped.  A batch runs one of two modes: no
inter MBs (no MC) or inter.  `store_refs_fn` is the batch's one reference
store a round.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream.params import PPS, SPS
from ..ops.abi import KIND_P
from ..ops.inter import PAD, PADC, resolve_weights
from ..ops.kernels.deblock_phase import deblock_phase
from ..ops.kernels.deblock_raster import deblock_raster
from ..ops.kernels.deblock_tables import deblock_tables
from ..ops.kernels.inter_combine import inter_combine
from ..ops.kernels.intra_phase import intra_phase
from ..ops.kernels.intra_raster import intra_raster
from ..ops.kernels.mc import mc_chroma, mc_luma
from ..ops.kernels.residual import residual_planes
from ..ops.kernels.store_ref import store_refs
from ..ops.transforms import COEFF_KEYS, make_ws_consts
from ..ops.wire import emit_wire, pack_wire_raw, unpack_wire, wire_total

ABI_DEVICE_KEYS = (
    "kind", "qp", "luma4", "luma8", "luma_dc", "chroma_dc", "chroma_ac",
    "i4_modes", "i8_modes", "i16_mode", "chroma_mode", "i4_avail", "i8_avail",
    "mb_avail", "pcm", "nz", "tr8", "slice_id", "disable_idc", "alpha_off",
    "beta_off", "mv", "refid", "refslot", "refidx", "wtab", "slogwd",
)

# order -> (intra, deblock) kernel wrappers; both pairs share one contract
ORDERS = {"phase": (intra_phase, deblock_phase),
          "raster": (intra_raster, deblock_raster)}
# how the host ships a picture's ABI: the compact wire, or dense int32
UPLOADS = ("wire", "dense")


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
    cv = stage_cvoff([a.get("cvoff") for a in abis], n_slots, device)
    if cv is not None:
        out["cvoff"] = cv
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


def stage_cvoff(cvoffs, n_slots: int | None, device):
    """The lanes' per-slot chroma offsets (api.field_cvoff, [64] each, or
    None for a frame lane) -> cvoff [B, n_slots] int32 on `device`, or
    None when no lane has one.  An entry at or past n_slots must be 0 (no
    picture can be stored there)."""
    if all(c is None for c in cvoffs):
        return None
    if n_slots is None:
        raise ValueError("field pictures: the upload needs n_slots")
    rows = [np.zeros(n_slots, np.int32) if c is None else np.asarray(c)
            for c in cvoffs]
    for i, r in enumerate(rows):
        if r[n_slots:].any():
            raise ValueError(f"lane {i}: cvoff of a slot past the "
                             f"{n_slots} DPB slots")
    return _stage([r[:n_slots] for r in rows], torch.device(device))


def wire_staging(n_lanes: int, total: int, device) -> torch.Tensor:
    """Host tensor [n_lanes, total] uint8 that the lanes' wire buffers are
    emitted into (ops.wire.emit_wire(..., out=row.numpy())): pinned for a
    CUDA device, so that wire_to_device copies it with non_blocking=True
    (the caching host allocator keeps it until the copy has run)."""
    return torch.empty((n_lanes, total), dtype=torch.uint8,
                       pin_memory=torch.device(device).type == "cuda")


def wire_to_device(buf, target, mb_w: int, mb_h: int, device) -> dict:
    """Staged wire buffers buf [B, total] (spec `target`) -> the dense ABI
    [B, ...] on `device`: one copy, then ops.wire.unpack_wire there."""
    device = torch.device(device)
    if device.type == "cuda":
        buf = buf.to(device, non_blocking=True)
    return unpack_wire(buf, mb_w, mb_h, target)


def upload_wire(raws, target, mb_w: int, mb_h: int, device,
                n_slots: int | None = None, cvoffs=None) -> dict:
    """Lanes' packed wire records -> dict of device tensors [B, ...], as
    upload_batch gives for the lanes' dense ABIs (refid aside:
    ops.wire.unpack_wire).

    raws: (raw, spec) of ops.wire.pack_wire_raw, one per lane; target: a
    spec that every lane's conforms to (ops.wire.merge_specs of theirs, or
    the one lane's own).  Each lane is emitted into its row of one staging
    tensor, which goes to the device in one copy.  cvoffs: each lane's
    abi.get("cvoff") for field pictures (stage_cvoff)."""
    device = torch.device(device)
    n = mb_w * mb_h
    buf = wire_staging(len(raws), wire_total(target, n), device)
    rows = buf.numpy()
    for i, (raw, spec) in enumerate(raws):
        emit_wire(raw, spec, target, n, out=rows[i])
    out = wire_to_device(buf, target, mb_w, mb_h, device)
    cv = stage_cvoff(cvoffs or [None] * len(raws), n_slots, device)
    if cv is not None:
        out["cvoff"] = cv
    return out


def upload_nbytes(batch: dict) -> int:
    """Bytes of the tensors of an uploaded ABI dict."""
    return sum(t.numel() * t.element_size() for t in batch.values())


def upload_abi(abi, device, n_slots: int | None = None) -> dict:
    """Host FrameABI -> dict of device tensors (no stream axis), as
    upload_batch uploads one lane."""
    return {k: v[0] for k, v in upload_batch([abi], device, n_slots).items()}


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


def _mc_pred(abi: dict, dpb_y, dpb_c, res, mb_w: int, mb_h: int):
    """The init planes (init_y, init_cb, init_cr) [B, ...] int32 of the
    inter MBs: K3/K4 (mc_luma, mc_chroma) predict each list as uint8, and
    K10 (inter_combine) weights and combines the lists and adds the
    residual planes `res` (res_y, res_cb, res_cr).  Pictures without
    `cvoff` (frames) give K4 a zero table."""
    cvoff = abi.get("cvoff")
    if cvoff is None:
        cvoff = torch.zeros(dpb_c.shape[:2], dtype=torch.int32,
                            device=dpb_c.device)
    return inter_combine(
        abi, mc_luma(dpb_y, abi["mv"], abi["refslot"], mb_w, mb_h),
        mc_chroma(dpb_c, abi["mv"], abi["refslot"], cvoff, mb_w, mb_h),
        *res, mb_w, mb_h)


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
    res = residual_planes(abi_b, mb_w, mb_h, ws4, ws8, cqp_off,
                          bypass=bypass)
    init = (None, None, None)
    if inter:
        init = _mc_pred(abi_b, dpb_y_b, dpb_c_b, res, mb_w, mb_h)
    y, cb, cr = intra(abi_b, *res, *init, mb_w, mb_h)
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
    [B, S, 4, Hp, Wp], dpb_c_b [B, S, 2, ...]), in place, by K11
    (store_refs).  The half-pel planes are computed for the storing lanes
    only; a lane that is not in `lanes` is left untouched."""
    store_refs(dpb_y_b, dpb_c_b, lanes, slots, y_b, cb_b, cr_b)


def store_ref_fn(dpb_y, dpb_c, slot: int, y, cb, cr) -> None:
    """Write a reference picture's half-pel planes and padded chroma into
    DPB slot `slot`, in place (dpb_y [S, 4, Hp, Wp], dpb_c [S, 2, ...])."""
    store_refs_fn(dpb_y[None], dpb_c[None], [0], [slot], y[None], cb[None],
                  cr[None])


class DevicePipeline:
    """Per (sps, pps) frame reconstruction + the device DPB slots."""

    def __init__(self, sps: SPS, pps: PPS, device, order: str = "phase",
                 upload: str = "wire"):
        if order not in ORDERS:
            raise ValueError(f"order {order!r}: expected one of "
                             f"{sorted(ORDERS)}")
        if upload not in UPLOADS:
            raise ValueError(f"upload {upload!r}: expected one of "
                             f"{list(UPLOADS)}")
        self.device = torch.device(device)
        self.upload = upload
        # (mode, bytes) of the last decode_frame's upload
        self.last_upload: tuple[str, int] | None = None
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
        if self.upload == "wire" and "wp" not in abi:
            raw, spec = pack_wire_raw(abi, self.mb_w, self.mb_h)
            batch = upload_wire([(raw, spec)], spec, self.mb_w, self.mb_h,
                                self.device, self.n_slots,
                                [abi.get("cvoff")])
            self.last_upload = ("wire", wire_total(spec, self.mb_w * self.mb_h)
                                + 4 * self.n_slots * ("cvoff" in batch))
        else:
            batch = upload_batch([abi], self.device, self.n_slots)
            self.last_upload = ("dense", upload_nbytes(batch))
        out = decode_frames_batch_fn(batch, self.dpb_y[None],
                                     self.dpb_c[None], inter=inter,
                                     **self._kw)
        return tuple(p[0] for p in out)

    def store_ref(self, slot: int, y, cb, cr) -> None:
        store_ref_fn(self.dpb_y, self.dpb_c, slot, y, cb, cr)
