"""Carry the JAX package's device state over to the port.

The JAX pipeline keeps its DPB as packed u32 lanes (4 uint8 samples per
little-endian word, lane count rounded up, chroma rows padded to at least
64; `arrow_h264_tpu.models.pipeline.dpb_alloc`).  The port's DPB is dense
uint8.  These helpers take the JAX state as numpy arrays, so this module
imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.inter import PAD, PADC


def _unpack_u32(packed: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """[..., R, L] u32 little-endian lanes -> [..., rows, cols] uint8."""
    p = np.ascontiguousarray(packed, dtype="<u4")
    u8 = p.view(np.uint8).reshape(p.shape[:-1] + (p.shape[-1] * 4,))
    return np.ascontiguousarray(u8[..., :rows, :cols])


def dpb_from_jax(dpb_y4p, dpb_cp, mb_w: int, mb_h: int, device="cpu"):
    """JAX packed DPB (y4p [S, 4, Hp, WL] u32, cp [S, 2, Hcp', WLc] u32)
    -> the port's dense (dpb_y [S, 4, Hp, Wp], dpb_c [S, 2, Hcp, Wcp])
    uint8 tensors on `device`."""
    H, W = mb_h * 16, mb_w * 16
    y = _unpack_u32(np.asarray(dpb_y4p), H + 2 * PAD, W + 2 * PAD)
    c = _unpack_u32(np.asarray(dpb_cp), H // 2 + 2 * PADC, W // 2 + 2 * PADC)
    return torch.from_numpy(y).to(device), torch.from_numpy(c).to(device)


def ws_from_jax(ws4, ws8, device="cpu"):
    """JAX make_ws_consts output (numpy int32 ws4 [6, 6, 4, 4], ws8
    [2, 6, 8, 8]) -> the port's LevelScale tensors on `device`."""
    return (torch.from_numpy(np.asarray(ws4, np.int32).copy()).to(device),
            torch.from_numpy(np.asarray(ws8, np.int32).copy()).to(device))
