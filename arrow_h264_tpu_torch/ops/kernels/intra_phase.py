"""Wrapper of the intra kernel (csrc/intra_phase.cu).

Replaces arrow_h264_tpu/ops/pallas/intra_phase.py::intra_phase_batch.  The
plain version is ops/intra.py::intra_reconstruct.  `run_intra` is the
launch path that this kernel and the raster-order one (intra_raster.py)
share: they take the same arguments.
"""

from __future__ import annotations

import numpy as np
import torch

from ..intra import intra_reconstruct
from ..intra_tables import R4, R8, S4, S8, W4, W8
from . import LAUNCHES, build, cuda_device, require
from .wavefront import wavefront_args

# ABI fields the kernel reads, [B, n, ...] int32
INTRA_ABI_KEYS = ("kind", "i4_modes", "i4_avail", "i8_modes", "i8_avail",
                  "i16_mode", "chroma_mode", "mb_avail")
_ABI_SHAPES = {"kind": (), "i4_modes": (16,), "i4_avail": (16, 4),
               "i8_modes": (4,), "i8_avail": (4, 4), "i16_mode": (),
               "chroma_mode": (), "mb_avail": (3,)}

_tables: dict = {}


def pack_taps(W, S, R) -> np.ndarray:
    """The directional prediction tables W [9, N*N, 1+3N], S, R [9, N*N]
    of ops/intra_tables.py as one int32 word a (mode, sample): three
    indices into the reference vector (bits 0-4, 5-9, 10-14), their
    weights (bits 15-16, 17-18, 19-20), R (bits 21-22) and S (bits
    23-24), so pred = (w0 v[i0] + w1 v[i1] + w2 v[i2] + R) >> S.  Unused
    taps have weight 0.  Raises if a row has more than three non-zero
    weights or a field does not fit."""
    if W.shape[2] > 32:
        raise ValueError(f"{W.shape[2]} references: indices have 5 bits")
    words = np.zeros(S.shape, np.int64)
    for m, q in np.ndindex(*S.shape):
        taps = np.flatnonzero(W[m, q])
        w = W[m, q, taps]
        if len(taps) > 3 or w.max(initial=0) > 3 or S[m, q] > 3 \
                or R[m, q] > 3:
            raise ValueError(f"mode {m} sample {q}: not a 3-tap filter")
        for k, (i, wk) in enumerate(zip(taps, w)):
            words[m, q] |= int(i) << 5 * k | int(wk) << 15 + 2 * k
        words[m, q] |= int(R[m, q]) << 21 | int(S[m, q]) << 23
    return words.astype(np.int32)


def lane_map() -> np.ndarray:
    """[10, 32] int32: the 4x4 block (raster index 4 * y4 + x4) and sample
    that lane l of the I4x4 warp reconstructs in sub-step s, as
    block << 4 | sample, or -1.  Sub-step s holds the blocks with
    2 * y4 + x4 == s (at most two), lanes 0-15 the first, 16-31 the
    second, one sample (raster in the block) a lane."""
    lanes = np.full((10, 32), -1, np.int32)
    for s in range(10):
        blocks = [g for g in range(16) if 2 * (g >> 2) + (g & 3) == s]
        for j, g in enumerate(blocks):
            lanes[s, 16 * j:16 * j + 16] = g << 4 | np.arange(16)
    return lanes


def intra_tables() -> np.ndarray:
    """The kernels' table (csrc/intra_mb.cuh, TAB_WORDS int32): the packed
    4x4 taps [9, 16], the packed 8x8 taps [9, 64], the lane map
    [10, 32]."""
    return np.concatenate([pack_taps(W4, S4, R4).ravel(),
                           pack_taps(W8, S8, R8).ravel(),
                           lane_map().ravel()])


def _device_tables(device):
    if device not in _tables:
        _tables[device] = torch.from_numpy(intra_tables()).to(device)
    return _tables[device]


def intra_phase(abi, res_y, res_cb, res_cr, init_y, init_cb, init_cr,
                mb_w: int, mb_h: int):
    """Intra/PCM reconstruction of [B] frames along the knight-move
    wavefront: one persistent launch with ready flags per MB and part,
    luma or chroma (csrc/intra_phase.cu).  Arguments and result as for
    run_intra."""
    extra = wavefront_args(res_y.shape[0], mb_w, mb_h, res_y.device,
                           parts=2) if cuda_device(res_y) else ()
    return run_intra("intra_phase", abi, res_y, res_cb, res_cr, init_y,
                     init_cb, init_cr, mb_w, mb_h, extra)


def run_intra(name: str, abi, res_y, res_cb, res_cr, init_y, init_cb,
              init_cr, mb_w: int, mb_h: int, extra: tuple = ()):
    """Intra/PCM reconstruction of [B] frames with the kernel whose C
    entry is `name`_launch, counted under LAUNCHES[name]; `extra` are
    tensors that kernel takes after the common arguments.

    abi: dict with INTRA_ABI_KEYS, [B, n, ...] int32.  res_*: int32
    residual planes [B, H, W] / [B, H/2, W/2].  init_*: planes of the same
    shapes holding the reconstructed inter MBs (0..255), or None for
    all-intra frames.  Returns (y, cb, cr) uint8 planes.
    """
    dev = cuda_device(res_y)
    B = res_y.shape[0]
    H, W = mb_h * 16, mb_w * 16
    if init_y is None:
        init_y = torch.zeros((B, H, W), dtype=torch.int32,
                             device=res_y.device)
        init_cb = torch.zeros((B, H // 2, W // 2), dtype=torch.int32,
                              device=res_y.device)
        init_cr = init_cb
    if dev is None:
        planes = intra_reconstruct(abi, res_y, res_cb, res_cr, mb_w, mb_h,
                                   init_y, init_cb, init_cr)
        return tuple(p.to(torch.uint8) for p in planes)
    n = mb_w * mb_h
    for k in INTRA_ABI_KEYS:
        require(abi[k], k, torch.int32, (B, n) + _ABI_SHAPES[k], dev)
    require(res_y, "res_y", torch.int32, (B, H, W), dev)
    for arg, r in (("res_cb", res_cb), ("res_cr", res_cr)):
        require(r, arg, torch.int32, (B, H // 2, W // 2), dev)
    for arg, r in (("res_y", res_y), ("res_cb", res_cb), ("res_cr", res_cr)):
        if r.data_ptr() % 16:           # the kernel copies 16-byte rows
            raise ValueError(f"{arg}: not 16-byte aligned")
    # the kernel writes the intra MBs into copies of the init planes
    y, cb, cr = (p.to(device=dev, dtype=torch.uint8, copy=True)
                 .contiguous() for p in (init_y, init_cb, init_cr))
    require(y, "init_y", torch.uint8, (B, H, W), dev)
    for arg, c in (("init_cb", cb), ("init_cr", cr)):
        require(c, arg, torch.uint8, (B, H // 2, W // 2), dev)
    ptrs = [abi[k].data_ptr() for k in INTRA_ABI_KEYS] + \
        [t.data_ptr() for t in (res_y, res_cb, res_cr, y, cb, cr,
                                _device_tables(dev)) + extra]
    fn = build.function(f"{name}_launch", len(ptrs), 3)
    with torch.cuda.device(dev):
        err = fn(*ptrs, B, mb_w, mb_h, torch.cuda.current_stream().cuda_stream)
    build.check(f"{name}_launch", err)
    LAUNCHES[name] += 1
    return y, cb, cr
