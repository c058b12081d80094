"""Wrapper of the intra kernel (csrc/intra_phase.cu).

Replaces arrow_h264_tpu/ops/pallas/intra_phase.py::intra_phase_batch.  The
plain version is ops/intra.py::intra_reconstruct.  `run_intra` is the
launch path that this kernel and the raster-order one (intra_raster.py)
share: they take the same arguments.
"""

from __future__ import annotations

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


def _device_tables(device):
    if device not in _tables:
        _tables[device] = tuple(torch.from_numpy(t).to(device)
                                for t in (W4, S4, R4, W8, S8, R8))
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
    # the kernel writes the intra MBs into copies of the init planes
    y, cb, cr = (p.to(device=dev, dtype=torch.uint8, copy=True)
                 .contiguous() for p in (init_y, init_cb, init_cr))
    require(y, "init_y", torch.uint8, (B, H, W), dev)
    for arg, c in (("init_cb", cb), ("init_cr", cr)):
        require(c, arg, torch.uint8, (B, H // 2, W // 2), dev)
    tabs = _device_tables(dev)
    ptrs = [abi[k].data_ptr() for k in INTRA_ABI_KEYS] + \
        [t.data_ptr() for t in (res_y, res_cb, res_cr, y, cb, cr) + tabs
         + extra]
    fn = build.function(f"{name}_launch", len(ptrs), 3)
    with torch.cuda.device(dev):
        err = fn(*ptrs, B, mb_w, mb_h, torch.cuda.current_stream().cuda_stream)
    build.check(f"{name}_launch", err)
    LAUNCHES[name] += 1
    return y, cb, cr
