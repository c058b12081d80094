"""Wrapper of the raster-order intra kernel (csrc/intra_raster.cu).

Replaces arrow_h264_tpu/ops/pallas/intra_kernel.py::intra_reconstruct_pallas.
The plain version is ops/intra.py::intra_reconstruct, the same as for the
knight-move wavefront kernel (intra_phase.py), whose contract it shares.
"""

from __future__ import annotations

from . import cuda_device
from .intra_phase import run_intra
from .wavefront import row_args


def intra_raster(abi, res_y, res_cb, res_cr, init_y, init_cb, init_cr,
                 mb_w: int, mb_h: int):
    """Intra/PCM reconstruction of [B] frames in raster order within each
    MB row: one persistent launch, one worker per (MB row, stream, part),
    luma or chroma, each two MBs behind the row above.  Arguments and
    result as for intra_phase.run_intra."""
    extra = row_args(res_y.shape[0], mb_h, res_y.device, parts=2) \
        if cuda_device(res_y) else ()
    return run_intra("intra_raster", abi, res_y, res_cb, res_cr, init_y,
                     init_cb, init_cr, mb_w, mb_h, extra)
