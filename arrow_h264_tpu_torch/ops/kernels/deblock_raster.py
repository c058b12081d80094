"""Wrapper of the raster-order deblock kernel (csrc/deblock_raster.cu).

Replaces arrow_h264_tpu/ops/pallas/deblock_kernel.py::deblock_pallas.  The
plain version is ops/deblock.py::deblock_filter_planes, the same as for the
knight-move wavefront kernel (deblock_phase.py), whose contract it shares.
"""

from __future__ import annotations

from . import cuda_device
from .deblock_phase import run_deblock
from .wavefront import row_args


def deblock_raster(y, cb, cr, tables, mb_w: int, mb_h: int):
    """Deblock [B] frames in raster order within each MB row, the spec's
    own: one persistent launch, one worker per (MB row, stream), each two
    MBs behind the row above.  Arguments and result as for
    deblock_phase.run_deblock."""
    extra = row_args(y.shape[0], mb_h, y.device) if cuda_device(y) else ()
    return run_deblock("deblock_raster", y, cb, cr, tables, mb_w, mb_h, extra)
