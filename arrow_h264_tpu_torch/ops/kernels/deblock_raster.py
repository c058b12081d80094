"""Wrapper of the raster-order deblock kernel (csrc/deblock_raster.cu).

Replaces arrow_h264_tpu/ops/pallas/deblock_kernel.py::deblock_pallas.  The
plain version is ops/deblock.py::deblock_filter_planes, the same as for the
knight-move wavefront kernel (deblock_phase.py), whose contract it shares.
"""

from __future__ import annotations

from .deblock_phase import run_deblock


def deblock_raster(y, cb, cr, tables, mb_w: int, mb_h: int):
    """Deblock [B] frames in raster order, the spec's own: one launch, one
    block per (stream, plane).  Arguments and result as for
    deblock_phase.run_deblock."""
    return run_deblock("deblock_raster", y, cb, cr, tables, mb_w, mb_h)
