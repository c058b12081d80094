"""Wrapper of the raster-order intra kernel (csrc/intra_raster.cu).

Replaces arrow_h264_tpu/ops/pallas/intra_kernel.py::intra_reconstruct_pallas.
The plain version is ops/intra.py::intra_reconstruct, the same as for the
knight-move wavefront kernel (intra_phase.py), whose contract it shares.
"""

from __future__ import annotations

from .intra_phase import run_intra


def intra_raster(abi, res_y, res_cb, res_cr, init_y, init_cb, init_cr,
                 mb_w: int, mb_h: int):
    """Intra/PCM reconstruction of [B] frames in raster order: one launch,
    one block per (stream, plane).  Arguments and result as for
    intra_phase.run_intra."""
    return run_intra("intra_raster", abi, res_y, res_cb, res_cr, init_y,
                     init_cb, init_cr, mb_w, mb_h)
