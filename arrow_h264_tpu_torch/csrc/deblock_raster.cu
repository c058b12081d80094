// In-loop deblocking filter (spec 8.7) in raster order, in place on uint8
// planes: one block per (stream, plane) walks all MBs of its picture.
//
// Replaces: arrow_h264_tpu/ops/pallas/deblock_kernel.py::deblock_pallas
// (:287; pallas_call :303 luma, :322 chroma; grid bodies _luma_kernel and
// _chroma_kernel :230).  The TPU kernel walks one MB row per grid step and
// the MBs of the row in a loop, over an aligned, lane-rolled working tile
// per MB.  Here one 16-thread block per (stream, plane) filters the MBs in
// raster order, the spec's own order: for each MB the vertical edges, a
// barrier, the horizontal edges, a barrier, with one thread per line (16
// luma, 8 chroma; deblock_mb.cuh::deblock_line, shared with K2).  Luma and
// the two chroma planes never read each other, so the three blocks of a
// stream run at the same time.
//
// What bounds it: latency.  The MBs of a picture form one serial chain of
// mb_w * mb_h steps (8160 at 1080p), each a few dependent global-memory
// round trips and two barriers, so one SM per plane works and the rest of
// the card idles.  The design does nothing about that; it is the
// raster-order counterpart of deblock_phase.cu (K2), which spreads the
// same per-MB body over the knight-move wavefront.  The barrier after each
// pass makes this block's writes visible to the threads that read them
// next (a horizontal pass reads columns the vertical pass wrote by rows).

#include "deblock_mb.cuh"

namespace {

using deblock::DeblockArgs;

__global__ void __launch_bounds__(16) deblock_raster_kernel(DeblockArgs a) {
  const int b = blockIdx.x, pl = blockIdx.y, k = threadIdx.x;
  const bool active = k < (pl == 0 ? 16 : 8);
  for (int my = 0; my < a.mb_h; ++my) {
    for (int mx = 0; mx < a.mb_w; ++mx) {
      for (int d = 0; d < 2; ++d) {             // 0 vertical, 1 horizontal
        if (active) deblock::deblock_line(a, b, pl, mx, my, d, k);
        __syncthreads();
      }
    }
  }
}

}  // namespace

extern "C" int deblock_raster_launch(
    uint8_t* y, uint8_t* cb, uint8_t* cr, const int32_t* bs_v,
    const int32_t* tc_v, const int32_t* a_v, const int32_t* b_v,
    const int32_t* bs_h, const int32_t* tc_h, const int32_t* a_h,
    const int32_t* b_h, const int32_t* bs_c, const int32_t* tc_c,
    const int32_t* a_c, const int32_t* b_c, int B, int mb_w, int mb_h,
    void* stream) {
  DeblockArgs a{y, cb, cr, bs_v, tc_v, a_v, b_v, bs_h, tc_h, a_h, b_h,
                bs_c, tc_c, a_c, b_c, mb_w, mb_h};
  deblock_raster_kernel<<<dim3(B, 3), 16, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
