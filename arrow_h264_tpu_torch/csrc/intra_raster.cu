// Intra prediction + residual add for every intra MB (spec 8.3), in raster
// order: one block per (stream, plane) walks all MBs of its picture.
//
// Replaces: arrow_h264_tpu/ops/pallas/intra_kernel.py::intra_reconstruct_pallas
// (:355; pallas_call :392 luma, :410 chroma; grid bodies _luma_kernel :266
// and _chroma_kernel :320).  The TPU kernel walks one MB row per grid step
// and the MBs of the row in a loop, over an aligned, lane-rolled working
// tile per MB.  Here one block per (stream, plane) loops over the MBs in
// raster order and runs the per-MB body of intra_mb.cuh in place on the
// output plane: blockIdx.y 0 is luma (256 threads), 1 and 2 are Cb and Cr
// (64 of the 256 threads).  Luma and the two chroma planes never read
// each other, so the three blocks of a stream run at the same time.  The
// MB kind is read first; inter MBs are skipped, their samples arrive
// already reconstructed in the planes (MC + residual).
//
// What bounds it: latency.  The MBs of a picture form one serial chain of
// mb_w * mb_h steps (8160 at 1080p), each a few dependent global-memory
// round trips and __syncthreads() barriers, so one SM per plane works and
// the rest of the card idles.  The design does nothing about that; it is
// the raster-order counterpart of intra_phase.cu (K1), which spreads the
// same per-MB body over the knight-move wavefront.  Neighbours come from
// the plane this block has just written: the barrier after each MB makes
// its writes visible to the block's threads.

#include "intra_mb.cuh"

namespace {

using intra::IntraArgs;

__global__ void __launch_bounds__(256) intra_raster_kernel(IntraArgs a) {
  const int b = blockIdx.x, plane = blockIdx.y, t = threadIdx.x;
  const int32_t* kinds = a.kind + (long)b * a.mb_w * a.mb_h;
  for (int my = 0; my < a.mb_h; ++my) {
    for (int mx = 0; mx < a.mb_w; ++mx) {
      const int kind = kinds[my * a.mb_w + mx];
      if (kind > intra::KIND_IPCM) continue;    // inter MB (uniform per block)
      if (plane == 0)
        intra::intra_mb_luma(a, b, mx, my, kind, t);
      else
        intra::intra_mb_chroma(a, b, mx, my, kind, plane - 1, t, t < 64);
      __syncthreads();                          // MB done: next reads it
    }
  }
}

}  // namespace

extern "C" int intra_raster_launch(
    const int32_t* kind, const int32_t* i4_modes, const int32_t* i4_avail,
    const int32_t* i8_modes, const int32_t* i8_avail,
    const int32_t* i16_mode, const int32_t* chroma_mode,
    const int32_t* mb_avail, const int32_t* res_y, const int32_t* res_cb,
    const int32_t* res_cr, uint8_t* y, uint8_t* cb, uint8_t* cr,
    const int32_t* w4, const int32_t* s4, const int32_t* r4,
    const int32_t* w8, const int32_t* s8, const int32_t* r8, int B,
    int mb_w, int mb_h, void* stream) {
  IntraArgs a{kind, i4_modes, i4_avail, i8_modes, i8_avail, i16_mode,
              chroma_mode, mb_avail, res_y, res_cb, res_cr, y, cb, cr,
              w4, s4, r4, w8, s8, r8, mb_w, mb_h};
  intra_raster_kernel<<<dim3(B, 3), 256, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
