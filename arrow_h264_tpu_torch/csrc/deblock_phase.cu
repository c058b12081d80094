// In-loop deblocking filter (spec 8.7) along the knight-move wavefront,
// in place on uint8 planes.
//
// Replaces: arrow_h264_tpu/ops/pallas/deblock_phase.py::deblock_phase_batch
// (:395; grid body _phase_kernel :233).  The TPU kernel filters skewed,
// lane-packed blocks of all streams in one sequential grid.  Here the host
// loop launches one grid per phase: one 32-thread block per (stream, MB of
// the phase).  In the vertical pass thread t < 16 filters luma row t
// across the four vertical edges in order (x = 0, 4, 8, 12), threads
// 16..31 do the same for the 8 rows of Cb and of Cr (x = 0, 4); after
// __syncthreads() the horizontal pass does the same down the columns
// (deblock_mb.cuh::deblock_line).
//
// What bounds it: the dependency chain, as for the intra kernel.  An MB
// needs its left, top and top-right neighbours filtered (MB (r, c) reads
// the bottom rows of (r-1, c), whose right columns (r-1, c+1) writes), so
// a 1080p frame is 254 dependent phases; per MB there are a few hundred
// samples of work.  The design keeps each phase to one small launch and
// filters in place, so every sample moves through device memory once per
// edge that touches it.  The bS/tc0/alpha/beta tables are computed for
// the whole frame beforehand (ops/deblock.py::deblock_tables).

#include "deblock_mb.cuh"

namespace {

using deblock::DeblockArgs;

__global__ void __launch_bounds__(32)
deblock_phase_kernel(DeblockArgs a, int phase, int my0) {
  const int my = my0 + blockIdx.x;
  const int mx = phase - 2 * my;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int pl = t < 16 ? 0 : (t < 24 ? 1 : 2), k = t < 16 ? t : (t - 16) & 7;
  for (int d = 0; d < 2; ++d) {                 // 0 vertical, 1 horizontal
    deblock::deblock_line(a, b, pl, mx, my, d, k);
    __syncthreads();
  }
}

}  // namespace

extern "C" int deblock_phase_launch(
    uint8_t* y, uint8_t* cb, uint8_t* cr, const int32_t* bs_v,
    const int32_t* tc_v, const int32_t* a_v, const int32_t* b_v,
    const int32_t* bs_h, const int32_t* tc_h, const int32_t* a_h,
    const int32_t* b_h, const int32_t* bs_c, const int32_t* tc_c,
    const int32_t* a_c, const int32_t* b_c, int B, int mb_w, int mb_h,
    void* stream) {
  DeblockArgs a{y, cb, cr, bs_v, tc_v, a_v, b_v, bs_h, tc_h, a_h, b_h,
                bs_c, tc_c, a_c, b_c, mb_w, mb_h};
  const int n_phases = mb_w + 2 * (mb_h - 1);
  for (int p = 0; p < n_phases; ++p) {
    const int my0 = p - mb_w + 1 > 0 ? (p - mb_w + 2) / 2 : 0;
    const int my1 = p / 2 < mb_h - 1 ? p / 2 : mb_h - 1;
    const dim3 grid(my1 - my0 + 1, B);
    deblock_phase_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(a, p, my0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
