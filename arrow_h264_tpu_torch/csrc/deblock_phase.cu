// In-loop deblocking filter (spec 8.7) along the knight-move wavefront,
// in place on uint8 planes, in one persistent launch.
//
// Replaces: arrow_h264_tpu/ops/pallas/deblock_phase.py::deblock_phase_batch
// (:395; grid body _phase_kernel :233).  The TPU kernel filters skewed,
// lane-packed blocks of all streams in one sequential grid.
//
// What bounds it: the dependency chain, as for the intra kernel.  An MB
// needs its left, top and top-right neighbours filtered (MB (r, c) reads
// the bottom rows of (r-1, c), whose right columns (r-1, c+1) writes), so
// a 1080p frame is a chain of 254 dependent MB steps; per MB there are a
// few hundred samples of work, and the bytes (~3 us at the card's memory
// rate) are far below the chain.
//
// What the design does about it: one launch per call instead of one per
// phase.  Each warp is a worker (8 per block, the grid what the card holds
// resident): lane 0 takes a ticket in wavefront order (wavefront.cuh),
// lanes 0 and 1 wait for the ready flags of the left and the top-right
// neighbour (the top one in the last column; the top and top-left follow,
// since every MB waits on its own), and the warp filters the MB: in the
// vertical pass lane t < 16 filters luma row t across the four vertical
// edges in order (x = 0, 4, 8, 12), lanes 16..31 the 8 rows of Cb and of
// Cr (x = 0, 4); after __syncwarp() the horizontal pass does the same down
// the columns (deblock_mb.cuh::deblock_line, shared with K6).  Then
// __syncwarp() and lane 0's release store of the MB's flag.  The
// bS/tc0/alpha/beta tables are computed for the whole frame beforehand
// (ops/deblock.py::deblock_tables).  Other warps write the planes during
// the launch, so they are never read through the non-coherent path.

#include "deblock_mb.cuh"
#include "wavefront.cuh"

namespace {

using deblock::DeblockArgs;

constexpr int kWarps = 8;              // workers per block

__global__ void __launch_bounds__(32 * kWarps)
deblock_phase_kernel(DeblockArgs a, const int32_t* __restrict__ order,
                     int* scratch, int B) {
  __shared__ int s_ticket[kWarps];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pl = lane < 16 ? 0 : (lane < 24 ? 1 : 2),
            k = lane < 16 ? lane : (lane - 16) & 7;
  const int n = a.mb_w * a.mb_h, total = B * n;
  for (;;) {
    if (lane == 0) s_ticket[w] = atomicAdd(scratch + total, 1);
    __syncwarp();
    const int tk = s_ticket[w];
    __syncwarp();                               // s_ticket[w] free again
    if (tk >= total) return;
    const int b = tk % B, mb = __ldg(order + tk / B);
    const int mx = mb % a.mb_w, my = mb / a.mb_w;
    int* ready = scratch + (long)b * n;
    if (lane < 2) {            // lane 0: left; lane 1: top-right, or top
      const int nx = lane == 0 ? mx - 1 : (mx + 1 < a.mb_w ? mx + 1 : mx);
      const int ny = my - lane;
      if (nx >= 0 && ny >= 0) wavefront::wait(ready + ny * a.mb_w + nx);
    }
    __syncwarp();
    for (int d = 0; d < 2; ++d) {               // 0 vertical, 1 horizontal
      deblock::deblock_line(a, b, pl, mx, my, d, k);
      __syncwarp();
    }
    if (lane == 0) wavefront::release(ready + mb);
  }
}

}  // namespace

extern "C" int deblock_phase_launch(
    uint8_t* y, uint8_t* cb, uint8_t* cr, const int32_t* bs_v,
    const int32_t* tc_v, const int32_t* a_v, const int32_t* b_v,
    const int32_t* bs_h, const int32_t* tc_h, const int32_t* a_h,
    const int32_t* b_h, const int32_t* bs_c, const int32_t* tc_c,
    const int32_t* a_c, const int32_t* b_c, const int32_t* order,
    int* scratch, int B, int mb_w, int mb_h, void* stream) {
  DeblockArgs a{y, cb, cr, bs_v, tc_v, a_v, b_v, bs_h, tc_h, a_h, b_h,
                bs_c, tc_c, a_c, b_c, mb_w, mb_h};
  const cudaStream_t s = (cudaStream_t)stream;
  const long total = (long)B * mb_w * mb_h;
  int grid = 0;
  cudaError_t err = wavefront::resident_grid(
      deblock_phase_kernel, 32 * kWarps, (total + kWarps - 1) / kWarps,
      &grid);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, (total + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  deblock_phase_kernel<<<grid, 32 * kWarps, 0, s>>>(a, order, scratch, B);
  return (int)cudaGetLastError();
}
