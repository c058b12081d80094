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
// phase; luma and chroma as two chains, since neither plane's filter
// reads the other (the JAX package also filters them in separate
// pallas_calls), so the chroma body does not sit on the luma chain; and
// the MB body in shared memory (deblock_mb.cuh).  Each warp is a worker
// (8 per block; the grid what the card holds resident, but at most 4
// workers for each MB part of a knight phase): lane 0 takes a
// ticket in wavefront order (wavefront.cuh), which names a stream, an MB
// and a part, luma or chroma (the two parts of an MB take adjacent
// tickets).  The warp stages the part's own samples and table words into
// its buffer (cp.async, `stage`); lanes 0 and 1 wait for that part's
// ready flags of the left and the top-right neighbour (the top one in
// the last column; the top and top-left follow, since every MB waits on
// its own); after __syncwarp() the warp gathers the border, filters the
// tile in two passes and writes it back (`mb_body`); then __syncwarp()
// and lane 0's release store of the part's flag.  The bS/tc0/alpha/beta
// tables are computed for the whole frame beforehand
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
  __shared__ deblock::Buf s_buf[kWarps];
  __shared__ int s_ticket[kWarps];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  deblock::Buf& s = s_buf[w];
  const int n = a.mb_w * a.mb_h, total = 2 * B * n;   // luma + chroma
  for (;;) {
    if (lane == 0) s_ticket[w] = atomicAdd(scratch + total, 1);
    __syncwarp();
    const int tk = s_ticket[w];
    __syncwarp();                               // s_ticket[w] free again
    if (tk >= total) return;
    const int part = tk & 1, u = tk >> 1;       // part 0 luma, 1 chroma
    const int b = u % B, mb = __ldg(order + u / B);
    const int mx = mb % a.mb_w, my = mb / a.mb_w;
    int* ready = scratch + (long)(2 * b + part) * n;
    deblock::stage(a, s, b, mx, my, part, lane);
    if (lane < 2) {            // lane 0: left; lane 1: top-right, or top
      const int nx = lane == 0 ? mx - 1 : (mx + 1 < a.mb_w ? mx + 1 : mx);
      const int ny = my - lane;
      if (nx >= 0 && ny >= 0) wavefront::wait(ready + ny * a.mb_w + nx);
    }
    deblock::copy_wait<0>();
    __syncwarp();
    deblock::mb_body(a, s, b, mx, my, part, false, lane);
    __syncwarp();
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
  const long total = 2L * B * mb_w * mb_h;       // luma + chroma tickets
  // workers: at most 4 for each MB part that a knight phase holds; more
  // would only poll the flags of later phases, and their polls slow the
  // chain's own loads (tools/wavefront_probe.py, one_per_sm)
  const long phase = 2L * B * (mb_h < (mb_w + 1) / 2 ? mb_h : (mb_w + 1) / 2);
  const long workers = total < 4 * phase ? total : 4 * phase;
  int grid = 0;
  cudaError_t err = wavefront::resident_grid(
      deblock_phase_kernel, 32 * kWarps, (workers + kWarps - 1) / kWarps,
      &grid);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, (total + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  deblock_phase_kernel<<<grid, 32 * kWarps, 0, s>>>(a, order, scratch, B);
  return (int)cudaGetLastError();
}
