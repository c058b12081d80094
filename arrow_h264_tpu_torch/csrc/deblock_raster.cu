// In-loop deblocking filter (spec 8.7) in raster order within each MB row,
// rows pipelined, in place on uint8 planes: one persistent launch.
//
// Replaces: arrow_h264_tpu/ops/pallas/deblock_kernel.py::deblock_pallas
// (:287; pallas_call :303 luma, :322 chroma; grid bodies _luma_kernel and
// _chroma_kernel :230).  The TPU kernel walks one MB row per grid step and
// the MBs of the row in a loop, over an aligned, lane-rolled working tile
// per MB.
//
// What bounds it: the dependency chain, as for the intra kernel: a 1080p
// frame is a chain of mb_w + 2 * (mb_h - 1) = 254 MB steps (the lag rule
// below), and the bytes (~3 us at the card's memory rate) are far below
// that.
//
// What the design does about it: a worker, one warp (8 per block, as in
// deblock_phase.cu, K2), owns one MB row of one stream, all three planes.
// It takes the row as a ticket (wavefront.cuh: row by row, streams
// interleaved within a row) and filters the row left to right, the spec's
// own order, with K2's lane map and body: in the vertical pass lane
// t < 16 filters luma row t across the four vertical edges in order
// (x = 0, 4, 8, 12), lanes 16..31 the 8 rows of Cb and of Cr (x = 0, 4);
// after __syncwarp() the horizontal pass does the same down the columns
// (deblock_mb.cuh::deblock_line).  The step to the right stays inside the
// warp, so a hand-off between workers is paid only when a row catches up
// with the row above.
//
// The lag rule: before MB (mx, my), my > 0, lane 0 waits until row my - 1
// of its stream has finished MBs 0 .. min(mx + 1, mb_w - 1)
// (wavefront::wait_count), then __syncwarp().  The filter of (mx, my)
// touches its own samples, the 4 (chroma 2) right columns of (mx - 1, my),
// which this warp filtered before, and the bottom 4 (chroma 2) rows of
// (mx, my - 1).  Those rows are final once (mx, my - 1) and (mx + 1, my - 1)
// are filtered: the left-edge filter of (mx + 1, my - 1) writes the right
// columns of (mx, my - 1), and no later MB of row my - 1 touches them.  No
// write races a read: row my writes the samples of rows my and my - 1
// only, those of (mx, my - 1) after row my - 1 is done with them, and the
// worker of row my - 1 never touches a sample of row my; the worker of
// row my + 1 touches (mx', my) only after row my has finished mx' + 1,
// after which row my writes no sample of (mx', my) again.  Every MB waits,
// since the filter writes every MB.  After the body and __syncwarp(),
// lane 0 publishes the count (release).  The bS/tc0/alpha/beta tables are
// computed for the whole frame beforehand (ops/deblock.py::deblock_tables).
// Other warps write the planes during the launch, so they are never read
// through the non-coherent path.

#include "deblock_mb.cuh"
#include "wavefront.cuh"

namespace {

using deblock::DeblockArgs;

constexpr int kWarps = 8;              // workers per block

__global__ void __launch_bounds__(32 * kWarps)
deblock_raster_kernel(DeblockArgs a, int* scratch, int B) {
  __shared__ int s_ticket[kWarps];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pl = lane < 16 ? 0 : (lane < 24 ? 1 : 2),
            k = lane < 16 ? lane : (lane - 16) & 7;
  const int rows = B * a.mb_h;                  // (row, stream)
  for (;;) {
    if (lane == 0) s_ticket[w] = atomicAdd(scratch + rows, 1);
    __syncwarp();
    const int tk = s_ticket[w];
    __syncwarp();                               // s_ticket[w] free again
    if (tk >= rows) return;
    const int my = tk / B, b = tk % B;
    int* done = scratch + (long)b * a.mb_h;     // per row
    int seen = 0;                               // lane 0's
    for (int mx = 0; mx < a.mb_w; ++mx) {
      if (lane == 0 && my > 0)
        wavefront::wait_count(done + my - 1, min(mx + 2, a.mb_w), seen);
      __syncwarp();
      for (int d = 0; d < 2; ++d) {             // 0 vertical, 1 horizontal
        deblock::deblock_line(a, b, pl, mx, my, d, k);
        __syncwarp();
      }
      if (lane == 0) wavefront::publish(done + my, mx + 1);
    }
  }
}

}  // namespace

extern "C" int deblock_raster_launch(
    uint8_t* y, uint8_t* cb, uint8_t* cr, const int32_t* bs_v,
    const int32_t* tc_v, const int32_t* a_v, const int32_t* b_v,
    const int32_t* bs_h, const int32_t* tc_h, const int32_t* a_h,
    const int32_t* b_h, const int32_t* bs_c, const int32_t* tc_c,
    const int32_t* a_c, const int32_t* b_c, int* scratch, int B, int mb_w,
    int mb_h, void* stream) {
  DeblockArgs a{y, cb, cr, bs_v, tc_v, a_v, b_v, bs_h, tc_h, a_h, b_h,
                bs_c, tc_c, a_c, b_c, mb_w, mb_h};
  const cudaStream_t s = (cudaStream_t)stream;
  const long rows = (long)B * mb_h;
  int grid = 0;
  cudaError_t err = wavefront::resident_grid(
      deblock_raster_kernel, 32 * kWarps, (rows + kWarps - 1) / kWarps,
      &grid);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, (rows + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  deblock_raster_kernel<<<grid, 32 * kWarps, 0, s>>>(a, scratch, B);
  return (int)cudaGetLastError();
}
