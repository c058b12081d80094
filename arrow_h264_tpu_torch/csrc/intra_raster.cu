// Intra prediction + residual add for every intra MB (spec 8.3), in raster
// order within each MB row, rows pipelined: one persistent launch.
//
// Replaces: arrow_h264_tpu/ops/pallas/intra_kernel.py::intra_reconstruct_pallas
// (:355; pallas_call :392 luma, :410 chroma; grid bodies _luma_kernel :266
// and _chroma_kernel :320).  The TPU kernel walks one MB row per grid step
// and the MBs of the row in a loop, over an aligned, lane-rolled working
// tile per MB.
//
// What bounds it: the dependency chain, not bytes or operations.  An MB
// reads its left, top-left, top and top-right neighbours, so row my can
// run MB mx once row my - 1 has finished MB mx + 1: a 1080p frame is a
// chain of mb_w + 2 * (mb_h - 1) = 254 MB steps, as for the wavefront
// kernel intra_phase.cu (K1); the bytes (~5 us at the card's memory rate)
// are far below that.
//
// What the design does about it: a worker, one 256-thread block, owns one
// MB row of one stream and one part, luma or chroma (neither plane reads
// the other, so the chroma body stays off the luma chain, as in K1).  It
// takes the row as a ticket (wavefront.cuh: row by row, streams and parts
// interleaved within a row, so B > 1 fills the card) and walks the row
// left to right through the per-MB body of intra_mb.cuh: luma with 256
// threads, or both chroma planes with 64 threads each.  The step to the
// right stays inside the worker, so the flag hand-off between blocks
// (~1.5-1.9 us) is paid only when a row catches up with the row above.
//
// The lag rule: before intra MB (mx, my), my > 0, thread 0 waits until
// row my - 1 of its stream and part has finished MBs
// 0 .. min(mx + 1, mb_w - 1) (wavefront::wait_count), then a barrier; the
// left MB is this worker's own, finished before the barrier that ended
// its body.  That covers every read of the body: the last sample line of
// MBs mx - 1 .. mx + 1 of row my - 1, and the right column of MB mx - 1.
// No write races a read: a body writes only its own MB's samples; the
// worker of row my - 1 reads rows my - 2 and my - 1 only, never row my;
// the worker of row my + 1 reads an MB of row my only after row my's
// counter has passed it, and a finished MB is never written again.
// After the body a barrier, then thread 0 publishes the count (release).
// An inter MB waits for nothing and writes nothing: its samples are in
// the planes already (the wrapper copied the init planes on this stream
// before the launch); the worker passes it and publishes the count before
// its next wait and at the end of the row.  Other blocks write y/cb/cr
// during the launch, so the planes are never read through the
// non-coherent path (no __ldg or const __restrict__ on them); the ABI,
// residuals and tables may be.

#include "intra_mb.cuh"
#include "wavefront.cuh"

namespace {

using intra::IntraArgs;

__global__ void __launch_bounds__(256)
intra_raster_kernel(IntraArgs a, int* scratch, int B) {
  __shared__ int s_ticket;
  const int t = threadIdx.x;
  const int rows = 2 * B * a.mb_h;              // (row, stream, part)
  for (;;) {
    if (t == 0) s_ticket = atomicAdd(scratch + rows, 1);
    __syncthreads();
    const int tk = s_ticket;
    __syncthreads();                            // s_ticket free again
    if (tk >= rows) return;
    const int my = tk / (2 * B), b = (tk >> 1) % B, part = tk & 1;
    int* done = scratch + (long)(2 * b + part) * a.mb_h;  // per row
    const int32_t* kinds = a.kind + ((long)b * a.mb_h + my) * a.mb_w;
    int seen = 0, published = 0;                // thread 0's
    for (int mx = 0; mx < a.mb_w; ++mx) {
      const int kind = __ldg(kinds + mx);
      if (kind > intra::KIND_IPCM) continue;    // inter MB (uniform)
      if (t == 0) {
        if (published < mx) wavefront::publish(done + my, published = mx);
        if (my > 0)
          wavefront::wait_count(done + my - 1, min(mx + 2, a.mb_w), seen);
      }
      __syncthreads();
      if (part == 0)
        intra::intra_mb_luma(a, b, mx, my, kind, t);
      else
        intra::intra_mb_chroma(a, b, mx, my, kind, t >> 6, t & 63, t < 128);
      __syncthreads();
      if (t == 0) wavefront::publish(done + my, published = mx + 1);
    }
    if (t == 0 && published < a.mb_w) wavefront::publish(done + my, a.mb_w);
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
    const int32_t* w8, const int32_t* s8, const int32_t* r8, int* scratch,
    int B, int mb_w, int mb_h, void* stream) {
  IntraArgs a{kind, i4_modes, i4_avail, i8_modes, i8_avail, i16_mode,
              chroma_mode, mb_avail, res_y, res_cb, res_cr, y, cb, cr,
              w4, s4, r4, w8, s8, r8, mb_w, mb_h};
  const cudaStream_t s = (cudaStream_t)stream;
  const long rows = 2L * B * mb_h;              // luma + chroma row tickets
  int grid = 0;
  cudaError_t err = wavefront::resident_grid(intra_raster_kernel, 256, rows,
                                             &grid);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, (rows + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  intra_raster_kernel<<<grid, 256, 0, s>>>(a, scratch, B);
  return (int)cudaGetLastError();
}
