// Intra prediction + residual add for every intra MB (spec 8.3), along the
// knight-move wavefront, in one persistent launch.
//
// Replaces: arrow_h264_tpu/ops/pallas/intra_phase.py::intra_phase_batch
// (:694; grid body _phase_kernel :557).  The TPU kernel walks the phases
// in one sequential grid over skewed, lane-packed blocks of all streams.
//
// What bounds it: the dependency chain, not bytes or operations.  An MB
// reads its left, top-left, top and top-right neighbours, so a 1080p
// frame is a chain of mb_w + 2 * (mb_h - 1) = 254 dependent MB steps; the
// bytes (~5 us at the card's memory rate) are far below that.  The floor
// is about 254 x (one MB body + one flag hand-off); on an H100 the I4x4
// luma bodies on the chain take most of it (tools/wavefront_probe.py
// times the kernel without waits, without bodies, without one plane, and
// on frames of one MB kind).
//
// What the design does about it: one launch per call instead of one per
// phase, so no launch gap sits between the steps of the chain; and luma
// and chroma as separate chains, since neither plane reads the other, so
// the chroma body does not sit on the luma chain.  The grid is what the
// card holds resident; each 128-thread block loops: it takes a ticket
// (wavefront.cuh), which names a stream, an MB in wavefront order and a
// part, luma or chroma (the two parts of an MB take adjacent tickets);
// it waits for the ready flags of that part of the MB's neighbours, runs
// that part's per-MB body of intra_mb.cuh (luma, or both chroma planes),
// and sets the part's flag.
// Streams interleave in the ticket order, so B > 1 fills the card.
//
// Per intra MB (tk names it): warps 1-3 stage its residual and ABI words
// and warp 1 builds warp 0's descriptors (intra_mb.cuh: stage, describe)
// while threads 0-3 wait on the ready flags of that part of the four
// neighbours (wavefront::wait ends in an acquire fence); a barrier;
// the body gathers the neighbour border into shared memory and warp 0
// reconstructs the MB there and writes it once; a barrier, then thread
// 0's release store publishes the block's writes.
//
// Waits: an intra MB waits on each of its four neighbours that exists,
// not on left and top-right only with top and top-left following from
// theirs, because an inter MB sets its flags at once without waiting: its
// samples are in the planes already (the wrapper copied the init planes
// on this stream before the launch).  Its flags only say that it will
// not write.  No thread reads a neighbour sample before the barrier that
// follows the waits.  Other blocks write y/cb/cr during the launch, so
// the planes are never read through the non-coherent path (no __ldg or
// const __restrict__ on them); the ABI, residuals and tables may be.

#include "intra_mb.cuh"
#include "wavefront.cuh"

namespace {

using intra::IntraArgs;

__global__ void __launch_bounds__(intra::THREADS)
intra_phase_kernel(IntraArgs a, const int32_t* __restrict__ order,
                   int* scratch, int B) {
  __shared__ intra::Shared sm;
  const int t = threadIdx.x;
  const int n = a.mb_w * a.mb_h, total = 2 * B * n;   // luma + chroma
  const int buf = 0;                           // one MB at a time
  intra::load_tables(a, sm, t);
  for (;;) {
    if (t == 0) sm.ticket = atomicAdd(scratch + total, 1);
    __syncthreads();
    const int tk = sm.ticket;
    __syncthreads();                            // ticket free again
    if (tk >= total) return;
    const int part = tk & 1, u = tk >> 1;       // part 0 luma, 1 chroma
    const int b = u % B, mb = __ldg(order + u / B);
    const int mx = mb % a.mb_w, my = mb / a.mb_w;
    int* ready = scratch + (long)(2 * b + part) * n;
    const int kind = __ldg(a.kind + (long)b * n + mb);
    if (kind <= intra::KIND_IPCM) {             // intra MB (uniform)
      intra::stage(a, sm, buf, b, mx, my, kind, part, t);
      intra::describe(sm, buf, kind, part, t);
      intra::land(t);
      if (t < 4) {                    // left, top-left, top, top-right
        const int nx = mx + (t == 0 ? -1 : t - 2), ny = my - (t > 0);
        if (nx >= 0 && nx < a.mb_w && ny >= 0)
          wavefront::wait(ready + ny * a.mb_w + nx);
      }
      __syncthreads();
      if (part == 0)
        intra::intra_mb_luma(a, sm, buf, b, mx, my, kind, t);
      else
        intra::intra_mb_chroma(a, sm, buf, b, mx, my, kind, t);
      __syncthreads();
    }
    if (t == 0) wavefront::release(ready + mb);
  }
}

}  // namespace

extern "C" int intra_phase_launch(
    const int32_t* kind, const int32_t* i4_modes, const int32_t* i4_avail,
    const int32_t* i8_modes, const int32_t* i8_avail,
    const int32_t* i16_mode, const int32_t* chroma_mode,
    const int32_t* mb_avail, const int32_t* res_y, const int32_t* res_cb,
    const int32_t* res_cr, uint8_t* y, uint8_t* cb, uint8_t* cr,
    const int32_t* tabs, const int32_t* order, int* scratch, int B,
    int mb_w, int mb_h, void* stream) {
  IntraArgs a{kind, i4_modes, i4_avail, i8_modes, i8_avail, i16_mode,
              chroma_mode, mb_avail, res_y, res_cb, res_cr, y, cb, cr,
              tabs, mb_w, mb_h};
  const cudaStream_t s = (cudaStream_t)stream;
  const long total = 2L * B * mb_w * mb_h;      // luma + chroma tickets
  int grid = 0;
  cudaError_t err = wavefront::resident_grid(intra_phase_kernel,
                                             intra::THREADS, total, &grid);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, (total + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  intra_phase_kernel<<<grid, intra::THREADS, 0, s>>>(a, order, scratch, B);
  return (int)cudaGetLastError();
}
