// Intra prediction + residual add for every intra MB (spec 8.3), along the
// knight-move wavefront.
//
// Replaces: arrow_h264_tpu/ops/pallas/intra_phase.py::intra_phase_batch
// (:694; grid body _phase_kernel :557).  The TPU kernel walks the phases
// in one sequential grid over skewed, lane-packed blocks of all streams.
// Here the host loop launches one grid per phase: one 256-thread block per
// (stream, MB of the phase), which runs the per-MB body of intra_mb.cuh
// (luma, then both chroma planes with 64 threads each).
//
// What bounds it: the dependency chain, not bytes or operations.  A
// 1080p frame is mb_w + 2*(mb_h - 1) = 254 phases of at most 60 MBs
// each, so most of the card idles and each phase costs a launch.  The
// design accepts that for now: every sample is read and written once per
// frame, neighbours come straight from the output plane (the previous
// phases wrote them), and a phase launch costs a few microseconds.  CUDA
// graphs or a persistent kernel with per-MB ready flags would remove the
// launch gaps.
//
// Inter MBs' blocks return at once: their samples arrive already
// reconstructed in the planes (MC + residual) and serve as neighbours.

#include "intra_mb.cuh"

namespace {

using intra::IntraArgs;

__global__ void __launch_bounds__(256)
intra_phase_kernel(IntraArgs a, int phase, int my0) {
  const int my = my0 + blockIdx.x;
  const int mx = phase - 2 * my;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int kind = a.kind[(long)b * a.mb_w * a.mb_h + my * a.mb_w + mx];
  if (kind > intra::KIND_IPCM) return;          // inter MB (uniform per block)
  intra::intra_mb_luma(a, b, mx, my, kind, t);
  intra::intra_mb_chroma(a, b, mx, my, kind, t >> 6, t & 63, t < 128);
}

}  // namespace

extern "C" int intra_phase_launch(
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
  const int n_phases = mb_w + 2 * (mb_h - 1);
  for (int p = 0; p < n_phases; ++p) {
    // MB rows of phase p: mx = p - 2*my in [0, mb_w)
    const int my0 = p - mb_w + 1 > 0 ? (p - mb_w + 2) / 2 : 0;
    const int my1 = p / 2 < mb_h - 1 ? p / 2 : mb_h - 1;
    const dim3 grid(my1 - my0 + 1, B);
    intra_phase_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(a, p, my0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
