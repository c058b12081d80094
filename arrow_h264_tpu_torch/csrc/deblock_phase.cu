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
// __syncthreads() the horizontal pass does the same down the columns.
// Each thread owns its whole line, so the edges need no barrier between
// them.
//
// What bounds it: the dependency chain, as for the intra kernel.  An MB
// needs its left, top and top-right neighbours filtered (MB (r, c) reads
// the bottom rows of (r-1, c), whose right columns (r-1, c+1) writes), so
// a 1080p frame is 254 dependent phases; per MB there are a few hundred
// samples of work.  The design keeps each phase to one small launch and
// filters in place, so every sample moves through device memory once per
// edge that touches it.  The bS/tc0/alpha/beta tables are computed for
// the whole frame beforehand (ops/deblock.py::deblock_tables), so the
// kernel only filters samples; an edge with bS 0 reads nothing.
//
// Layouts (all contiguous):
//   y [B, H, W], cb/cr [B, H/2, W/2] uint8 (in place)
//   bs_v, tc_v, bs_h, tc_h [B, n, 4 (edge), 4 (segment)] int32
//   a_v, b_v, a_h, b_h [B, n, 4] int32
//   bs_c [B, n, 2 (dir), 2 (edge), 4]; tc_c [B, n, 2, 2, 4, 2 (plane)];
//   a_c, b_c [B, n, 2, 2, 2 (plane)] int32

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct DeblockArgs {
  uint8_t *y, *cb, *cr;
  const int32_t *bs_v, *tc_v, *a_v, *b_v, *bs_h, *tc_h, *a_h, *b_h;
  const int32_t *bs_c, *tc_c, *a_c, *b_c;
  int mb_w, mb_h;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int absi(int v) { return v < 0 ? -v : v; }

// q points at q0; p_k = q[-(k+1)*step], q_k = q[k*step] (8.7.2.3/8.7.2.4)
__device__ void filter_luma(uint8_t* q, int step, int bs, int tc0, int alpha,
                            int beta) {
  const int p0 = q[-step], p1 = q[-2 * step], p2 = q[-3 * step],
            p3 = q[-4 * step];
  const int q0 = q[0], q1 = q[step], q2 = q[2 * step], q3 = q[3 * step];
  if (!(absi(p0 - q0) < alpha && absi(p1 - p0) < beta &&
        absi(q1 - q0) < beta))
    return;
  const bool ap = absi(p2 - p0) < beta, aq = absi(q2 - q0) < beta;
  if (bs < 4) {
    const int tc = tc0 + ap + aq;
    const int delta = clampi((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc);
    q[-step] = (uint8_t)clampi(p0 + delta, 0, 255);
    q[0] = (uint8_t)clampi(q0 - delta, 0, 255);
    const int avg = (p0 + q0 + 1) >> 1;
    if (ap) q[-2 * step] = (uint8_t)(p1 + clampi((p2 + avg - (p1 << 1)) >> 1,
                                                 -tc0, tc0));
    if (aq) q[step] = (uint8_t)(q1 + clampi((q2 + avg - (q1 << 1)) >> 1,
                                            -tc0, tc0));
  } else {
    const bool strong = absi(p0 - q0) < ((alpha >> 2) + 2);
    if (strong && ap) {
      q[-step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
      q[-2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
      q[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
    } else {
      q[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    }
    if (strong && aq) {
      q[0] = (uint8_t)((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3);
      q[step] = (uint8_t)((q2 + q1 + q0 + p0 + 2) >> 2);
      q[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
    } else {
      q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    }
  }
}

__device__ void filter_chroma(uint8_t* q, int step, int bs, int tc0,
                              int alpha, int beta) {
  const int p0 = q[-step], p1 = q[-2 * step];
  const int q0 = q[0], q1 = q[step];
  if (!(absi(p0 - q0) < alpha && absi(p1 - p0) < beta &&
        absi(q1 - q0) < beta))
    return;
  if (bs < 4) {
    const int tc = tc0 + 1;
    const int delta = clampi((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc);
    q[-step] = (uint8_t)clampi(p0 + delta, 0, 255);
    q[0] = (uint8_t)clampi(q0 - delta, 0, 255);
  } else {
    q[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

__global__ void __launch_bounds__(32)
deblock_phase_kernel(DeblockArgs a, int phase, int my0) {
  const int my = my0 + blockIdx.x;
  const int mx = phase - 2 * my;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int W = a.mb_w * 16, H = a.mb_h * 16, Wc = W / 2, Hc = H / 2;
  const long mbo = (long)b * a.mb_w * a.mb_h + my * a.mb_w + mx;
  uint8_t* Y = a.y + (long)b * H * W;
  uint8_t* C = (t < 24 ? a.cb : a.cr) + (long)b * Hc * Wc;
  const int pl = t < 24 ? 0 : 1, k = (t - 16) & 7;   // chroma plane, line

  for (int d = 0; d < 2; ++d) {                 // 0 vertical, 1 horizontal
    if (t < 16) {
      const int32_t* bs = (d ? a.bs_h : a.bs_v) + mbo * 16;
      const int32_t* tc = (d ? a.tc_h : a.tc_v) + mbo * 16;
      const int32_t* al = (d ? a.a_h : a.a_v) + mbo * 4;
      const int32_t* be = (d ? a.b_h : a.b_v) + mbo * 4;
      for (int e = 0; e < 4; ++e) {
        const int seg = e * 4 + (t >> 2);
        if (bs[seg] == 0) continue;
        uint8_t* q = d ? Y + (long)(my * 16 + 4 * e) * W + mx * 16 + t
                       : Y + (long)(my * 16 + t) * W + mx * 16 + 4 * e;
        filter_luma(q, d ? W : 1, bs[seg], tc[seg], al[e], be[e]);
      }
    } else {
      for (int e = 0; e < 2; ++e) {
        const long de = (mbo * 2 + d) * 2 + e;     // [B, n, 2 (d), 2 (e)]
        const int bs = a.bs_c[de * 4 + (k >> 1)];
        if (bs == 0) continue;
        const int tc0 = a.tc_c[(de * 4 + (k >> 1)) * 2 + pl];
        uint8_t* q = d ? C + (long)(my * 8 + 4 * e) * Wc + mx * 8 + k
                       : C + (long)(my * 8 + k) * Wc + mx * 8 + 4 * e;
        filter_chroma(q, d ? Wc : 1, bs, tc0, a.a_c[de * 2 + pl],
                      a.b_c[de * 2 + pl]);
      }
    }
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
