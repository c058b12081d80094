// The per-MB deblocking body (spec 8.7) shared by the deblock kernels: the
// knight-move wavefront (deblock_phase.cu, K2) and the raster walk
// (deblock_raster.cu, K6).  deblock_line filters one line of one MB across
// the edges of one direction, in order, in place: luma line k (0..15) of
// plane 0, or chroma line k (0..7) of Cb (plane 1) or Cr (plane 2).  A
// thread that owns a whole line needs no barrier between that line's
// edges; the callers put one between the vertical and the horizontal pass
// and, in the raster walk, between MBs.  bS/tc0/alpha/beta come from
// ops/deblock.py::deblock_tables, so the body has no coding-data logic; an
// edge with bS 0 reads nothing.
//
// Layouts (all contiguous):
//   y [B, H, W], cb/cr [B, H/2, W/2] uint8 (in place)
//   bs_v, tc_v, bs_h, tc_h [B, n, 4 (edge), 4 (segment)] int32
//   a_v, b_v, a_h, b_h [B, n, 4] int32
//   bs_c [B, n, 2 (dir), 2 (edge), 4]; tc_c [B, n, 2, 2, 4, 2 (plane)];
//   a_c, b_c [B, n, 2, 2, 2 (plane)] int32

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace deblock {

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
static __device__ void filter_luma(uint8_t* q, int step, int bs, int tc0,
                                   int alpha, int beta) {
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

static __device__ void filter_chroma(uint8_t* q, int step, int bs, int tc0,
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

// Direction d (0 vertical edges, 1 horizontal) of MB (mx, my) of stream b,
// line k of plane pl.
static __device__ void deblock_line(const DeblockArgs& a, int b, int pl,
                                    int mx, int my, int d, int k) {
  const int W = a.mb_w * 16, H = a.mb_h * 16, Wc = W / 2, Hc = H / 2;
  const long mbo = (long)b * a.mb_w * a.mb_h + my * a.mb_w + mx;
  if (pl == 0) {
    uint8_t* Y = a.y + (long)b * H * W;
    const int32_t* bs = (d ? a.bs_h : a.bs_v) + mbo * 16;
    const int32_t* tc = (d ? a.tc_h : a.tc_v) + mbo * 16;
    const int32_t* al = (d ? a.a_h : a.a_v) + mbo * 4;
    const int32_t* be = (d ? a.b_h : a.b_v) + mbo * 4;
    for (int e = 0; e < 4; ++e) {
      const int seg = e * 4 + (k >> 2);
      if (bs[seg] == 0) continue;
      uint8_t* q = d ? Y + (long)(my * 16 + 4 * e) * W + mx * 16 + k
                     : Y + (long)(my * 16 + k) * W + mx * 16 + 4 * e;
      filter_luma(q, d ? W : 1, bs[seg], tc[seg], al[e], be[e]);
    }
  } else {
    const int c = pl - 1;                       // chroma plane: 0 Cb, 1 Cr
    uint8_t* C = (c ? a.cr : a.cb) + (long)b * Hc * Wc;
    for (int e = 0; e < 2; ++e) {
      const long de = (mbo * 2 + d) * 2 + e;     // [B, n, 2 (d), 2 (e)]
      const int bs = a.bs_c[de * 4 + (k >> 1)];
      if (bs == 0) continue;
      const int tc0 = a.tc_c[(de * 4 + (k >> 1)) * 2 + c];
      uint8_t* q = d ? C + (long)(my * 8 + 4 * e) * Wc + mx * 8 + k
                     : C + (long)(my * 8 + k) * Wc + mx * 8 + 4 * e;
      filter_chroma(q, d ? Wc : 1, bs, tc0, a.a_c[de * 2 + c],
                    a.b_c[de * 2 + c]);
    }
  }
}

}  // namespace deblock
