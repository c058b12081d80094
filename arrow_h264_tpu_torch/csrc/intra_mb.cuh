// The per-MB intra body (spec 8.3) shared by the intra kernels: the
// knight-move wavefront (intra_phase.cu, K1) and the raster walk
// (intra_raster.cu, K5).  Both call intra_mb_luma with a 256-thread block
// and intra_mb_chroma with 64 threads per chroma plane, for one intra/PCM
// MB whose left, top, top-left and top-right neighbours are already final
// in the output planes.  Each function holds __syncthreads() between its
// sub-steps, so every thread of the block must call it.
//
// Luma: 256 threads hold the 16x16 samples.  I16x16 and PCM fill them in
// one step, I4x4 walks the ten sub-steps 2*y4 + x4 (16 threads per 4x4
// block), I8x8 the four 8x8 blocks in order.  Directional 4x4/8x8 modes
// use the linear weight tables of ops/intra_tables.py:
// pred = (W . v + R) >> S over the reference vector
// v = (top-left, top[2N], left[N]).  Samples outside the picture read as
// 0, as in ops/intra.py.
//
// Layouts (all contiguous int32 unless noted):
//   kind, i16_mode, chroma_mode [B, n]; i4_modes [B, n, 16];
//   i4_avail [B, n, 16, 4]; i8_modes [B, n, 4]; i8_avail [B, n, 4, 4];
//   mb_avail [B, n, 3]   (avail = left, top, top-left, top-right)
//   res_y [B, H, W], res_cb/res_cr [B, H/2, W/2]
//   y [B, H, W], cb/cr [B, H/2, W/2] uint8, updated in place
//   w4 [9, 16, 13], s4/r4 [9, 16], w8 [9, 64, 25], s8/r8 [9, 64]

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace intra {

constexpr int KIND_I4x4 = 0, KIND_I8x8 = 1, KIND_I16 = 2, KIND_IPCM = 3;

struct IntraArgs {
  const int32_t *kind, *i4_modes, *i4_avail, *i8_modes, *i8_avail;
  const int32_t *i16_mode, *chroma_mode, *mb_avail;
  const int32_t *res_y, *res_cb, *res_cr;
  uint8_t *y, *cb, *cr;
  const int32_t *w4, *s4, *r4, *w8, *s8, *r8;
  int mb_w, mb_h;
};

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// sample of a plane, 0 outside the picture
__device__ __forceinline__ int px(const uint8_t* p, int H, int W, int y,
                                  int x) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? p[y * W + x] : 0;
}

__device__ __forceinline__ int dc_of(int st, int sl, bool al, bool at,
                                     int shift) {
  // shift = log2(2N): both sides (st + sl + N) >> shift, one side >> shift-1
  const int n = 1 << (shift - 1);
  if (at && al) return (st + sl + n) >> shift;
  if (al) return (sl + (n >> 1)) >> (shift - 1);
  if (at) return (st + (n >> 1)) >> (shift - 1);
  return 128;
}

// Luma of intra/PCM MB (mx, my) of stream b; t = threadIdx.x in 0..255.
static __device__ void intra_mb_luma(const IntraArgs& a, int b, int mx,
                                     int my, int kind, int t) {
  const int W = a.mb_w * 16, H = a.mb_h * 16;
  const long mbo = (long)b * a.mb_w * a.mb_h + my * a.mb_w + mx;
  uint8_t* Y = a.y + (long)b * H * W;
  const int32_t* RY = a.res_y + (long)b * H * W;
  const int x0 = mx * 16, y0 = my * 16;

  __shared__ int s_ref[16][13];     // I4x4: per block (tl, top8, left4)
  __shared__ int s_raw[25], s_flt[25];           // I8x8: (tl, top16, left8)
  __shared__ int s_top[16], s_left[16], s_tl;   // I16x16

  if (kind == KIND_IPCM) {
    const int yy = y0 + (t >> 4), xx = x0 + (t & 15);
    Y[yy * W + xx] = (uint8_t)RY[yy * W + xx];
  } else if (kind == KIND_I16) {
    const int32_t* av = a.mb_avail + mbo * 3;
    const bool al = av[0] > 0, at = av[1] > 0, atl = av[2] > 0;
    if (t < 16) {
      s_top[t] = at ? px(Y, H, W, y0 - 1, x0 + t) : 0;
      s_left[t] = al ? px(Y, H, W, y0 + t, x0 - 1) : 0;
    }
    if (t == 0) s_tl = atl ? px(Y, H, W, y0 - 1, x0 - 1) : 0;
    __syncthreads();
    const int r = t >> 4, c = t & 15;
    const int mode = a.i16_mode[mbo];
    int pred;
    if (mode == 0) {
      pred = s_top[c];
    } else if (mode == 1) {
      pred = s_left[r];
    } else if (mode == 2) {
      int st = 0, sl = 0;
      for (int i = 0; i < 16; ++i) {
        st += s_top[i];
        sl += s_left[i];
      }
      pred = dc_of(st, sl, al, at, 5);
    } else {
      int hh = 0, vv = 0;
      for (int i = 0; i < 8; ++i) {
        hh += (i + 1) * (s_top[8 + i] - (i < 7 ? s_top[6 - i] : s_tl));
        vv += (i + 1) * (s_left[8 + i] - (i < 7 ? s_left[6 - i] : s_tl));
      }
      const int aa = 16 * (s_left[15] + s_top[15]);
      const int bb = (5 * hh + 32) >> 6, cc = (5 * vv + 32) >> 6;
      pred = clip255((aa + bb * (c - 7) + cc * (r - 7) + 16) >> 5);
    }
    const int o = (y0 + r) * W + x0 + c;
    Y[o] = (uint8_t)clip255(pred + RY[o]);
  } else if (kind == KIND_I4x4) {
    const int g = t >> 4, q = t & 15;           // block (raster) and sample
    const int x4 = g & 3, y4 = g >> 2;
    const int bx = x0 + 4 * x4, by = y0 + 4 * y4;
    const int32_t* av = a.i4_avail + (mbo * 16 + g) * 4;
    const bool al = av[0] > 0, at = av[1] > 0, atl = av[2] > 0,
               atr = av[3] > 0;
    const int mode = a.i4_modes[mbo * 16 + g];
    for (int s = 0; s < 10; ++s) {
      const bool act = 2 * y4 + x4 == s;
      if (act && q < 13) {
        int v;
        if (q == 0) {
          v = atl ? px(Y, H, W, by - 1, bx - 1) : 0;
        } else if (q <= 8) {
          const int i = q - 1;
          v = !at ? 0 : px(Y, H, W, by - 1, bx + (i >= 4 && !atr ? 3 : i));
        } else {
          v = al ? px(Y, H, W, by + q - 9, bx - 1) : 0;
        }
        s_ref[g][q] = v;
      }
      __syncthreads();
      if (act) {
        const int* v = s_ref[g];
        int pred;
        if (mode == 2) {
          pred = dc_of(v[1] + v[2] + v[3] + v[4], v[9] + v[10] + v[11] + v[12],
                       al, at, 3);
        } else {
          const int32_t* w = a.w4 + (mode * 16 + q) * 13;
          int acc = 0;
          for (int i = 0; i < 13; ++i) acc += w[i] * v[i];
          pred = (acc + a.r4[mode * 16 + q]) >> a.s4[mode * 16 + q];
        }
        const int o = (by + (q >> 2)) * W + bx + (q & 3);
        Y[o] = (uint8_t)clip255(pred + RY[o]);
      }
      __syncthreads();
    }
  } else if (kind == KIND_I8x8) {
    for (int b8 = 0; b8 < 4; ++b8) {
      const int bx = x0 + 8 * (b8 & 1), by = y0 + 8 * (b8 >> 1);
      const int32_t* av = a.i8_avail + (mbo * 4 + b8) * 4;
      const bool al = av[0] > 0, at = av[1] > 0, atl = av[2] > 0,
                 atr = av[3] > 0;
      if (t < 25) {
        int v;
        if (t == 0) {
          v = atl ? px(Y, H, W, by - 1, bx - 1) : 0;
        } else if (t <= 16) {
          const int i = t - 1;
          v = !at ? 0 : px(Y, H, W, by - 1, bx + (i >= 8 && !atr ? 7 : i));
        } else {
          v = al ? px(Y, H, W, by + t - 17, bx - 1) : 0;
        }
        s_raw[t] = v;
      }
      __syncthreads();
      if (t < 25) {                             // reference filter 8.3.2.2.1
        const int* r = s_raw;
        const int tl = r[0];
        const int* tp = r + 1;
        const int* lf = r + 17;
        int f;
        if (t == 0) {
          if (!atl) f = tl;
          else if (at && al) f = (tp[0] + 2 * tl + lf[0] + 2) >> 2;
          else if (at) f = (3 * tl + tp[0] + 2) >> 2;
          else if (al) f = (3 * tl + lf[0] + 2) >> 2;
          else f = tl;
        } else if (t <= 16) {
          const int x = t - 1;
          if (!at) f = tp[x];
          else if (x == 0)
            f = atl ? (tl + 2 * tp[0] + tp[1] + 2) >> 2
                    : (3 * tp[0] + tp[1] + 2) >> 2;
          else if (x == 15) f = (tp[14] + 3 * tp[15] + 2) >> 2;
          else f = (tp[x - 1] + 2 * tp[x] + tp[x + 1] + 2) >> 2;
        } else {
          const int yy = t - 17;
          if (!al) f = lf[yy];
          else if (yy == 0)
            f = atl ? (tl + 2 * lf[0] + lf[1] + 2) >> 2
                    : (3 * lf[0] + lf[1] + 2) >> 2;
          else if (yy == 7) f = (lf[6] + 3 * lf[7] + 2) >> 2;
          else f = (lf[yy - 1] + 2 * lf[yy] + lf[yy + 1] + 2) >> 2;
        }
        s_flt[t] = f;
      }
      __syncthreads();
      if (t < 64) {
        const int mode = a.i8_modes[mbo * 4 + b8];
        const int* v = s_flt;
        int pred;
        if (mode == 2) {
          int st = 0, sl = 0;
          for (int i = 0; i < 8; ++i) {
            st += v[1 + i];
            sl += v[17 + i];
          }
          pred = dc_of(st, sl, al, at, 4);
        } else {
          const int32_t* w = a.w8 + (mode * 64 + t) * 25;
          int acc = 0;
          for (int i = 0; i < 25; ++i) acc += w[i] * v[i];
          pred = (acc + a.r8[mode * 64 + t]) >> a.s8[mode * 64 + t];
        }
        const int o = (by + (t >> 3)) * W + bx + (t & 7);
        Y[o] = (uint8_t)clip255(pred + RY[o]);
      }
      __syncthreads();
    }
  }
}

// Chroma plane pl (0 Cb, 1 Cr) of intra/PCM MB (mx, my) of stream b (PCM
// predicts 0); the threads with `active` hold sample q in 0..63.
static __device__ void intra_mb_chroma(const IntraArgs& a, int b, int mx,
                                       int my, int kind, int pl, int q,
                                       bool active) {
  __shared__ int s_c[2][17];                    // (tl, top8, left8)
  const int Hc = a.mb_h * 8, Wc = a.mb_w * 8;
  const long mbo = (long)b * a.mb_w * a.mb_h + my * a.mb_w + mx;
  const int xc = mx * 8, yc = my * 8;
  const int32_t* av = a.mb_avail + mbo * 3;
  const bool al = av[0] > 0, at = av[1] > 0, atl = av[2] > 0;
  uint8_t* C = (pl == 0 ? a.cb : a.cr) + (long)b * Hc * Wc;
  const int32_t* RC = (pl == 0 ? a.res_cb : a.res_cr) + (long)b * Hc * Wc;
  if (active && q < 17) {
    int v;
    if (q == 0) v = atl ? px(C, Hc, Wc, yc - 1, xc - 1) : 0;
    else if (q <= 8) v = at ? px(C, Hc, Wc, yc - 1, xc + q - 1) : 0;
    else v = al ? px(C, Hc, Wc, yc + q - 9, xc - 1) : 0;
    s_c[pl][q] = v;
  }
  __syncthreads();
  if (active) {
    const int* v = s_c[pl];
    const int tl = v[0];
    const int* tp = v + 1;
    const int* lf = v + 9;
    const int r = q >> 3, c = q & 7;
    int pred = 0;
    if (kind != KIND_IPCM) {
      const int mode = a.chroma_mode[mbo];
      if (mode == 0) {                           // DC per 4x4 sub-block
        const int sbx = c >> 2, sby = r >> 2;
        const int st = tp[4 * sbx] + tp[4 * sbx + 1] + tp[4 * sbx + 2] +
                       tp[4 * sbx + 3];
        const int sl = lf[4 * sby] + lf[4 * sby + 1] + lf[4 * sby + 2] +
                       lf[4 * sby + 3];
        const int both = (st + sl + 4) >> 3, tonly = (st + 2) >> 2,
                  lonly = (sl + 2) >> 2;
        if (sbx == sby) {                        // (0,0) and (1,1)
          pred = at && al ? both : (al ? lonly : (at ? tonly : 128));
        } else if (sbx > 0) {                    // top-right: top first
          pred = at ? tonly : (al ? lonly : 128);
        } else {                                 // bottom-left: left first
          pred = al ? lonly : (at ? tonly : 128);
        }
      } else if (mode == 1) {
        pred = lf[r];
      } else if (mode == 2) {
        pred = tp[c];
      } else {
        int hh = 0, vv = 0;
        for (int i = 0; i < 4; ++i) {
          hh += (i + 1) * (tp[4 + i] - (i < 3 ? tp[2 - i] : tl));
          vv += (i + 1) * (lf[4 + i] - (i < 3 ? lf[2 - i] : tl));
        }
        const int aa = 16 * (lf[7] + tp[7]);
        const int bb = (34 * hh + 32) >> 6, cc = (34 * vv + 32) >> 6;
        pred = clip255((aa + bb * (c - 3) + cc * (r - 3) + 16) >> 5);
      }
    }
    const int o = (yc + r) * Wc + xc + c;
    C[o] = (uint8_t)clip255(pred + RC[o]);
  }
}

}  // namespace intra
