// The per-MB intra body (spec 8.3) shared by the intra kernels: the
// knight-move wavefront (intra_phase.cu, K1) and the raster walk
// (intra_raster.cu, K5).  A worker is one 128-thread block; it
// reconstructs one part, luma or both chroma planes, of one intra/PCM MB
// whose left, top, top-left and top-right neighbours are final in the
// output planes once the worker's wait has ended.
//
// What bounds it: the chain of dependent MBs (see the kernels), so what
// counts is the latency of one body from the end of the wait to the
// release.  The body keeps that short:
//   1. Before the wait, the worker stages what no neighbour writes
//      (`stage`, `land`): the MB's residual tile (16-byte cp.async
//      copies, 1 KB luma or 2 x 256 B chroma), its ABI words (modes and
//      availability), and warp 1 turns them into one descriptor a lane
//      and sub-step for warp 0 (`describe`).  K5 stages MB mx + 1 into
//      the other of two buffers before MB mx's wait, and describes it
//      while warp 0 runs MB mx.
//   2. After the wait, warps 1-3 gather the neighbour border once, from
//      the global plane into a shared tile (barrier B): the top-left
//      sample, 16 top and 8 top-right samples, 16 left samples, and the
//      right neighbour's samples that a 4x4/8x8 block with top-right
//      availability reads inside the MB row (rows 3, 7, 11).  Samples
//      outside the picture read as 0.
//   3. Warp 0 alone runs the sub-steps on the tile, with __syncwarp() in
//      place of block barriers: I4x4 the ten sub-steps 2*y4 + x4 (the
//      lane map, `LANES`, gives each lane its 4x4 block and sample in a
//      sub-step: at most two blocks, 32 samples), I8x8 the four 8x8
//      blocks in order (raw references, the 8.3.2.2.1 filter, then two
//      samples a lane), I16x16 and PCM one row a lane.  No sub-step goes
//      through global memory.
//   4. Lanes 0-15 write the finished MB to the plane, one 16-byte store a
//      luma row (8 bytes a chroma row); then the caller's barrier and
//      release.
//
// Directional 4x4/8x8 modes use the tables of ops/intra_tables.py,
// pred = (W . v + R) >> S over the reference vector v = (top-left,
// top[2N], left[N]), packed by the wrapper
// (ops/kernels/intra_phase.py::intra_tables): every row of W has at most
// three non-zero weights, each 0..3, so one word a (mode, sample) holds
// three indices into v (5 bits each), their weights (2 bits each), R and
// S (2 bits each).  A 4x4 descriptor turns each index into an offset of
// the tile, or of a zero cell where the reference is unavailable.
//
// Layouts (all contiguous int32 unless noted):
//   kind, i16_mode, chroma_mode [B, n]; i4_modes [B, n, 16];
//   i4_avail [B, n, 16, 4]; i8_modes [B, n, 4]; i8_avail [B, n, 4, 4];
//   mb_avail [B, n, 3]   (avail = left, top, top-left, top-right)
//   res_y [B, H, W], res_cb/res_cr [B, H/2, W/2], 16-byte aligned
//   y [B, H, W], cb/cr [B, H/2, W/2] uint8, updated in place
//   tabs [TAB_WORDS]: taps4 [9, 16], taps8 [9, 64], lanes [10, 32]

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#if !defined(__CUDA_ARCH__)
#include <string.h>
#endif

namespace intra {

constexpr int KIND_I4x4 = 0, KIND_I8x8 = 1, KIND_I16 = 2, KIND_IPCM = 3;

// the wrapper's table (ops/kernels/intra_phase.py): packed 4x4 and 8x8
// taps, then the I4x4 lane map: (block << 4 | sample) or -1 per
// (sub-step, lane)
constexpr int TAPS4 = 0, TAPS8 = 9 * 16, LANES = TAPS8 + 9 * 64,
              TAB_WORDS = LANES + 10 * 32;

// The luma tile: row 0 is the sample line above the MB, row 1 + r its
// line r; column TX + c is x0 + c for c in -1..23.  Rows are 16-byte
// aligned for the write-back.  ZERO is a cell that holds 0.
constexpr int TS = 36, TX = 4, ZERO = 17 * TS, TILE_WORDS = ZERO + 4;

// a stage's ABI words
constexpr int A_I4M = 0, A_I4A = 16, A_I8M = 80, A_I8A = 84, A_I16 = 100,
              A_MBA = 101, A_CHM = 104, ABI_WORDS = 108;

// descriptor word d1: out offset | DC | at | al | w0 w1 w2 | R | S | idle
constexpr uint32_t D_DC = 1u << 10, D_AT = 1u << 11, D_AL = 1u << 12,
                   D_IDLE = 1u << 31;

constexpr int THREADS = 128;         // a worker: warps 0-3
constexpr int STAGERS = 32;          // warps 1-3 stage and gather

struct IntraArgs {
  const int32_t *kind, *i4_modes, *i4_avail, *i8_modes, *i8_avail;
  const int32_t *i16_mode, *chroma_mode, *mb_avail;
  const int32_t *res_y, *res_cb, *res_cr;
  uint8_t *y, *cb, *cr;
  const int32_t* tabs;
  int mb_w, mb_h;
};

// What an MB needs that no neighbour writes.
struct alignas(16) Stage {
  int4 res[64];          // residual: luma [16][16] or chroma [2][8][8]
  uint2 desc[10][32];    // warp 0's descriptors (d0, d1) per slot, lane
  int abi[ABI_WORDS];
};

struct alignas(16) Shared {
  Stage stage[2];
  alignas(16) int tile[TILE_WORDS];  // chroma: [2][17] (tl, top8, left8)
  int ref8[2][32];       // I8x8: raw and filtered references
  int tab[TAB_WORDS];
  int ticket;
};

// 4- or 16-byte copy global -> shared without holding registers
// (cp.async, sm_80+); copy_wait ends this thread's copies.  Compiled
// for the host (a CPU build of the kernels for debugging), plain copies.
template <int N>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
#else
  memcpy(dst, src, N);
#endif
}

__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

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

// d1 of a DC sample: (sum of the available sides + R) >> S, where
// k sides are available; 128 (R = 128, S = 0) if none.  logn = log2(N).
__device__ __forceinline__ uint32_t dc_word(bool at, bool al, int logn) {
  const int k = at + al, s = k ? k + logn - 1 : 0, r = k ? 1 << (s - 1)
                                                         : 128;
  return D_DC | (at ? D_AT : 0) | (al ? D_AL : 0) | (uint32_t)r << 19 |
         (uint32_t)s << 27;
}

// weights, R and S of a packed tap word, moved to their places in d1
__device__ __forceinline__ uint32_t tap_word(uint32_t w) {
  return ((w >> 15) & 63) << 13 | ((w >> 21) & 3) << 19 |
         ((w >> 23) & 3) << 27;
}

__device__ __forceinline__ int apply(uint32_t d1, int acc) {
  return (acc + (int)((d1 >> 19) & 255)) >> ((d1 >> 27) & 7);
}

// four samples -> four bytes (their low 8 bits)
__device__ __forceinline__ uint32_t pack4(int4 v) {
  return (uint32_t)(v.x & 255) | (uint32_t)(v.y & 255) << 8 |
         (uint32_t)(v.z & 255) << 16 | (uint32_t)(v.w & 255) << 24;
}

// Once per block: the tables into shared memory; the caller's next
// barrier publishes them.
__device__ __forceinline__ void load_tables(const IntraArgs& a, Shared& sm,
                                            int t) {
  for (int i = t; i < TAB_WORDS; i += blockDim.x) sm.tab[i] = __ldg(a.tabs + i);
  if (t < TILE_WORDS - ZERO) sm.tile[ZERO + t] = 0;
}

// Warps 1-3 start the copies of MB (mx, my)'s ABI words (warp 1) and
// residual (threads 64-127) into stage buffer `buf`.  The other threads
// return at once.
__device__ __forceinline__ void stage(const IntraArgs& a, Shared& sm,
                                      int buf, int b, int mx, int my,
                                      int kind, int part, int t) {
  Stage& st = sm.stage[buf];
  const long mbo = (long)b * a.mb_w * a.mb_h + my * a.mb_w + mx;
  if (t >= 32 && t < 64) {                     // ABI words
    int lo = 0, hi = 0;
    if (part == 1) {
      if (kind != KIND_IPCM) lo = A_MBA, hi = A_CHM + 1;
    } else if (kind == KIND_I4x4) {
      lo = A_I4M, hi = A_I8M;
    } else if (kind == KIND_I8x8) {
      lo = A_I8M, hi = A_I16;
    } else if (kind == KIND_I16) {
      lo = A_I16, hi = A_CHM;
    }
    for (int k = lo + t - 32; k < hi; k += 32) {
      const int32_t* src =
          k < A_I4A   ? a.i4_modes + mbo * 16 + k
          : k < A_I8M ? a.i4_avail + mbo * 64 + (k - A_I4A)
          : k < A_I8A ? a.i8_modes + mbo * 4 + (k - A_I8M)
          : k < A_I16 ? a.i8_avail + mbo * 16 + (k - A_I8A)
          : k < A_MBA ? a.i16_mode + mbo
          : k < A_CHM ? a.mb_avail + mbo * 3 + (k - A_MBA)
                      : a.chroma_mode + mbo;
      copy_async<4>(st.abi + k, src);
    }
  } else if (t >= 64 && t < 128) {             // residual, 16 bytes a copy
    const int i = t - 64;
    if (part == 0) {
      const int W = a.mb_w * 16, H = a.mb_h * 16;
      const int row = i >> 2;
      copy_async<16>(st.res + i, a.res_y + (long)b * H * W +
                                     (long)(my * 16 + row) * W + mx * 16 +
                                     4 * (i & 3));
    } else if (i < 32) {
      const int Wc = a.mb_w * 8, Hc = a.mb_h * 8;
      const int32_t* rc = (i < 16 ? a.res_cb : a.res_cr) + (long)b * Hc * Wc;
      const int row = (i >> 1) & 7;
      copy_async<16>(st.res + i,
                     rc + (long)(my * 8 + row) * Wc + mx * 8 + 4 * (i & 1));
    }
  }
}

// tile offset of entry i of a 4x4/8x8 block's reference vector
// (tl, top[2N], left[N]) at MB-relative (bx, by): the substitutions of
// ops/intra.py (top-right = top[N-1] without atr, 0 when unavailable)
__device__ __forceinline__ int ref_offset(int i, int n, int bx, int by,
                                          bool al, bool at, bool atl,
                                          bool atr) {
  // selects, not branches: the lanes of a warp take different entries
  const bool left = i > 2 * n, top = i > 0 && !left;
  const int j = i - 1 >= n && !atr ? n - 1 : i - 1;
  const int row = left ? by + i - 2 * n : by;
  const int col = top ? bx + j : bx - 1;
  const bool ok = left ? al : (top ? at : atl);
  return ok ? row * TS + TX + col : ZERO;
}

// Warps 2-3: this thread's residual copies have landed.  The caller's
// barrier publishes them.
__device__ __forceinline__ void land(int t) {
  if (t >= 64) copy_wait();
}

// Warp 1: its ABI copies into stage buffer `buf` have landed, and for an
// I4x4 or I8x8 luma part it builds warp 0's descriptors there.  The
// caller's barrier publishes them.
//   I4x4, slot s = sub-step: d0 = three tap offsets (10 bits each) or,
//   for DC, the offsets of the top and left lines; d1 as D_*.
//   I8x8, slot 2 * b8 + h = sample lane + 32 h of block b8: d0 = three
//   indices into the filtered references; slot 8: each lane's raw
//   reference offset of blocks 0-2 (d0) and 3 (d1).
// The words are built in registers and stored at the end, so the loads
// of all slots can be in flight together.
__device__ __forceinline__ void describe(Shared& sm, int buf, int kind,
                                         int part, int t) {
  if (t < 32 || t >= 64) return;
  copy_wait();
  if (part != 0 || kind > KIND_I8x8) return;
  __syncwarp();                                // the warp's ABI copies
  Stage& st = sm.stage[buf];
  const int l = t - 32;
  uint32_t d0[10], d1[10];
  if (kind == KIND_I4x4) {
#pragma unroll
    for (int s = 0; s < 10; ++s) {
      const int m = sm.tab[LANES + s * 32 + l];
      d0[s] = 0, d1[s] = D_IDLE;
      if (m >= 0) {
        const int g = m >> 4, q = m & 15;
        const int bx = 4 * (g & 3), by = 4 * (g >> 2);
        const int4 av = reinterpret_cast<const int4*>(st.abi + A_I4A)[g];
        const bool al = av.x > 0, at = av.y > 0, atl = av.z > 0,
                   atr = av.w > 0;
        const int mode = st.abi[A_I4M + g];
        const uint32_t out = (1 + by + (q >> 2)) * TS + TX + bx + (q & 3);
        if (mode == 2) {
          d0[s] = (by * TS + TX + bx) | ((1 + by) * TS + TX + bx - 1) << 10;
          d1[s] = out | dc_word(at, al, 2);
        } else {
          const uint32_t w = (uint32_t)sm.tab[TAPS4 + mode * 16 + q];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            d0[s] |= (uint32_t)ref_offset((w >> 5 * k) & 31, 4, bx, by, al,
                                          at, atl, atr)
                     << 10 * k;
          d1[s] = out | tap_word(w);
        }
      }
    }
  } else {
    d0[8] = 0;
#pragma unroll
    for (int b8 = 0; b8 < 4; ++b8) {
      const int bx = 8 * (b8 & 1), by = 8 * (b8 >> 1);
      const int4 av = reinterpret_cast<const int4*>(st.abi + A_I8A)[b8];
      const bool al = av.x > 0, at = av.y > 0, atl = av.z > 0,
                 atr = av.w > 0;
      const int mode = st.abi[A_I8M + b8];
      const uint32_t raw =
          l < 25 ? ref_offset(l, 8, bx, by, al, at, atl, atr) : ZERO;
      if (b8 < 3) d0[8] |= raw << 10 * b8;
      else d1[8] = raw;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = l + 32 * h, i = 2 * b8 + h;
        const uint32_t out = (1 + by + (q >> 3)) * TS + TX + bx + (q & 7);
        if (mode == 2) {
          d0[i] = 0, d1[i] = out | dc_word(at, al, 3);
        } else {
          const uint32_t w = (uint32_t)sm.tab[TAPS8 + mode * 64 + q];
          d0[i] = (w & 31) | ((w >> 5) & 31) << 10 | ((w >> 10) & 31) << 20;
          d1[i] = out | tap_word(w);
        }
      }
    }
    d0[9] = d1[9] = 0;
  }
#pragma unroll
  for (int s = 0; s < 10; ++s) st.desc[s][l] = make_uint2(d0[s], d1[s]);
}

// index in the luma residual [16][16] of the sample that descriptor d1
// writes (tile offset d1 & 1023)
__device__ __forceinline__ int res_index(uint32_t d1) {
  const int out = d1 & 1023, row = out / TS - 1;
  return row * 16 + out - (row + 1) * TS - TX;
}

// 8.3.2.2.1: filtered entry i of an 8x8 block's raw references r
// (tl, top[16], left[8])
__device__ __forceinline__ int filter8(const int* r, int i, bool al, bool at,
                                       bool atl) {
  const int tl = r[0];
  const int* tp = r + 1;
  const int* lf = r + 17;
  if (i == 0) {
    if (!atl) return tl;
    if (at && al) return (tp[0] + 2 * tl + lf[0] + 2) >> 2;
    if (at) return (3 * tl + tp[0] + 2) >> 2;
    if (al) return (3 * tl + lf[0] + 2) >> 2;
    return tl;
  }
  if (i <= 16) {
    const int x = i - 1;
    if (!at) return tp[x];
    if (x == 0)
      return atl ? (tl + 2 * tp[0] + tp[1] + 2) >> 2
                 : (3 * tp[0] + tp[1] + 2) >> 2;
    if (x == 15) return (tp[14] + 3 * tp[15] + 2) >> 2;
    return (tp[x - 1] + 2 * tp[x] + tp[x + 1] + 2) >> 2;
  }
  const int y = i - 17;
  if (!al) return lf[y];
  if (y == 0)
    return atl ? (tl + 2 * lf[0] + lf[1] + 2) >> 2
               : (3 * lf[0] + lf[1] + 2) >> 2;
  if (y == 7) return (lf[6] + 3 * lf[7] + 2) >> 2;
  return (lf[y - 1] + 2 * lf[y] + lf[y + 1] + 2) >> 2;
}

// Luma of intra/PCM MB (mx, my) of stream b from stage buffer `buf`,
// after the wait and a barrier; every thread of the block calls it.
// Warps 1-3 return after the gather's barrier, warp 0 after writing the
// MB: the caller's barrier follows.
static __device__ void intra_mb_luma(const IntraArgs& a, Shared& sm,
                                     int buf, int b, int mx, int my,
                                     int kind, int t) {
  const int W = a.mb_w * 16, H = a.mb_h * 16;
  const int x0 = mx * 16, y0 = my * 16;
  uint8_t* Y = a.y + (long)b * H * W;
  const Stage& st = sm.stage[buf];
  int* T = sm.tile;
  if (kind != KIND_IPCM && t >= STAGERS && t < STAGERS + 65) {
    const int i = t - STAGERS;                 // gather the border
    int row, col;                              // tile row, x - x0
    if (i < 25) row = 0, col = i - 1;
    else if (i < 41) row = i - 24, col = -1;
    else row = 4 * (1 + (i - 41) / 8), col = 16 + (i - 41) % 8;
    T[row * TS + TX + col] = px(Y, H, W, y0 + row - 1, x0 + col);
  }
  __syncthreads();                             // B: tile complete
  if (t >= 32) return;
  const int l = t;
  const int* res = reinterpret_cast<const int*>(st.res);
  if (kind == KIND_I4x4) {
    uint2 dn = st.desc[0][l];
#pragma unroll
    for (int s = 0; s < 10; ++s) {
      const uint32_t d0 = dn.x, d1 = dn.y;
      if (s < 9) dn = st.desc[s + 1][l];       // the next one, early
      if (!(d1 & D_IDLE)) {
        int acc;
        if (d1 & D_DC) {
          const int* tp = T + (d0 & 1023);
          const int* lf = T + ((d0 >> 10) & 1023);
          acc = (d1 & D_AT ? tp[0] + tp[1] + tp[2] + tp[3] : 0) +
                (d1 & D_AL ? lf[0] + lf[TS] + lf[2 * TS] + lf[3 * TS] : 0);
        } else {
          acc = (int)((d1 >> 13) & 3) * T[d0 & 1023] +
                (int)((d1 >> 15) & 3) * T[(d0 >> 10) & 1023] +
                (int)((d1 >> 17) & 3) * T[(d0 >> 20) & 1023];
        }
        T[d1 & 1023] = clip255(apply(d1, acc) + res[res_index(d1)]);
      }
      __syncwarp();
    }
  } else if (kind == KIND_I8x8) {
    int* raw = sm.ref8[0];
    int* flt = sm.ref8[1];
    const uint2 ro = st.desc[8][l];
#pragma unroll
    for (int b8 = 0; b8 < 4; ++b8) {
      const int* av = st.abi + A_I8A + 4 * b8;
      const bool al = av[0] > 0, at = av[1] > 0, atl = av[2] > 0;
      const uint2 e[2] = {st.desc[2 * b8][l], st.desc[2 * b8 + 1][l]};
      if (l < 25) raw[l] = T[b8 < 3 ? (ro.x >> 10 * b8) & 1023 : ro.y];
      __syncwarp();
      if (l < 25) flt[l] = filter8(raw, l, al, at, atl);
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t d0 = e[h].x, d1 = e[h].y;
        int acc;
        if (d1 & D_DC) {
          int sum_t = 0, sum_l = 0;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            sum_t += flt[1 + i];
            sum_l += flt[17 + i];
          }
          acc = (d1 & D_AT ? sum_t : 0) + (d1 & D_AL ? sum_l : 0);
        } else {
          acc = (int)((d1 >> 13) & 3) * flt[d0 & 31] +
                (int)((d1 >> 15) & 3) * flt[(d0 >> 10) & 31] +
                (int)((d1 >> 17) & 3) * flt[(d0 >> 20) & 31];
        }
        T[d1 & 1023] = clip255(apply(d1, acc) + res[res_index(d1)]);
      }
      __syncwarp();
    }
  }
  if (l >= 16) return;                         // lane l: row l of the MB
  const int4* rr = reinterpret_cast<const int4*>(res + l * 16);
  int4 v[4];
  if (kind == KIND_IPCM) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = rr[j];            // raw samples
  } else if (kind == KIND_I16) {
    // V: top[c]; H, DC: p; plane: clip((base + bb * c) >> 5), where H
    // and DC are base = 32 p, bb = 0
    const int mode = st.abi[A_I16];
    const bool al = st.abi[A_MBA] > 0, at = st.abi[A_MBA + 1] > 0,
               atl = st.abi[A_MBA + 2] > 0;
    const int* tp = T + TX;                    // row 0
    const int* lf = T + TS + TX - 1;           // column -1, stride TS
    int base = 0, bb = 0;
    if (mode == 1) {
      base = (al ? lf[l * TS] : 0) << 5;
    } else if (mode == 2) {
      int sum_t = 0, sum_l = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sum_t += tp[i];
        sum_l += lf[i * TS];
      }
      base = dc_of(at ? sum_t : 0, al ? sum_l : 0, al, at, 5) << 5;
    } else if (mode == 3) {
      const int tl = atl ? T[TX - 1] : 0;
      int hh = 0, vv = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        hh += (i + 1) * ((at ? tp[8 + i] : 0) -
                         (i < 7 ? (at ? tp[6 - i] : 0) : tl));
        vv += (i + 1) * ((al ? lf[(8 + i) * TS] : 0) -
                         (i < 7 ? (al ? lf[(6 - i) * TS] : 0) : tl));
      }
      const int aa = 16 * ((al ? lf[15 * TS] : 0) + (at ? tp[15] : 0));
      const int cc = (5 * vv + 32) >> 6;
      bb = (5 * hh + 32) >> 6;
      base = aa - 7 * bb + cc * (l - 7) + 16;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * j + k;
        p[k] = mode == 0 ? (at ? tp[c] : 0) : clip255((base + bb * c) >> 5);
      }
      const int4 r = rr[j];
      v[j] = make_int4(clip255(p[0] + r.x), clip255(p[1] + r.y),
                       clip255(p[2] + r.z), clip255(p[3] + r.w));
    }
  } else {
    const int4* row = reinterpret_cast<const int4*>(T + (1 + l) * TS + TX);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = row[j];
  }
  *reinterpret_cast<uint4*>(Y + (long)(y0 + l) * W + x0) =
      make_uint4(pack4(v[0]), pack4(v[1]), pack4(v[2]), pack4(v[3]));
}

// Both chroma planes of intra/PCM MB (mx, my) of stream b (PCM predicts
// 0) from stage buffer `buf`; as intra_mb_luma, every thread calls it.
// Threads 32-65 gather each plane's (tl, top8, left8), masked by the
// MB's availability; lanes 0-15 of warp 0 compute a row each (plane
// lane >> 3, row lane & 7) and store it.
static __device__ void intra_mb_chroma(const IntraArgs& a, Shared& sm,
                                       int buf, int b, int mx, int my,
                                       int kind, int t) {
  const int Hc = a.mb_h * 8, Wc = a.mb_w * 8;
  const int xc = mx * 8, yc = my * 8;
  const long plane = (long)b * Hc * Wc;
  const Stage& st = sm.stage[buf];
  const int* ab = st.abi + A_MBA;
  const bool al = ab[0] > 0, at = ab[1] > 0, atl = ab[2] > 0;
  if (kind != KIND_IPCM && t >= STAGERS && t < STAGERS + 34) {
    const int i = t - STAGERS, p = i / 17, j = i % 17;
    const uint8_t* C = (p == 0 ? a.cb : a.cr) + plane;
    int v;
    if (j == 0) v = atl ? px(C, Hc, Wc, yc - 1, xc - 1) : 0;
    else if (j <= 8) v = at ? px(C, Hc, Wc, yc - 1, xc + j - 1) : 0;
    else v = al ? px(C, Hc, Wc, yc + j - 9, xc - 1) : 0;
    sm.tile[i] = v;
  }
  __syncthreads();                             // B: borders complete
  if (t >= 16) return;
  const int p = t >> 3, r = t & 7;
  const int* bv = sm.tile + 17 * p;
  const int tl = bv[0];
  const int* tp = bv + 1;
  const int* lf = bv + 9;
  int v[8];
  if (kind == KIND_IPCM) {
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = 0;
  } else {
    const int mode = st.abi[A_CHM];
    if (mode == 0) {                           // DC per 4x4 sub-block
      const int sby = r >> 2;
      const int sl = lf[4 * sby] + lf[4 * sby + 1] + lf[4 * sby + 2] +
                     lf[4 * sby + 3];
#pragma unroll
      for (int sbx = 0; sbx < 2; ++sbx) {
        const int s_t = tp[4 * sbx] + tp[4 * sbx + 1] + tp[4 * sbx + 2] +
                        tp[4 * sbx + 3];
        const int both = (s_t + sl + 4) >> 3, tonly = (s_t + 2) >> 2,
                  lonly = (sl + 2) >> 2;
        int dc;
        if (sbx == sby) {                      // (0,0) and (1,1)
          dc = at && al ? both : (al ? lonly : (at ? tonly : 128));
        } else if (sbx > 0) {                  // top-right: top first
          dc = at ? tonly : (al ? lonly : 128);
        } else {                               // bottom-left: left first
          dc = al ? lonly : (at ? tonly : 128);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) v[4 * sbx + c] = dc;
      }
    } else if (mode == 1) {
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = lf[r];
    } else if (mode == 2) {
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = tp[c];
    } else {
      int hh = 0, vv = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hh += (i + 1) * (tp[4 + i] - (i < 3 ? tp[2 - i] : tl));
        vv += (i + 1) * (lf[4 + i] - (i < 3 ? lf[2 - i] : tl));
      }
      const int aa = 16 * (lf[7] + tp[7]);
      const int bb = (34 * hh + 32) >> 6, cc = (34 * vv + 32) >> 6;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        v[c] = clip255((aa + bb * (c - 3) + cc * (r - 3) + 16) >> 5);
    }
  }
  const int* res = reinterpret_cast<const int*>(st.res) + p * 64 + r * 8;
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = clip255(v[c] + res[c]);
  uint8_t* C = (p == 0 ? a.cb : a.cr) + plane;
  *reinterpret_cast<uint2*>(C + (long)(yc + r) * Wc + xc) =
      make_uint2(pack4(make_int4(v[0], v[1], v[2], v[3])),
                 pack4(make_int4(v[4], v[5], v[6], v[7])));
}

}  // namespace intra
