// The per-MB deblocking body (spec 8.7) shared by the deblock kernels: the
// knight-move wavefront (deblock_phase.cu, K2) and the raster walk
// (deblock_raster.cu, K6).  A worker is one warp; it filters one part of
// one MB, luma or both chroma planes (the kernels chain the two parts
// apart: neither plane's filter reads the other), once the left and the
// top neighbour of that part are final in the planes.  bS/tc0/alpha/beta
// come from ops/deblock.py::deblock_tables, so the body has no coding-data
// logic; an edge with bS 0 changes nothing.
//
// What bounds it: the chain of dependent MBs (see the kernels), so what
// counts is the latency of one body from the end of the wait to the
// release.  The body keeps that short:
//   1. Before the wait (`stage`), cp.async copies what no earlier MB
//      writes into the worker's buffer in shared memory: the MB's own
//      samples (16x16 luma, or 8x8 of Cb and of Cr) into its tile, and
//      its table words (80 int32 luma, 64 chroma).  K6 stages MB mx + 1
//      into the other of two buffers while it filters MB mx.
//   2. After the wait (`gather`), one load a lane reads the border: the
//      top MB's 4 bottom rows and the left MB's 4 right columns (chroma:
//      2 and 2 of each plane).  K6 carries the left border in shared
//      memory from the MB before (`carry`).  Outside the picture the
//      border is 0, as in the plain version.
//   3. Two passes filter the tile: lane k < 16 loads line k (luma row k;
//      chroma plane k >> 3, row k & 7) into registers, runs the 4 (chroma
//      2) vertical edges across it in order and stores it back; after
//      __syncwarp() the same down column k for the horizontal edges.  The
//      arithmetic is filter_luma/filter_chroma's, on registers.
//   4. After __syncwarp(), one write-back (`store`): the MB's rows in
//      16-byte (chroma 8-byte) stores, the left MB's right columns as one
//      4-byte (chroma 2-byte) store a row, and the top MB's 3 (chroma 1)
//      bottom rows that the horizontal edge 0 changes; then the caller's
//      __syncwarp() and release.
//
// Why the MB's samples may be staged before the wait: a sample of MB
// (mx, my) is written only by its own body, by the vertical edge 0 of
// (mx + 1, my) (its 3 right columns) and by the horizontal edge 0 of
// (mx, my + 1) (its 3 bottom rows).  Both run after (mx, my): in K2,
// (mx + 1, my) waits on its left neighbour and (mx, my + 1) on its
// top-right one, (mx + 1, my), or in the last column on its top one; in
// K6, (mx + 1, my) is the next MB of the same worker and (mx, my + 1)
// waits until row my has finished MB mx + 1.  So until its own body runs,
// an MB's samples hold the kernel's input, wherever its worker copies
// them from.  The tables are inputs that nothing writes.
//
// Why the write-back is race-free, though it also stores samples that no
// edge changed (the left MB's column x0 - 4, chroma xc - 2, and lines
// whose edges have bS 0 or are not filtered): every sample it stores lies
// in (mx, my), (mx - 1, my) or (mx, my - 1), and every other body that
// touches such a sample runs wholly before this one (this body waited on
// it) or wholly after (it waits on this one).  The other bodies that
// touch (mx - 1, my) are its own, done, and (mx - 1, my + 1), which waits
// on (mx, my) (K2: its top-right; K6: the lag rule); those that touch
// (mx, my - 1) are its own and (mx + 1, my - 1), both done before the
// wait ended, and (mx, my) itself.  The corner of the top-left MB in the
// tile is neither read by an edge nor stored.
//
// Tiles (bytes, in the worker's `Buf`):
//   luma: LROWS rows of LS bytes; rows 0-3 the top MB's bottom rows
//     (y0 - 4 .. y0 - 1), row 4 + r the MB's row r; sample x0 + c
//     (c = -4 .. 15) at byte LX + c of a row.
//   chroma: a plane at byte p * CP (Cb, Cr); CROWS rows of CS bytes, rows
//     0-1 the top MB's bottom rows, row 2 + r the MB's row r; sample
//     xc + c (c = -2 .. 7) at byte CX + c.
//   The MB's rows start 8-byte aligned (cp.async of 8 bytes).  With LS =
//   24 (6 words) and CS = 16 and Cr CP = 168 bytes after Cb, the 16 lanes
//   of a vertical pass, each on its own row, hit 16 different banks in
//   each of their word loads and stores, and the lanes of a horizontal
//   pass read one row at a time (a few words, broadcast).
//   tab: luma bs_v, tc_v, bs_h, tc_h [16] each, a_v, b_v, a_h, b_h [4]
//   each; chroma bs_c [16], tc_c [32], a_c, b_c [8] (as the tables' rows).
//
// Layouts of the arguments (all contiguous, 16-byte aligned):
//   y [B, H, W], cb/cr [B, H/2, W/2] uint8 (in place)
//   bs_v, tc_v, bs_h, tc_h [B, n, 4 (edge), 4 (segment)] int32
//   a_v, b_v, a_h, b_h [B, n, 4] int32
//   bs_c [B, n, 2 (dir), 2 (edge), 4]; tc_c [B, n, 2, 2, 4, 2 (plane)];
//   a_c, b_c [B, n, 2, 2, 2 (plane)] int32

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#if !defined(__CUDA_ARCH__)
#include <string.h>
#endif

namespace deblock {

struct DeblockArgs {
  uint8_t *y, *cb, *cr;
  const int32_t *bs_v, *tc_v, *a_v, *b_v, *bs_h, *tc_h, *a_h, *b_h;
  const int32_t *bs_c, *tc_c, *a_c, *b_c;
  int mb_w, mb_h;
};

constexpr int LS = 24, LX = 8, LROWS = 20;              // luma tile
constexpr int CS = 16, CX = 8, CROWS = 10, CP = 168;    // chroma tiles
constexpr int TILE_BYTES = LROWS * LS;                  // >= CP + CROWS * CS
constexpr int T_BSV = 0, T_TCV = 16, T_BSH = 32, T_TCH = 48, T_AV = 64,
              T_BV = 68, T_AH = 72, T_BH = 76;          // luma tab words
constexpr int T_BSC = 0, T_TCC = 16, T_AC = 48, T_BC = 56;  // chroma
constexpr int TAB_WORDS = 80;

// A worker's buffer: one part of one MB.
struct alignas(16) Buf {
  uint8_t tile[TILE_BYTES];
  int tab[TAB_WORDS];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int absi(int v) { return v < 0 ? -v : v; }

// q points at q0; p_k = q[-(k+1)*step], q_k = q[k*step] (8.7.2.3/8.7.2.4);
// the body passes a line of samples held in registers (T = int, step 1)
template <class T>
__device__ __forceinline__ void filter_luma(T* q, int step, int bs, int tc0,
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

template <class T>
__device__ __forceinline__ void filter_chroma(T* q, int step, int bs,
                                              int tc0, int alpha, int beta) {
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

// N-byte copy global -> shared without holding registers (cp.async,
// sm_80+: 16 bytes past L1, 8 bytes through it); copy_commit closes this
// thread's group of copies, copy_wait<N> waits until at most N of its
// groups are in flight.  Compiled for the host (a CPU build of the
// kernels for debugging), plain copies.
template <int N>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
#else
  memcpy(dst, src, N);
#endif
}

__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// (x0, y0) of MB (mx, my) in stream b's plane p (0 luma, 1 Cb, 2 Cr), and
// the plane's width
__device__ __forceinline__ uint8_t* mb_origin(const DeblockArgs& a, int p,
                                              int b, int mx, int my,
                                              int& w) {
  const int s = p ? 8 : 16;
  w = a.mb_w * s;
  uint8_t* plane = p == 0 ? a.y : (p == 1 ? a.cb : a.cr);
  return plane + ((long)b * a.mb_h + my) * s * w + mx * s;
}

// Before the wait: start the copies of part `part` (0 luma, 1 chroma) of
// MB (mx, my) of stream b into s, as one group of each lane's copies.
__device__ __forceinline__ void stage(const DeblockArgs& a, Buf& s, int b,
                                      int mx, int my, int part, int lane) {
  const long m = (long)b * a.mb_w * a.mb_h + my * a.mb_w + mx;
  int w;
  if (part == 0) {                   // lane: 8 bytes of row lane >> 1
    const int r = lane >> 1, h = 8 * (lane & 1);
    copy_async<8>(s.tile + (4 + r) * LS + LX + h,
                  mb_origin(a, 0, b, mx, my, w) + (long)r * w + h);
    if (lane < 20) {                 // 16 bytes of the table words
      const int32_t* src =
          lane < 4    ? a.bs_v + m * 16 + 4 * lane
          : lane < 8  ? a.tc_v + m * 16 + 4 * (lane - 4)
          : lane < 12 ? a.bs_h + m * 16 + 4 * (lane - 8)
          : lane < 16 ? a.tc_h + m * 16 + 4 * (lane - 12)
          : lane == 16 ? a.a_v + m * 4
          : lane == 17 ? a.b_v + m * 4
          : lane == 18 ? a.a_h + m * 4
                       : a.b_h + m * 4;
      copy_async<16>(s.tab + 4 * lane, src);
    }
  } else if (lane < 16) {            // plane lane >> 3, row lane & 7
    const int p = lane >> 3, r = lane & 7;
    copy_async<8>(s.tile + p * CP + (2 + r) * CS + CX,
                  mb_origin(a, 1 + p, b, mx, my, w) + (long)r * w);
  } else {
    const int i = lane - 16;
    const int32_t* src = i < 4    ? a.bs_c + m * 16 + 4 * i
                         : i < 12 ? a.tc_c + m * 32 + 4 * (i - 4)
                         : i < 14 ? a.a_c + m * 8 + 4 * (i - 12)
                                  : a.b_c + m * 8 + 4 * (i - 14);
    copy_async<16>(s.tab + 4 * i, src);
  }
  copy_commit();
}

// After the wait: the border of part `part` of MB (mx, my) into s: the
// top MB's bottom rows (lanes 16-19) and, unless `carried` (K6 has put
// them there), the left MB's right columns (lanes 0-15); 0 outside the
// picture.
__device__ __forceinline__ void gather(const DeblockArgs& a, Buf& s, int b,
                                       int mx, int my, int part,
                                       bool carried, int lane) {
  int w;
  if (part == 0) {
    const uint8_t* o = mb_origin(a, 0, b, mx, my, w);
    if (lane < 16) {
      if (!carried)
        *reinterpret_cast<uint32_t*>(s.tile + (4 + lane) * LS + LX - 4) =
            mx > 0 ? *reinterpret_cast<const uint32_t*>(o + (long)lane * w - 4)
                   : 0u;
    } else if (lane < 20) {          // tile row j: line y0 - 4 + j
      const int j = lane - 16;
      const uint4 v = my > 0 ? *reinterpret_cast<const uint4*>(
                                   o + (long)(j - 4) * w)
                             : make_uint4(0, 0, 0, 0);
      uint2* d = reinterpret_cast<uint2*>(s.tile + j * LS + LX);
      d[0] = make_uint2(v.x, v.y);
      d[1] = make_uint2(v.z, v.w);
    }
  } else if (lane < 16) {
    const int p = lane >> 3, r = lane & 7;
    if (!carried) {
      const uint8_t* o = mb_origin(a, 1 + p, b, mx, my, w);
      *reinterpret_cast<uint16_t*>(s.tile + p * CP + (2 + r) * CS + CX - 2) =
          mx > 0 ? *reinterpret_cast<const uint16_t*>(o + (long)r * w - 2)
                 : (uint16_t)0;
    }
  } else if (lane < 20) {            // plane, tile row j: line yc - 2 + j
    const int p = (lane - 16) >> 1, j = lane & 1;
    const uint8_t* o = mb_origin(a, 1 + p, b, mx, my, w);
    *reinterpret_cast<uint2*>(s.tile + p * CP + j * CS + CX) =
        my > 0 ? *reinterpret_cast<const uint2*>(o + (long)(j - 2) * w)
               : make_uint2(0, 0);
  }
}

// Lane k < 16, direction D (0 vertical edges, 1 horizontal): luma line k
// (tile row 4 + k, or column k down all rows) into registers, its 4 edges
// in order, and back.
template <int D>
__device__ __forceinline__ void luma_pass(Buf& s, int k) {
  int v[LROWS];                      // samples x0 - 4 + i, or y0 - 4 + i
  uint8_t* t = s.tile;
  if (D == 0) {
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(t + (4 + k) * LS + LX - 4);
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const uint32_t x = row[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 * j + i] = (x >> 8 * i) & 255;
    }
  } else {
#pragma unroll
    for (int i = 0; i < LROWS; ++i) v[i] = t[i * LS + LX + k];
  }
  const int* bs = s.tab + (D ? T_BSH : T_BSV);
  const int* tc = s.tab + (D ? T_TCH : T_TCV);
  const int* al = s.tab + (D ? T_AH : T_AV);
  const int* be = s.tab + (D ? T_BH : T_BV);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int seg = e * 4 + (k >> 2);
    if (bs[seg] == 0) continue;
    filter_luma(v + 4 + 4 * e, 1, bs[seg], tc[seg], al[e], be[e]);
  }
  if (D == 0) {
    uint32_t* row = reinterpret_cast<uint32_t*>(t + (4 + k) * LS + LX - 4);
#pragma unroll
    for (int j = 0; j < 5; ++j)
      row[j] = (uint32_t)v[4 * j] | (uint32_t)v[4 * j + 1] << 8 |
               (uint32_t)v[4 * j + 2] << 16 | (uint32_t)v[4 * j + 3] << 24;
  } else {
#pragma unroll
    for (int i = 1; i < LROWS; ++i) t[i * LS + LX + k] = (uint8_t)v[i];
  }
}

// The same for chroma: lane k < 16 takes line k & 7 of plane k >> 3 and
// its 2 edges.
template <int D>
__device__ __forceinline__ void chroma_pass(Buf& s, int k) {
  const int p = k >> 3, l = k & 7;
  int v[12];                         // xc - 4 + i across, yc - 4 + i down
  uint8_t* t = s.tile + p * CP;
  if (D == 0) {
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(t + (2 + l) * CS + CX - 4);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const uint32_t x = row[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 * j + i] = (x >> 8 * i) & 255;
    }
  } else {
#pragma unroll
    for (int i = 0; i < CROWS; ++i) v[2 + i] = t[i * CS + CX + l];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int de = D * 2 + e, seg = de * 4 + (l >> 1);
    const int bs = s.tab[T_BSC + seg];
    if (bs == 0) continue;
    filter_chroma(v + 4 + 4 * e, 1, bs, s.tab[T_TCC + seg * 2 + p],
                  s.tab[T_AC + de * 2 + p], s.tab[T_BC + de * 2 + p]);
  }
  if (D == 0) {
    uint32_t* row = reinterpret_cast<uint32_t*>(t + (2 + l) * CS + CX - 4);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      row[j] = (uint32_t)v[4 * j] | (uint32_t)v[4 * j + 1] << 8 |
               (uint32_t)v[4 * j + 2] << 16 | (uint32_t)v[4 * j + 3] << 24;
  } else {
#pragma unroll
    for (int i = 1; i < CROWS; ++i) t[i * CS + CX + l] = (uint8_t)v[2 + i];
  }
}

// The write-back of part `part` of MB (mx, my) from s (header, step 4).
__device__ __forceinline__ void store(const DeblockArgs& a, const Buf& s,
                                      int b, int mx, int my, int part,
                                      int lane) {
  int w;
  if (part == 0) {
    uint8_t* o = mb_origin(a, 0, b, mx, my, w);
    if (lane < 16) {                 // row lane, and its left word
      const uint8_t* row = s.tile + (4 + lane) * LS + LX;
      const uint2 lo = reinterpret_cast<const uint2*>(row)[0],
                  hi = reinterpret_cast<const uint2*>(row)[1];
      *reinterpret_cast<uint4*>(o + (long)lane * w) =
          make_uint4(lo.x, lo.y, hi.x, hi.y);
      if (mx > 0)
        *reinterpret_cast<uint32_t*>(o + (long)lane * w - 4) =
            *reinterpret_cast<const uint32_t*>(row - 4);
    } else if (lane > 16 && lane < 20 && my > 0) {   // lines y0 - 3 .. - 1
      const int j = lane - 16;
      const uint8_t* row = s.tile + j * LS + LX;
      const uint2 lo = reinterpret_cast<const uint2*>(row)[0],
                  hi = reinterpret_cast<const uint2*>(row)[1];
      *reinterpret_cast<uint4*>(o + (long)(j - 4) * w) =
          make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
  } else if (lane < 16) {
    const int p = lane >> 3, r = lane & 7;
    uint8_t* o = mb_origin(a, 1 + p, b, mx, my, w);
    const uint8_t* row = s.tile + p * CP + (2 + r) * CS + CX;
    *reinterpret_cast<uint2*>(o + (long)r * w) =
        *reinterpret_cast<const uint2*>(row);
    if (mx > 0)
      *reinterpret_cast<uint16_t*>(o + (long)r * w - 2) =
          *reinterpret_cast<const uint16_t*>(row - 2);
  } else if (lane < 18 && my > 0) {  // line yc - 1 of plane lane - 16
    const int p = lane - 16;
    uint8_t* o = mb_origin(a, 1 + p, b, mx, my, w);
    *reinterpret_cast<uint2*>(o - w) =
        *reinterpret_cast<const uint2*>(s.tile + p * CP + CS + CX);
  }
}

// After the wait and the caller's __syncwarp(): part `part` of MB
// (mx, my) of stream b from s, staged by `stage` (steps 2-4 of the
// header).  Every lane of the warp calls it; the caller's __syncwarp()
// and release follow.
static __device__ void mb_body(const DeblockArgs& a, Buf& s, int b, int mx,
                               int my, int part, bool carried, int lane) {
  gather(a, s, b, mx, my, part, carried, lane);
  __syncwarp();
  if (lane < 16) {
    if (part == 0) luma_pass<0>(s, lane);
    else chroma_pass<0>(s, lane);
  }
  __syncwarp();
  if (lane < 16) {
    if (part == 0) luma_pass<1>(s, lane);
    else chroma_pass<1>(s, lane);
  }
  __syncwarp();
  store(a, s, b, mx, my, part, lane);
}

// K6: the right columns of the MB in `from`, final after its body, become
// the left border of the next MB of the row in `to` (lanes 0-15, beside
// the copies that stage that MB's own samples there).
__device__ __forceinline__ void carry(const Buf& from, Buf& to, int part,
                                      int lane) {
  if (lane >= 16) return;
  if (part == 0) {
    const int o = (4 + lane) * LS + LX;
    *reinterpret_cast<uint32_t*>(to.tile + o - 4) =
        *reinterpret_cast<const uint32_t*>(from.tile + o + 12);
  } else {
    const int o = (lane >> 3) * CP + (2 + (lane & 7)) * CS + CX;
    *reinterpret_cast<uint16_t*>(to.tile + o - 2) =
        *reinterpret_cast<const uint16_t*>(from.tile + o + 6);
  }
}

}  // namespace deblock
