// Reference store: the half-pel planes (G, b, h, j; spec 8.4.2.2.1) and
// the padded chroma of each storing lane's picture, written in place into
// its DPB slot, for one batch round in one launch.
//
// Replaces: no pallas_call.  The reference computes the planes in XLA
// (arrow_h264_tpu/models/pipeline.py::store_ref_fn, :298, with
// arrow_h264_tpu/ops/inter.py::halfpel_planes, :36, and pad_chroma, :59).
// The port's plain version (ops/inter.py::store_refs_plain) runs eagerly
// as ~60 torch operations with an int32 copy of each padded plane, a stack
// and an index assignment; this kernel writes each DPB byte once.
//
// What bounds it: bytes.  A 1080p picture is read once (3.1 MB) and its
// four padded luma planes and two padded chroma planes written once
// (10.3 MB): ~13 MB, ~0.004 ms at 3.35 TB/s.  The three 6-tap planes cost
// a few hundred integer operations a 16-sample row piece, so the design
// keeps the arithmetic a sample small as well.
//
// What the design does about it: a block takes a tile of kTileH x kTileW
// samples of the padded luma plane (or of a padded chroma plane) of one
// storing lane, and a thread 16 adjacent columns of kRowsT rows of it.
// A luma block stages the picture rows and columns that the tile's 6-tap
// filters reach, once a tile: the interior with 16-byte cp.async (the
// pitch W and H*W are multiples of 16), the padding by replicating the
// edge sample of the row into whole 16-byte groups (the picture's
// columns and the staged groups share their 16-byte alignment, so a
// group is all inside or all outside); a lane whose picture is not
// 16-byte aligned stages byte by byte.  A thread then walks down its
// rows keeping a window of the six staged rows its taps reach (24 bytes
// each) in registers: for each row it loads one new row, makes the
// unclipped vertical 6-tap h1 of its 21 columns, and from them and the
// centre row G, b (horizontal 6-tap), h (h1) and j (horizontal 6-tap of
// h1, which equals the spec's vertical 6-tap of b1), and writes each
// plane's 16 bytes as one 16-byte store.  Chroma tiles copy the padded
// plane in 8-byte halves (8-byte loads of the interior, replicated edge
// samples), written as one 16-byte store where the padded pitch is a
// multiple of 16 (even mb_w) and as two 8-byte stores otherwise.  The
// storing lanes and their slots are kernel arguments (kMaxLanes a launch;
// the entry launches again for more).

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kPad = 32, kPadC = 16;   // ops/inter.py PAD, PADC
constexpr int kTileW = 128;            // output columns of a block
constexpr int kTileH = 32;             // output rows of a block
constexpr int kRowsT = 4;              // rows a thread walks down
constexpr int kThreadsX = kTileW / 16; // a thread: 16 adjacent columns
constexpr int kThreads = kThreadsX * (kTileH / kRowsT);
constexpr int kStageH = kTileH + 5;    // the tile's rows and the 6-tap halo
constexpr int kStageW = kTileW + 32;   // and a 16-byte group either side
constexpr int kGroups = kStageW / 16;
constexpr int kMaxLanes = 64;

struct StoreArgs {
  const uint8_t* y;                    // [B, H, W], lane stride y_stride
  const uint8_t* cb;                   // [B, H/2, W/2], lane stride c_stride
  const uint8_t* cr;
  uint8_t* dpb_y;                      // [B, S, 4, H + 64, W + 64]
  uint8_t* dpb_c;                      // [B, S, 2, H/2 + 32, W/2 + 32]
  long y_stride, cb_stride, cr_stride;
  int S, H, W, tiles_x, tiles_y, tiles_cx, tiles_cy, k;
  int lanes[kMaxLanes], slots[kMaxLanes];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ uint32_t clip_u8(int v) {
  return (uint32_t)clampi(v, 0, 255);
}

// the 6-tap (1, -5, 20, 20, -5, 1) over v[0..5]
__device__ __forceinline__ int tap6(int v0, int v1, int v2, int v3, int v4,
                                    int v5) {
  return (v0 + v5) - 5 * (v1 + v4) + 20 * (v2 + v3);
}

// byte o (0-23) of a 24-byte window row held as six words
__device__ __forceinline__ int byte_at(const uint32_t* w, int o) {
  return (int)((w[o >> 2] >> (8 * (o & 3))) & 0xff);
}

__device__ __forceinline__ uint32_t pack4(const uint32_t* v) {
  return v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24);
}

// 16-byte copy global -> shared without holding registers (cp.async,
// sm_80+); copy_wait_all closes this thread's group of copies and waits
// for them.  Compiled for the host (a CPU build of the kernel for
// debugging), plain copies.
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void copy_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// 8 bytes of a padded chroma row: picture columns x..x+7 of `row` (x a
// multiple of 8, as Wc is), or the replicated edge sample where the group
// lies outside the picture; `vec`: the lane's rows are 8-byte aligned
__device__ __forceinline__ uint2 chroma8(const uint8_t* row, int x, int Wc,
                                        bool vec) {
  if (x < 0 || x >= Wc) {
    const uint32_t v = row[x < 0 ? 0 : Wc - 1] * 0x01010101u;
    return make_uint2(v, v);
  }
  if (vec) return *reinterpret_cast<const uint2*>(row + x);
  uint32_t w[2];
  for (int q = 0; q < 2; ++q)
    w[q] = row[x + 4 * q] | (row[x + 4 * q + 1] << 8) |
           (row[x + 4 * q + 2] << 16) | ((uint32_t)row[x + 4 * q + 3] << 24);
  return make_uint2(w[0], w[1]);
}

__global__ void __launch_bounds__(kThreads)
store_refs_kernel(StoreArgs a) {
  __shared__ __align__(16) uint8_t s_y[kStageH][kStageW];
  const int k = blockIdx.y;
  const int lane = a.lanes[k], slot = a.slots[k];
  const int tile = blockIdx.x;
  const int n_luma = a.tiles_x * a.tiles_y;
  const int tx = threadIdx.x % kThreadsX, ty = threadIdx.x / kThreadsX;

  if (tile >= n_luma) {                // a tile of a padded chroma plane
    const int t = tile - n_luma;
    const int per = a.tiles_cx * a.tiles_cy;
    const int pl = t / per;
    const int r0 = (t % per) / a.tiles_cx * kTileH + ty * kRowsT;
    const int c = (t % per) % a.tiles_cx * kTileW + tx * 16;
    const int Hc = a.H / 2, Wc = a.W / 2;
    const int Hcp = Hc + 2 * kPadC, Wcp = Wc + 2 * kPadC;
    if (c >= Wcp) return;
    const uint8_t* src = pl ? a.cr + lane * a.cr_stride
                            : a.cb + lane * a.cb_stride;
    const bool vec = ((uintptr_t)src & 7) == 0;
    const bool wide = (Wcp & 15) == 0, two = c + 8 < Wcp;
    uint8_t* out = a.dpb_c + (((long)lane * a.S + slot) * 2 + pl) *
                                 ((long)Hcp * Wcp) + c;
#pragma unroll
    for (int t = 0; t < kRowsT; ++t) {
      const int r = r0 + t;
      if (r >= Hcp) break;
      const uint8_t* row = src + (long)clampi(r - kPadC, 0, Hc - 1) * Wc;
      const uint2 v0 = chroma8(row, c - kPadC, Wc, vec);
      const uint2 v1 = two ? chroma8(row, c - kPadC + 8, Wc, vec)
                           : make_uint2(0, 0);
      uint8_t* dst = out + (long)r * Wcp;
      if (wide) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(v0.x, v0.y, v1.x, v1.y);
      } else {                         // odd mb_w: rows 8-byte aligned
        *reinterpret_cast<uint2*>(dst) = v0;
        if (two) *reinterpret_cast<uint2*>(dst + 8) = v1;
      }
    }
    return;
  }

  // luma: the tile's padded rows r0.., columns c0..; picture row of
  // padded row R is R - kPad, clamped.  s_y[i][j]: picture sample
  // (clamp(r0 - kPad - 2 + i), clamp(c0 - kPad - 16 + j))
  const int r0 = tile / a.tiles_x * kTileH, c0 = tile % a.tiles_x * kTileW;
  const int Hp = a.H + 2 * kPad, Wp = a.W + 2 * kPad;
  const uint8_t* src = a.y + lane * a.y_stride;
  const bool vec = ((uintptr_t)src & 15) == 0;
  for (int i = threadIdx.x; i < kStageH * kGroups; i += kThreads) {
    const int rr = i / kGroups, g = i % kGroups;
    const uint8_t* row =
        src + (long)clampi(r0 - kPad - 2 + rr, 0, a.H - 1) * a.W;
    const int x = c0 - kPad - 16 + 16 * g;
    uint8_t* dst = &s_y[rr][16 * g];
    if (x >= 0 && x < a.W && vec) {
      copy_async16(dst, row + x);
    } else if (x >= 0 && x < a.W) {    // a lane off 16-byte alignment
      uint32_t w[4];
      for (int q = 0; q < 4; ++q)
        w[q] = row[x + 4 * q] | (row[x + 4 * q + 1] << 8) |
               (row[x + 4 * q + 2] << 16) |
               ((uint32_t)row[x + 4 * q + 3] << 24);
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {                           // padding: the row's edge sample
      const uint32_t v = row[x < 0 ? 0 : a.W - 1] * 0x01010101u;
      *reinterpret_cast<uint4*>(dst) = make_uint4(v, v, v, v);
    }
  }
  copy_wait_all();
  __syncthreads();

  const int c = c0 + 16 * tx;
  if (c >= Wp) return;
  const long plane = (long)Hp * Wp;
  uint8_t* out = a.dpb_y + ((long)lane * a.S + slot) * 4 * plane + c;
  // the window: staged rows i.. i + 5 for output row r0 + i, columns
  // 16 tx + 12 .. 16 tx + 35 (the 21 the taps reach are bytes 2-22), as
  // six words a row; win[(t + d) % 6] is row d of output row t's window
  uint32_t win[6][6];
  auto load = [&](int i, uint32_t* w) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(&s_y[i][16 * tx + 12]);
    const uint4 m = *reinterpret_cast<const uint4*>(p + 1);
    w[0] = p[0], w[1] = m.x, w[2] = m.y, w[3] = m.z, w[4] = m.w, w[5] = p[5];
  };
#pragma unroll
  for (int d = 0; d < 5; ++d) load(ty * kRowsT + d, win[d]);
#pragma unroll
  for (int t = 0; t < kRowsT; ++t) {
    const int r = r0 + ty * kRowsT + t;
    if (r >= Hp) break;
    load(ty * kRowsT + t + 5, win[(t + 5) % 6]);
    const uint32_t* w0 = win[t % 6];
    const uint32_t* w1 = win[(t + 1) % 6];
    const uint32_t* w2 = win[(t + 2) % 6];   // row r - kPad, the centre
    const uint32_t* w3 = win[(t + 3) % 6];
    const uint32_t* w4 = win[(t + 4) % 6];
    const uint32_t* w5 = win[(t + 5) % 6];
    int h1[21], s[21];                 // columns 16 tx + 14 + m of s_y
#pragma unroll
    for (int m = 0; m < 21; ++m) {
      s[m] = byte_at(w2, 2 + m);
      h1[m] = tap6(byte_at(w0, 2 + m), byte_at(w1, 2 + m), s[m],
                   byte_at(w3, 2 + m), byte_at(w4, 2 + m), byte_at(w5, 2 + m));
    }
    uint32_t bw[4], hw[4], jw[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t bv[4], hv[4], jv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = 4 * q + i;       // output column c + x: taps x..x+5
        bv[i] = clip_u8((tap6(s[x], s[x + 1], s[x + 2], s[x + 3], s[x + 4],
                              s[x + 5]) + 16) >> 5);
        hv[i] = clip_u8((h1[x + 2] + 16) >> 5);
        jv[i] = clip_u8((tap6(h1[x], h1[x + 1], h1[x + 2], h1[x + 3],
                              h1[x + 4], h1[x + 5]) + 512) >> 10);
      }
      bw[q] = pack4(bv), hw[q] = pack4(hv), jw[q] = pack4(jv);
    }
    uint8_t* dst = out + (long)r * Wp;
    *reinterpret_cast<uint4*>(dst) = make_uint4(w2[1], w2[2], w2[3], w2[4]);
    *reinterpret_cast<uint4*>(dst + plane) =
        make_uint4(bw[0], bw[1], bw[2], bw[3]);
    *reinterpret_cast<uint4*>(dst + 2 * plane) =
        make_uint4(hw[0], hw[1], hw[2], hw[3]);
    *reinterpret_cast<uint4*>(dst + 3 * plane) =
        make_uint4(jw[0], jw[1], jw[2], jw[3]);
  }
}

}  // namespace

extern "C" int store_refs_launch(
    const uint8_t* y, const uint8_t* cb, const uint8_t* cr, uint8_t* dpb_y,
    uint8_t* dpb_c, const int32_t* lanes, const int32_t* slots, int k,
    int y_stride, int cb_stride, int cr_stride, int S, int H, int W,
    void* stream) {
  StoreArgs a;
  a.y = y;
  a.cb = cb;
  a.cr = cr;
  a.dpb_y = dpb_y;
  a.dpb_c = dpb_c;
  a.y_stride = y_stride;
  a.cb_stride = cb_stride;
  a.cr_stride = cr_stride;
  a.S = S;
  a.H = H;
  a.W = W;
  a.tiles_x = (W + 2 * kPad + kTileW - 1) / kTileW;
  a.tiles_y = (H + 2 * kPad + kTileH - 1) / kTileH;
  a.tiles_cx = (W / 2 + 2 * kPadC + kTileW - 1) / kTileW;
  a.tiles_cy = (H / 2 + 2 * kPadC + kTileH - 1) / kTileH;
  const int tiles = a.tiles_x * a.tiles_y + 2 * a.tiles_cx * a.tiles_cy;
  // `lanes` and `slots` are host arrays: they travel as kernel arguments
  for (int k0 = 0; k0 < k; k0 += kMaxLanes) {
    a.k = k - k0 < kMaxLanes ? k - k0 : kMaxLanes;
    for (int i = 0; i < a.k; ++i) {
      a.lanes[i] = lanes[k0 + i];
      a.slots[i] = slots[k0 + i];
    }
    store_refs_kernel<<<dim3(tiles, a.k), kThreads, 0,
                        (cudaStream_t)stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
