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
// (10.3 MB): ~13 MB, ~0.004 ms at 3.35 TB/s.
//
// What the design does about it: a block takes a tile of kTileH x kTileW
// samples of the padded luma plane (or of a padded chroma plane) of one
// storing lane.  A luma block stages the picture's rows and columns that
// the tile's 6-tap filters reach (edge-replicated by clamping the
// coordinates, which is what the padding is), then the unclipped int32
// horizontal intermediates b1 of the tile's columns for its rows and the
// 5-row halo in shared memory; each thread then makes 4 adjacent samples
// of all four planes: G and b from the staged rows, h by the vertical
// 6-tap of the samples, j by the vertical 6-tap of b1 with (+512) >> 10
// and a clip, and writes each plane's 4 bytes as one word.  Chroma tiles
// copy the clamped samples.  The storing lanes and their slots are
// kernel arguments (kMaxLanes a launch; the entry launches again for more).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPad = 32, kPadC = 16;   // ops/inter.py PAD, PADC
constexpr int kTileW = 64, kTileH = 16;
constexpr int kThreads = kTileW / 4 * kTileH;
constexpr int kRowsY = kTileH + 5;     // the tile's rows and the 6-tap halo
constexpr int kColsY = kTileW + 5;
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

// the 6-tap (1, -5, 20, 20, -5, 1) over v[0], v[s], ..., v[5s]
template <typename T>
__device__ __forceinline__ int tap6(const T* v, int s) {
  return (int)v[0] - 5 * (int)v[s] + 20 * (int)v[2 * s] +
         20 * (int)v[3 * s] - 5 * (int)v[4 * s] + (int)v[5 * s];
}

__device__ __forceinline__ void put4(uint8_t* p, const uint32_t* v) {
  *reinterpret_cast<uint32_t*>(p) =
      v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24);
}

__global__ void __launch_bounds__(kThreads)
store_refs_kernel(StoreArgs a) {
  __shared__ uint8_t s_y[kRowsY][kColsY + 3];
  __shared__ int s_b1[kRowsY][kTileW];
  const int k = blockIdx.y;
  const int lane = a.lanes[k], slot = a.slots[k];
  const int tile = blockIdx.x;
  const int n_luma = a.tiles_x * a.tiles_y;
  const int tx = threadIdx.x % (kTileW / 4), ty = threadIdx.x / (kTileW / 4);

  if (tile >= n_luma) {                // a tile of a padded chroma plane
    const int t = tile - n_luma;
    const int per = a.tiles_cx * a.tiles_cy;
    const int pl = t / per;
    const int r0 = (t % per) / a.tiles_cx * kTileH;
    const int c0 = (t % per) % a.tiles_cx * kTileW;
    const int Hc = a.H / 2, Wc = a.W / 2;
    const int Hcp = Hc + 2 * kPadC, Wcp = Wc + 2 * kPadC;
    const int r = r0 + ty, c = c0 + tx * 4;
    if (r >= Hcp || c >= Wcp) return;
    const uint8_t* src = (pl ? a.cr + lane * a.cr_stride
                             : a.cb + lane * a.cb_stride) +
                         (long)clampi(r - kPadC, 0, Hc - 1) * Wc;
    uint32_t v[4];
    for (int i = 0; i < 4; ++i) v[i] = src[clampi(c + i - kPadC, 0, Wc - 1)];
    put4(a.dpb_c + ((((long)lane * a.S + slot) * 2 + pl) * Hcp + r) * Wcp + c,
         v);
    return;
  }

  // luma: the tile's padded rows r0.., columns c0..; picture row of
  // padded row R is R - kPad, clamped
  const int r0 = tile / a.tiles_x * kTileH, c0 = tile % a.tiles_x * kTileW;
  const int Hp = a.H + 2 * kPad, Wp = a.W + 2 * kPad;
  const uint8_t* src = a.y + lane * a.y_stride;
  // s_y[i][j]: picture sample (r0 - kPad - 2 + i, c0 - kPad - 2 + j)
  for (int i = threadIdx.x; i < kRowsY * kColsY; i += kThreads) {
    const int rr = i / kColsY, cc = i % kColsY;
    const int py = clampi(r0 - kPad - 2 + rr, 0, a.H - 1);
    const int px = clampi(c0 - kPad - 2 + cc, 0, a.W - 1);
    s_y[rr][cc] = src[(long)py * a.W + px];
  }
  __syncthreads();
  // s_b1[i][j]: the horizontal 6-tap at sample row i, column c0 + j
  for (int i = threadIdx.x; i < kRowsY * kTileW; i += kThreads) {
    const int rr = i / kTileW, cc = i % kTileW;
    s_b1[rr][cc] = tap6(&s_y[rr][cc], 1);
  }
  __syncthreads();
  const int r = r0 + ty, c = c0 + tx * 4;
  if (r >= Hp || c >= Wp) return;
  uint32_t g[4], bh[4], hh[4], jj[4];
  for (int i = 0; i < 4; ++i) {
    const int x = tx * 4 + i;
    g[i] = s_y[ty + 2][x + 2];
    bh[i] = clip_u8((s_b1[ty + 2][x] + 16) >> 5);
    hh[i] = clip_u8((tap6(&s_y[ty][x + 2], kColsY + 3) + 16) >> 5);
    jj[i] = clip_u8((tap6(&s_b1[ty][x], kTileW) + 512) >> 10);
  }
  const long plane = (long)Hp * Wp;
  uint8_t* dst = a.dpb_y + (((long)lane * a.S + slot) * 4) * plane +
                 (long)r * Wp + c;
  put4(dst, g);
  put4(dst + plane, bh);
  put4(dst + 2 * plane, hh);
  put4(dst + 3 * plane, jj);
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
