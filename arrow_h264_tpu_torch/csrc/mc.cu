// Motion-compensated prediction, luma (quarter-pel) and chroma (1/8-pel).
//
// Replaces: arrow_h264_tpu/ops/pallas/mc_kernel.py::mc_luma_pallas_batch
// (:460) and ::mc_chroma_pallas_batch (:505).  The TPU kernels read a
// packed u32 DPB through per-band candidate lists and slab windows, with
// a patch pass for MVs outside the window.  Here each thread computes one
// output sample of one reference list straight from the dense uint8 DPB,
// so any MV works and there is no envelope, candidate list or patch pass.
//
// What bounds it: device-memory bytes.  Per output sample the luma kernel
// reads two uint8 samples of the stored (G, b, h, j) planes and the
// cell's MV and slot, and writes one int32; there are a few integer ops
// per byte.  The design keeps reads coalesced: neighbouring threads take
// neighbouring samples of one row, and the four samples of a 4x4 cell
// row share one MV, so a warp reads a few contiguous runs of the
// reference plane.  Clamping the indices into the padded planes is the
// spec's edge extension (8.4.2.2), as in ops/inter.py.
//
// Layouts (all contiguous):
//   dpb_y [B, S, 4, Hp, Wp] uint8, Hp = H + 2*PAD, Wp = W + 2*PAD
//   dpb_c [B, S, 2, Hcp, Wcp] uint8, Hcp = H/2 + 2*PADC, Wcp = W/2 + 2*PADC
//   mv [B, n, 4, 4, 2, 2] int32 (y4, x4, list, (x, y)) in quarter samples
//   refslot [B, n, 4, 4, 2] int32, -1 = list unused (output 0)
//   out_y [B, 2, H, W] int32; out_c [B, 2 (list), 2 (plane), H/2, W/2]

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAD = 32;
constexpr int PADC = PAD / 2;

// (plane1, dy1, dx1, plane2, dy2, dx2) per (yFrac, xFrac); planes 0 G,
// 1 b, 2 h, 3 j (ops/inter.py LUMA_TAB)
__constant__ int kLumaTab[16][6] = {
    {0, 0, 0, 0, 0, 0}, {0, 0, 0, 1, 0, 0}, {1, 0, 0, 1, 0, 0},
    {1, 0, 0, 0, 0, 1},
    {0, 0, 0, 2, 0, 0}, {1, 0, 0, 2, 0, 0}, {1, 0, 0, 3, 0, 0},
    {1, 0, 0, 2, 0, 1},
    {2, 0, 0, 2, 0, 0}, {2, 0, 0, 3, 0, 0}, {3, 0, 0, 3, 0, 0},
    {3, 0, 0, 2, 0, 1},
    {0, 1, 0, 2, 0, 0}, {1, 1, 0, 2, 0, 0}, {3, 0, 0, 1, 1, 0},
    {1, 1, 0, 2, 0, 1},
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// grid (ceil(W / blockDim.x), H, B * 2); z = b * 2 + list
__global__ void mc_luma_kernel(const uint8_t* __restrict__ dpb,
                               const int32_t* __restrict__ mv,
                               const int32_t* __restrict__ refslot,
                               int32_t* __restrict__ out, int S, int mb_w,
                               int mb_h) {
  const int W = mb_w * 16, H = mb_h * 16;
  const int X = blockIdx.x * blockDim.x + threadIdx.x;
  const int Y = blockIdx.y;
  const int b = blockIdx.z >> 1, lst = blockIdx.z & 1;
  if (X >= W) return;
  const long n = (long)mb_w * mb_h;
  const long cell = ((b * n + (Y >> 4) * mb_w + (X >> 4)) * 16 +
                     ((Y & 15) >> 2) * 4 + ((X & 15) >> 2)) * 2 + lst;
  const long o = (((long)b * 2 + lst) * H + Y) * W + X;
  int slot = refslot[cell];
  if (slot < 0) {
    out[o] = 0;
    return;
  }
  slot = slot < S ? slot : S - 1;
  const int mvx = mv[cell * 2], mvy = mv[cell * 2 + 1];
  const int Hp = H + 2 * PAD, Wp = W + 2 * PAD;
  const int xi = X + (mvx >> 2) + PAD;   // arithmetic shift == floor
  const int yi = Y + (mvy >> 2) + PAD;
  const int* t = kLumaTab[(mvy & 3) * 4 + (mvx & 3)];
  const uint8_t* base = dpb + ((long)b * S + slot) * 4 * Hp * Wp;
  const int p1 = base[((long)t[0] * Hp + clampi(yi + t[1], 0, Hp - 1)) * Wp +
                      clampi(xi + t[2], 0, Wp - 1)];
  const int p2 = base[((long)t[3] * Hp + clampi(yi + t[4], 0, Hp - 1)) * Wp +
                      clampi(xi + t[5], 0, Wp - 1)];
  // full/half positions have p1 == p2, where the average is p1 itself
  out[o] = (p1 + p2 + 1) >> 1;
}

// grid (ceil(W/2 / blockDim.x), H/2, B * 2); z = b * 2 + list; each
// thread writes the sample of both chroma planes
__global__ void mc_chroma_kernel(const uint8_t* __restrict__ dpb,
                                 const int32_t* __restrict__ mv,
                                 const int32_t* __restrict__ refslot,
                                 int32_t* __restrict__ out, int S, int mb_w,
                                 int mb_h) {
  const int W = mb_w * 8, H = mb_h * 8;
  const int X = blockIdx.x * blockDim.x + threadIdx.x;
  const int Y = blockIdx.y;
  const int b = blockIdx.z >> 1, lst = blockIdx.z & 1;
  if (X >= W) return;
  const long n = (long)mb_w * mb_h;
  const long cell = ((b * n + (Y >> 3) * mb_w + (X >> 3)) * 16 +
                     ((Y & 7) >> 1) * 4 + ((X & 7) >> 1)) * 2 + lst;
  const long plane_sz = (long)H * W;
  const long o = (((long)b * 2 + lst) * 2) * plane_sz + (long)Y * W + X;
  int slot = refslot[cell];
  if (slot < 0) {
    out[o] = 0;
    out[o + plane_sz] = 0;
    return;
  }
  slot = slot < S ? slot : S - 1;
  const int mvx = mv[cell * 2], mvy = mv[cell * 2 + 1];
  const int Hp = H + 2 * PADC, Wp = W + 2 * PADC;
  const int xi = X + (mvx >> 3) + PADC;
  const int yi = Y + (mvy >> 3) + PADC;
  const int xf = mvx & 7, yf = mvy & 7;
  const int y0 = clampi(yi, 0, Hp - 1), y1 = clampi(yi + 1, 0, Hp - 1);
  const int x0 = clampi(xi, 0, Wp - 1), x1 = clampi(xi + 1, 0, Wp - 1);
  const uint8_t* base = dpb + ((long)b * S + slot) * 2 * Hp * Wp;
  for (int pl = 0; pl < 2; ++pl) {
    const uint8_t* p = base + (long)pl * Hp * Wp;
    const int A = p[(long)y0 * Wp + x0], Bv = p[(long)y0 * Wp + x1];
    const int C = p[(long)y1 * Wp + x0], D = p[(long)y1 * Wp + x1];
    out[o + pl * plane_sz] = ((8 - xf) * (8 - yf) * A + xf * (8 - yf) * Bv +
                              (8 - xf) * yf * C + xf * yf * D + 32) >> 6;
  }
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int mc_luma_launch(const uint8_t* dpb, const int32_t* mv,
                              const int32_t* refslot, int32_t* out, int B,
                              int S, int mb_w, int mb_h, void* stream) {
  const dim3 grid((mb_w * 16 + kThreads - 1) / kThreads, mb_h * 16, B * 2);
  mc_luma_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      dpb, mv, refslot, out, S, mb_w, mb_h);
  return (int)cudaGetLastError();
}

extern "C" int mc_chroma_launch(const uint8_t* dpb, const int32_t* mv,
                                const int32_t* refslot, int32_t* out, int B,
                                int S, int mb_w, int mb_h, void* stream) {
  const dim3 grid((mb_w * 8 + kThreads - 1) / kThreads, mb_h * 8, B * 2);
  mc_chroma_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      dpb, mv, refslot, out, S, mb_w, mb_h);
  return (int)cudaGetLastError();
}
