// Motion-compensated prediction, luma (quarter-pel) and chroma (1/8-pel).
//
// Replaces: arrow_h264_tpu/ops/pallas/mc_kernel.py::mc_luma_pallas_batch
// (:460) and ::mc_chroma_pallas_batch (:505).  The TPU kernels read a
// packed u32 DPB through per-band candidate lists and slab windows, with
// a patch pass for MVs outside the window, and store packed u8.  Here
// each thread reads the dense uint8 DPB straight at its MV, so any MV
// works and there is no envelope, candidate list or patch pass; the
// predictions are uint8, as the TPU kernels store them.
//
// What bounds it: device-memory bytes.  Per 4x4 cell and list the work
// reads one slot and one MV, the cell's reference samples (at most two
// half-sample planes for luma, a 3x3 window of both planes for chroma)
// and writes 16 luma or 2 x 4 chroma bytes; a few integer ops per byte.
// What the design does about it:
// - Luma: one thread per (stream, list, 4x4 cell, sample row), four
//   samples a thread.  Neighbouring threads take neighbouring cells of a
//   row, so a warp stores 128 contiguous bytes as 32 aligned words.  The
//   slot and the MV (one 8-byte load) are read once for four samples.
//   The four samples of each of the (at most two) planes that the
//   quarter-sample position averages are read as the two aligned words
//   that hold them, joined in 64 bits and shifted (rows are word-aligned:
//   Wp = W + 64 is a multiple of 16).  The rounding average of two words
//   is SWAR, (a | b) - (((a ^ b) >> 1) & 0x7f7f7f7f) == (a + b + 1) >> 1
//   per byte; positions that read one sample (G, b, h, j) skip the second
//   read.  A window that reaches past the 32-sample padding (an MV that
//   points far outside the picture) takes a byte path that clamps each
//   column: that is the spec's edge extension (8.4.2.2), as in
//   ops/inter.py.  Rows always clamp, one per thread and plane.
// - Chroma: one thread per (stream, list, 2x2 chroma cell) computes both
//   planes: one MV, and per plane three window rows of 3 samples, each
//   from an aligned word pair and a shift (row4, whose fourth byte goes
//   unused; byte path past the padding),
//   then 2 rows x 2 samples stored as 16-bit words.  A warp stores 64
//   contiguous bytes a row, which coalesces as well as wider stores
//   would; two cells a thread would halve the threads for no fewer bytes,
//   so the design keeps one.
//   The vertical chroma MV of each read takes its slot's cvoff (spec
//   8.4.1.4.1: a field picture reading a field of the other parity), one
//   4-byte load of a table of at most 33 ints a stream, which the L1
//   holds; frames pass zeros, so both take one path.
// Offsets into the DPB and the output are 64-bit.  Plain C, no
// intrinsics.
//
// Layouts (all contiguous; dpb 4-byte and mv 8-byte aligned):
//   dpb_y [B, S, 4, Hp, Wp] uint8, Hp = H + 2*PAD, Wp = W + 2*PAD
//   dpb_c [B, S, 2, Hcp, Wcp] uint8, Hcp = H/2 + 2*PADC, Wcp = W/2 + 2*PADC
//   mv [B, n, 4, 4, 2, 2] int32 (y4, x4, list, (x, y)) in quarter samples
//   refslot [B, n, 4, 4, 2] int32, -1 = list unused (output 0), >= S
//     clamps to S - 1
//   cvoff [B, S] int32, 1/8 chroma samples added to the vertical chroma
//     MV of reads from the slot (-2, 0 or +2)
//   out_y [B, 2, H, W] uint8; out_c [B, 2 (list), 2 (plane), H/2, W/2]

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAD = 32;
constexpr int PADC = PAD / 2;

// ops/inter.py LUMA_TAB, one byte per quarter-sample position
// yFrac * 4 + xFrac: bits 0-3 the first read, bits 4-7 the second, each
// plane (2 bits; 0 G, 1 b, 2 h, 3 j) | +1 row << 2 | +1 column << 3.
// Positions 0-7 in kLumaLo, 8-15 in kLumaHi, position p in byte p & 7:
//   0 G,G  1 G,b  2 b,b  3 b,G+1c  4 G,h  5 b,h  6 b,j  7 b,h+1c
//   8 h,h  9 h,j  10 j,j  11 j,h+1c  12 G+1r,h  13 b+1r,h  14 j,b+1r
//   15 b+1r,h+1c
// (registers, not __constant__: the threads of a warp take up to 16
// positions, which the constant cache would serialise)
constexpr uint64_t kLumaLo = 0xA131212081111000ull;
constexpr uint64_t kLumaHi = 0xA5532524A3333222ull;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The word of the 4 bytes row[c], ..., row[c + 3] (row[c] in the low
// byte) of a word-aligned row of Wp (a multiple of 4) samples; columns
// outside [0, Wp) clamp to the edge.  Reads only words inside the row.
__device__ __forceinline__ uint32_t row4(const uint8_t* __restrict__ row,
                                         int c, int Wp) {
  if (c >= 0 && c <= Wp - 4) {
    const uint32_t* w = (const uint32_t*)(row + (c & ~3));
    const int sh = c & 3;
    const uint32_t lo = w[0];
    if (sh == 0) return lo;
    return (uint32_t)((((uint64_t)w[1] << 32) | lo) >> (8 * sh));
  }
  uint32_t v = 0;
  for (int k = 0; k < 4; ++k)
    v |= (uint32_t)row[clampi(c + k, 0, Wp - 1)] << (8 * k);
  return v;
}

// The 4 samples of one read `t` (a nibble of kLumaLo/Hi) of the slot's
// (G, b, h, j) planes `ref` at integer position (xi, yi) of the padded
// planes.
__device__ __forceinline__ uint32_t luma_read(const uint8_t* __restrict__ ref,
                                              unsigned t, int xi, int yi,
                                              int Hp, int Wp) {
  const int y = clampi(yi + (int)((t >> 2) & 1), 0, Hp - 1);
  return row4(ref + ((long long)(t & 3) * Hp + y) * Wp, xi + (int)(t >> 3),
              Wp);
}

// grid (ceil(H * W/4 / blockDim.x), B * 2); y = b * 2 + list; thread i
// of a (stream, list) writes samples 4 * (i % (W/4)) .. + 3 of row
// i / (W/4)
__global__ void mc_luma_kernel(const uint8_t* __restrict__ dpb,
                               const int64_t* __restrict__ mv,
                               const int32_t* __restrict__ refslot,
                               uint32_t* __restrict__ out, int S, int mb_w,
                               int mb_h) {
  const int WC = mb_w * 4, H = mb_h * 16;   // 4-sample words a row, rows
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= WC * H) return;
  const int Y = i / WC, cx = i - Y * WC;
  const int b = blockIdx.y >> 1, lst = blockIdx.y & 1;
  const long long n = (long long)mb_w * mb_h;
  const long long cell = ((b * n + (Y >> 4) * mb_w + (cx >> 2)) * 16 +
                          ((Y & 15) >> 2) * 4 + (cx & 3)) * 2 + lst;
  uint32_t* o = out + (((long long)b * 2 + lst) * H + Y) * WC + cx;
  int slot = refslot[cell];
  if (slot < 0) {
    *o = 0;
    return;
  }
  slot = slot < S ? slot : S - 1;
  const int64_t m = mv[cell];               // x in the low word
  const int mvx = (int32_t)(uint32_t)m, mvy = (int32_t)(m >> 32);
  const int Hp = H + 2 * PAD, Wp = WC * 4 + 2 * PAD;
  const int xi = cx * 4 + (mvx >> 2) + PAD;   // arithmetic shift == floor
  const int yi = Y + (mvy >> 2) + PAD;
  const int pos = (mvy & 3) * 4 + (mvx & 3);
  const unsigned e =
      (unsigned)((pos < 8 ? kLumaLo : kLumaHi) >> (8 * (pos & 7))) & 0xffu;
  const uint8_t* ref = dpb + ((long long)b * S + slot) * 4 * Hp * Wp;
  const uint32_t a = luma_read(ref, e & 15u, xi, yi, Hp, Wp);
  if ((e & 15u) == (e >> 4)) {              // G, b, h or j itself
    *o = a;
    return;
  }
  const uint32_t c = luma_read(ref, e >> 4, xi, yi, Hp, Wp);
  *o = (a | c) - (((a ^ c) >> 1) & 0x7f7f7f7fu);
}

// grid (ceil(H/4 * W/4 / blockDim.x), B * 2); y = b * 2 + list; thread i
// of a (stream, list) writes the 2x2 chroma cell i % (W/4) of cell row
// i / (W/4) in both planes
__global__ void mc_chroma_kernel(const uint8_t* __restrict__ dpb,
                                 const int64_t* __restrict__ mv,
                                 const int32_t* __restrict__ refslot,
                                 const int32_t* __restrict__ cvoff,
                                 uint16_t* __restrict__ out, int S, int mb_w,
                                 int mb_h) {
  const int WC = mb_w * 4, HC = mb_h * 4;   // 2x2 cells a row, a column
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= WC * HC) return;
  const int cy = i / WC, cx = i - cy * WC;
  const int b = blockIdx.y >> 1, lst = blockIdx.y & 1;
  const long long n = (long long)mb_w * mb_h;
  const long long cell = ((b * n + (cy >> 2) * mb_w + (cx >> 2)) * 16 +
                          (cy & 3) * 4 + (cx & 3)) * 2 + lst;
  const int Hc = HC * 2;
  const long long plane = (long long)Hc * WC;   // 16-bit words a plane
  uint16_t* o = out + (((long long)b * 2 + lst) * 2 * Hc + 2 * cy) * WC + cx;
  int slot = refslot[cell];
  if (slot < 0) {
    o[0] = o[WC] = o[plane] = o[plane + WC] = 0;
    return;
  }
  slot = slot < S ? slot : S - 1;
  const int64_t m = mv[cell];
  const int mvx = (int32_t)(uint32_t)m;
  const int mvy = (int32_t)(m >> 32) + cvoff[(long long)b * S + slot];
  const int Hp = Hc + 2 * PADC, Wp = WC * 2 + 2 * PADC;
  const int xi = 2 * cx + (mvx >> 3) + PADC;
  const int yi = 2 * cy + (mvy >> 3) + PADC;
  const int xf = mvx & 7, yf = mvy & 7;
  const int wA = (8 - xf) * (8 - yf), wB = xf * (8 - yf);
  const int wC = (8 - xf) * yf, wD = xf * yf;
  const long long r0 = (long long)clampi(yi, 0, Hp - 1) * Wp;
  const long long r1 = (long long)clampi(yi + 1, 0, Hp - 1) * Wp;
  const long long r2 = (long long)clampi(yi + 2, 0, Hp - 1) * Wp;
  const uint8_t* ref = dpb + ((long long)b * S + slot) * 2 * Hp * Wp;
  for (int pl = 0; pl < 2; ++pl) {
    const uint8_t* p = ref + (long long)pl * Hp * Wp;
    // bytes 0-2 of each row word are the window; byte 3 goes unused
    const uint32_t q[3] = {row4(p + r0, xi, Wp), row4(p + r1, xi, Wp),
                           row4(p + r2, xi, Wp)};
    for (int dy = 0; dy < 2; ++dy) {
      unsigned v = 0;
      for (int dx = 0; dx < 2; ++dx) {
        const int A = (q[dy] >> (8 * dx)) & 0xff;
        const int B = (q[dy] >> (8 * dx + 8)) & 0xff;
        const int C = (q[dy + 1] >> (8 * dx)) & 0xff;
        const int D = (q[dy + 1] >> (8 * dx + 8)) & 0xff;
        v |= (unsigned)((wA * A + wB * B + wC * C + wD * D + 32) >> 6)
             << (8 * dx);
      }
      o[pl * plane + dy * WC] = (uint16_t)v;
    }
  }
}

constexpr int kThreads = 256;

int blocks(int work) { return (work + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int mc_luma_launch(const uint8_t* dpb, const int32_t* mv,
                              const int32_t* refslot, uint8_t* out, int B,
                              int S, int mb_w, int mb_h, void* stream) {
  const dim3 grid(blocks(mb_w * 4 * mb_h * 16), B * 2);
  mc_luma_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      dpb, (const int64_t*)mv, refslot, (uint32_t*)out, S, mb_w, mb_h);
  return (int)cudaGetLastError();
}

extern "C" int mc_chroma_launch(const uint8_t* dpb, const int32_t* mv,
                                const int32_t* refslot, const int32_t* cvoff,
                                uint8_t* out, int B, int S, int mb_w,
                                int mb_h, void* stream) {
  const dim3 grid(blocks(mb_w * 4 * mb_h * 4), B * 2);
  mc_chroma_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      dpb, (const int64_t*)mv, refslot, cvoff, (uint16_t*)out, S, mb_w,
      mb_h);
  return (int)cudaGetLastError();
}
