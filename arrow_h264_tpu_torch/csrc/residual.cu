// Residual planes (spec 8.5): dequantisation, the inverse transforms, the
// lossless bypass with its intra DPCM and I_PCM, for [B] pictures in one
// launch.
//
// Replaces: no pallas_call.  The reference computes the residual in XLA,
// inside the one jitted executable of decode_frames_batch_fn
// (arrow_h264_tpu/ops/transforms.py::residual_planes, :182, called at
// arrow_h264_tpu/models/pipeline.py:176), where XLA fuses it into a few
// device programs.  The port's plain version (ops/transforms.py::
// residual_planes) runs eagerly as hundreds of small torch operations
// (stacks, transposes, wheres, repeat_interleaves); this kernel is that
// stage as one launch.
//
// What bounds it: bytes.  At 1080p it writes 12.5 MB of int32 planes and
// reads the coefficient classes the round ships (up to ~22 MB with luma4,
// luma8, chroma_ac and pcm); the arithmetic is a few hundred integer
// operations a 4x4 block.
//
// What the design does about it: one block takes a strip of kStrip MBs of
// one MB row, a warp an MB.  In the warp, lanes 0-15 each take one luma
// 4x4 block (dequant, the I16 DC Hadamard entry of its block, IDCT) and
// lanes 16-23 one chroma 4x4 block (dequant, its entry of the 2x2 DC
// transform, IDCT); an 8x8-transform MB runs its four 8x8 blocks on all
// 32 lanes, a row of one block each, then a column.  Results stay in
// shared memory for the bypass DPCM scans (a lane a column or row of the
// MB) and I_PCM; then the block writes its strip row by row, each output
// word once, coalesced along the plane's rows.
//
// The plain version's rules that this reproduces word for word:
// - a coefficient class absent from the ABI (a null pointer here) reads
//   as zero; the 4x4 path runs whenever luma4 or luma_dc is present, on
//   zeros plus the DC where luma4 is absent;
// - the 8x8 result replaces the 4x4 one where tr8 is set, and only when
//   luma8 is present;
// - the I16 DC (and with bypass its raw level) replaces position [0,0] of
//   I16 MBs only; the chroma DC replaces [0,0] of every MB;
// - with bypass, MBs of qp 0 take the raw levels, then the DPCM cumsums of
//   intra MBs (vertical mode 0 / horizontal mode 1 over 4, 8 or 16 sample
//   tiles for I4x4, I8x8, I16; chroma mode 2 vertical / 1 horizontal over
//   the 8x8 chroma MB, but not for I_PCM); I_PCM overrides all.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 8;              // MBs a block, a warp each
constexpr int kThreads = 32 * kStrip;
constexpr int kI4x4 = 0, kI8x8 = 1, kI16 = 2, kIPcm = 3;

struct ResidualArgs {
  const int32_t* kind;                 // [B, n]
  const int32_t* qp;                   // [B, n]
  const int32_t* tr8;                  // [B, n] (read with luma8)
  const int32_t* luma4;                // [B, n, 16, 4, 4] or null
  const int32_t* luma8;                // [B, n, 4, 8, 8] or null
  const int32_t* luma_dc;              // [B, n, 4, 4] or null
  const int32_t* chroma_dc;            // [B, n, 2, 2, 2] or null
  const int32_t* chroma_ac;            // [B, n, 2, 2, 2, 4, 4] or null
  const int32_t* pcm;                  // [B, n, 384] or null
  const int32_t* i4_modes;             // [B, n, 16] (bypass only)
  const int32_t* i8_modes;             // [B, n, 4]
  const int32_t* i16_mode;             // [B, n]
  const int32_t* chroma_mode;          // [B, n]
  const int32_t* ws4;                  // [6, 6, 4, 4] LevelScale4x4
  const int32_t* ws8;                  // [2, 6, 8, 8] LevelScale8x8
  const int32_t* cqp;                  // [52] chroma QP map
  int32_t* res_y;                      // [B, H, W]
  int32_t* res_cb;                     // [B, H/2, W/2]
  int32_t* res_cr;
  int B, mb_w, mb_h, cqp0, cqp1, bypass;
};

// x << s in two's complement, as torch's int32 shift
__device__ __forceinline__ int shl(int x, int s) {
  return (int)((unsigned)x << s);
}

// spec 8.5.12.1 (ops/transforms.py::dequant4x4_dev)
__device__ __forceinline__ int dequant4(int c, int ls, int qp) {
  const int q6 = qp / 6;
  return qp >= 24 ? shl(c * ls, q6 - 4)
                  : (c * ls + (1 << (3 - q6))) >> (4 - q6);
}

// spec 8.5.13.1 and the I16 DC of 8.5.10 share this form
__device__ __forceinline__ int dequant6(int c, int ls, int qp) {
  const int q6 = qp / 6;
  return qp >= 36 ? shl(c * ls, q6 - 6)
                  : (c * ls + (1 << (5 - q6))) >> (6 - q6);
}

// [4][4] in place: rows, then columns, then (h + 32) >> 6 (8.5.12.2)
__device__ __forceinline__ void idct4(int* m) {
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 4, lead = pass == 0 ? 4 : 1;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int* v = m + r * lead;
      const int e0 = v[0] + v[2 * step], e1 = v[0] - v[2 * step];
      const int e2 = (v[step] >> 1) - v[3 * step];
      const int e3 = v[step] + (v[3 * step] >> 1);
      v[0] = e0 + e3;
      v[step] = e1 + e2;
      v[2 * step] = e1 - e2;
      v[3 * step] = e0 - e3;
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = (m[i] + 32) >> 6;
}

// one 8-point stage of 8.5.13.2 over v[0], v[s], ..., v[7s], in place
__device__ __forceinline__ void idct8_line(int* v, int s) {
  const int d0 = v[0], d1 = v[s], d2 = v[2 * s], d3 = v[3 * s];
  const int d4 = v[4 * s], d5 = v[5 * s], d6 = v[6 * s], d7 = v[7 * s];
  const int e0 = d0 + d4;
  const int e1 = -d3 + d5 - d7 - (d7 >> 1);
  const int e2 = d0 - d4;
  const int e3 = d1 + d7 - d3 - (d3 >> 1);
  const int e4 = (d2 >> 1) - d6;
  const int e5 = -d1 + d7 + d5 + (d5 >> 1);
  const int e6 = d2 + (d6 >> 1);
  const int e7 = d3 + d5 + d1 + (d1 >> 1);
  const int f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4;
  const int f3 = e3 + (e5 >> 2), f4 = e2 - e4, f5 = (e3 >> 2) - e5;
  const int f6 = e0 - e6, f7 = e7 - (e1 >> 2);
  v[0] = f0 + f7;
  v[s] = f2 + f5;
  v[2 * s] = f4 + f3;
  v[3 * s] = f6 + f1;
  v[4 * s] = f6 - f1;
  v[5 * s] = f4 - f3;
  v[6 * s] = f2 - f5;
  v[7 * s] = f0 - f7;
}

// the 4x4 Hadamard's sign H[i][k] (8.5.10; H is symmetric)
__device__ __forceinline__ int hsign(int i, int k) {
  const int rows = 0xa6c0;             // bit 4i + k set where H[i][k] = -1
  return (rows >> (4 * i + k)) & 1 ? -1 : 1;
}

__global__ void __launch_bounds__(kThreads)
residual_kernel(ResidualArgs a) {
  __shared__ int s_y[kStrip][256];     // the strip's MBs, 16x16 raster
  __shared__ int s_c[kStrip][2][64];   // chroma, 8x8 raster a plane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, my = blockIdx.y;
  const int mx0 = blockIdx.x * kStrip;
  const int nmb = min(kStrip, a.mb_w - mx0);
  const int n = a.mb_w * a.mb_h;
  int* y = s_y[warp];
  int (*c)[64] = s_c[warp];

  if (warp < nmb) {
    const long mb = (long)b * n + (long)my * a.mb_w + mx0 + warp;
    const int kind = a.kind[mb], qp = a.qp[mb];
    const bool intra = kind <= kIPcm;
    const bool byp = a.bypass && qp == 0;
    const bool use8 = a.luma8 != nullptr && a.tr8[mb] > 0;
    const bool is_pcm = a.pcm != nullptr && kind == kIPcm;

    if (is_pcm) {                      // I_PCM: the raw samples
      for (int i = lane; i < 256; i += 32) y[i] = a.pcm[mb * 384 + i];
      for (int i = lane; i < 128; i += 32)
        c[i >> 6][i & 63] = a.pcm[mb * 384 + 256 + i];
    } else {
      if (lane < 16 && !use8) {        // a luma 4x4 block
        const int gy = lane >> 2, gx = lane & 3;
        int d[16], raw[16];
        const int* ls = a.ws4 + ((intra ? 0 : 3) * 6 + qp % 6) * 16;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int v = a.luma4 ? a.luma4[mb * 256 + lane * 16 + i] : 0;
          raw[i] = v;
          d[i] = a.luma4 ? dequant4(v, ls[i], qp) : 0;
        }
        if (a.luma_dc != nullptr && kind == kI16) {
          const int* dc = a.luma_dc + mb * 16;
          int f = 0;
          for (int k = 0; k < 4; ++k)
            for (int l = 0; l < 4; ++l)
              f += hsign(gy, k) * dc[k * 4 + l] * hsign(l, gx);
          d[0] = dequant6(f, a.ws4[(qp % 6) * 16], qp);
          raw[0] = dc[lane];
        }
        if (!byp) idct4(d);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            y[(gy * 4 + r) * 16 + gx * 4 + x] = byp ? raw[r * 4 + x]
                                                    : d[r * 4 + x];
      } else if (lane >= 16 && lane < 24) {   // a chroma 4x4 block
        const int pl = (lane - 16) >> 2, k = (lane - 16) & 3;
        const int by = k >> 1, bx = k & 1;
        int d[16], raw[16];
        if (a.chroma_ac != nullptr || a.chroma_dc != nullptr) {
          const int off = pl ? a.cqp1 : a.cqp0;
          const int qpc = a.cqp[min(max(qp + off, 0), 51)];
          const int* ls = a.ws4 + (((intra ? 1 : 4) + pl) * 6 + qpc % 6) * 16;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int v = a.chroma_ac
                ? a.chroma_ac[mb * 128 + pl * 64 + k * 16 + i] : 0;
            raw[i] = v;
            d[i] = a.chroma_ac ? dequant4(v, ls[i], qpc) : 0;
          }
          if (a.chroma_dc != nullptr) {
            const int* dc = a.chroma_dc + mb * 8 + pl * 4;
            const int sx = bx ? -1 : 1, sy = by ? -1 : 1;
            const int f = dc[0] + sx * dc[1] + sy * dc[2] + sx * sy * dc[3];
            d[0] = shl(f * ls[0], qpc / 6) >> 5;
            raw[0] = dc[k];
          }
          if (!byp) idct4(d);
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) d[i] = raw[i] = 0;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            c[pl][(by * 4 + r) * 8 + bx * 4 + x] = byp ? raw[r * 4 + x]
                                                       : d[r * 4 + x];
      }
      if (use8) {                      // four 8x8 blocks on 32 lanes
        const int blk = lane >> 3, r = lane & 7;
        int* base = y + (blk >> 1) * 128 + (blk & 1) * 8;
        const int* src = a.luma8 + mb * 256 + blk * 64 + r * 8;
        const int* ls = a.ws8 + ((intra ? 0 : 1) * 6 + qp % 6) * 64 + r * 8;
        int v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = byp ? src[j] : dequant6(src[j], ls[j], qp);
        if (!byp) idct8_line(v, 1);    // horizontal: this lane's row
#pragma unroll
        for (int j = 0; j < 8; ++j) base[r * 16 + j] = v[j];
        __syncwarp();
        if (!byp) {                    // vertical: column r of the block
          idct8_line(base + r, 16);
          for (int i = 0; i < 8; ++i)
            base[i * 16 + r] = (base[i * 16 + r] + 32) >> 6;
        }
      }
      __syncwarp();

      // lossless intra DPCM (8.3.5): lanes 0-15 scan luma columns, 16-31
      // rows; each sample belongs to one direction's cells at most, so
      // the two sets of lanes write disjoint samples
      if (byp && kind <= kI16) {
        const int t = kind == kI4x4 ? 4 : kind == kI8x8 ? 8 : 16;
        const bool vert = lane < 16;
        const int line = lane & 15;
        int run = 0;
        for (int i = 0; i < 16; ++i) {
          const int yy = vert ? i : line, xx = vert ? line : i;
          int mode;
          if (kind == kI4x4)
            mode = a.i4_modes[mb * 16 + (yy >> 2) * 4 + (xx >> 2)];
          else if (kind == kI8x8)
            mode = a.i8_modes[mb * 4 + (yy >> 3) * 2 + (xx >> 3)];
          else
            mode = a.i16_mode[mb];
          if (i % t == 0) run = 0;
          if (mode == (vert ? 0 : 1)) {
            run += y[yy * 16 + xx];
            y[yy * 16 + xx] = run;
          }
        }
        if (a.chroma_ac != nullptr || a.chroma_dc != nullptr) {
          // chroma: mode 2 vertical, 1 horizontal, over the 8x8 MB
          const int cm = a.chroma_mode[mb];
          const int pl = line >> 3, l8 = line & 7;
          if (cm == (vert ? 2 : 1)) {
            int run_c = 0;
            for (int i = 0; i < 8; ++i) {
              int& s = vert ? c[pl][i * 8 + l8] : c[pl][l8 * 8 + i];
              run_c += s;
              s = run_c;
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // the strip's rows, each output word once
  const int H = a.mb_h * 16, W = a.mb_w * 16;
  const int wy = nmb * 16;
  for (int i = threadIdx.x; i < 16 * wy; i += kThreads) {
    const int r = i / wy, x = i % wy;
    a.res_y[((long)b * H + my * 16 + r) * W + mx0 * 16 + x] =
        s_y[x >> 4][r * 16 + (x & 15)];
  }
  const int wc = nmb * 8;
  for (int i = threadIdx.x; i < 2 * 8 * wc; i += kThreads) {
    const int pl = i / (8 * wc), r = (i / wc) % 8, x = i % wc;
    int32_t* out = pl ? a.res_cr : a.res_cb;
    out[((long)b * (H / 2) + my * 8 + r) * (W / 2) + mx0 * 8 + x] =
        s_c[x >> 3][pl][r * 8 + (x & 7)];
  }
}

}  // namespace

extern "C" int residual_launch(
    const int32_t* kind, const int32_t* qp, const int32_t* tr8,
    const int32_t* luma4, const int32_t* luma8, const int32_t* luma_dc,
    const int32_t* chroma_dc, const int32_t* chroma_ac, const int32_t* pcm,
    const int32_t* i4_modes, const int32_t* i8_modes,
    const int32_t* i16_mode, const int32_t* chroma_mode, const int32_t* ws4,
    const int32_t* ws8, const int32_t* cqp, int32_t* res_y, int32_t* res_cb,
    int32_t* res_cr, int B, int mb_w, int mb_h, int cqp0, int cqp1,
    int bypass, void* stream) {
  ResidualArgs a{kind, qp, tr8, luma4, luma8, luma_dc, chroma_dc,
                 chroma_ac, pcm, i4_modes, i8_modes, i16_mode, chroma_mode,
                 ws4, ws8, cqp, res_y, res_cb, res_cr, B, mb_w, mb_h, cqp0,
                 cqp1, bypass};
  if (B == 0 || mb_w == 0 || mb_h == 0) return 0;
  const dim3 grid((mb_w + kStrip - 1) / kStrip, mb_h, B);
  residual_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
