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
// one MB row, a warp an MB.  A warp first stages its MB's classes into
// shared memory with coalesced 16-byte cp.async (luma4 or luma8 by tr8,
// luma_dc of an I16 MB, chroma_dc and chroma_ac; an I_PCM MB's 384
// samples straight into its result tiles); a class whose base is not
// 16-byte aligned (bit clear in `vec`) is copied a word at a time.  The
// staged 16-byte pieces of a 4x4 block or an 8x8 row sit in a swizzled
// order, so that the lanes' 16-byte reads are free of bank conflicts.
// Lanes 0-15 each take one luma 4x4 block and lanes 16-23 one chroma 4x4
// block in one pass (dequant with the LevelScale row read as int4s and
// without a branch, IDCT; the I16 DC Hadamard entry of a luma block, the
// 2x2 DC entry of a chroma one); an 8x8-transform MB runs its four 8x8
// blocks on all 32 lanes, a row of one block each, then a column.
// Results stay in shared memory for the bypass DPCM scans (a lane a
// column or row of the MB); then the block writes its strip as int4
// groups, each output word once: a full strip's row is 128 luma or 64
// chroma words, indexed by shifts and masks, and the columns past a
// ragged last strip are masked.

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
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 8;              // MBs a block, a warp each
constexpr int kThreads = 32 * kStrip;
constexpr int kYGroups = 4 * kStrip;   // int4 groups of a full strip's row
constexpr int kCGroups = 2 * kStrip;   // luma and chroma
static_assert((kStrip & (kStrip - 1)) == 0, "kStrip: a power of two");
constexpr int kI4x4 = 0, kI8x8 = 1, kI16 = 2, kIPcm = 3;
// A warp's staging buffer, in words: luma4 (16 blocks of 16) or luma8
// (32 rows of 8), luma_dc, chroma_dc, chroma_ac (8 blocks of 16).  A
// quarter warp's eight 16-byte reads are free of bank conflicts when
// they start 4 banks apart: piece p of 4x4 block q lies at piece
// p ^ swz4(q), half h of 8x8 row r at half h ^ swz8(r).
constexpr int kLumaDc = 256, kChromaDc = kLumaDc + 16;
constexpr int kChromaAc = kChromaDc + 8;
constexpr int kStage = kChromaAc + 128;
// results: kYPitch words an MB's luma (16x16 raster) and kCPitch a
// chroma plane (8x8), so that the write-out's reads are conflict-free
constexpr int kYPitch = 16 * 16 + 16;
constexpr int kCPitch = 8 * 8 + 4;
// bits of the launch's `vec`: the class's base is 16-byte aligned
// (ops/kernels/residual.py CLASS_SHAPES order)
constexpr int kVecLuma4 = 1, kVecLuma8 = 2, kVecLumaDc = 4;
constexpr int kVecChromaDc = 8, kVecChromaAc = 16, kVecPcm = 32;

__device__ __forceinline__ int swz4(int q) { return (q >> 1) & 3; }
__device__ __forceinline__ int swz8(int r) { return (r >> 2) & 1; }

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
  int B, mb_w, mb_h, cqp0, cqp1, bypass, vec;
};

// 4- or 16-byte copy global -> shared without holding registers
// (cp.async, sm_80+); copy_wait_all closes this thread's group of copies
// and waits for them.  Compiled for the host (a CPU build of the kernel
// for debugging), plain copies.
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

__device__ __forceinline__ void copy_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// 16 bytes global -> shared: one copy where `vec` (the class's base is
// 16-byte aligned; every MB's offset is a multiple of 32 bytes), else
// four of a word.
__device__ __forceinline__ void copy16(int* dst, const int32_t* src,
                                       bool vec) {
  if (vec) {
    copy_async<16>(dst, src);
    return;
  }
  for (int k = 0; k < 4; ++k) copy_async<4>(dst + k, src + k);
}

__device__ __forceinline__ int4 ld4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}

__device__ __forceinline__ void st4(int* p, const int* v) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// x << s in two's complement, as torch's int32 shift
__device__ __forceinline__ int shl(int x, int s) {
  return (int)((unsigned)x << s);
}

// spec 8.5.12.1 (ops/transforms.py::dequant4x4_dev) at QP' qp, without
// a branch: c * ls << (qp/6 - 4) from qp 24 on, else
// (c * ls + 2^(3 - qp/6)) >> (4 - qp/6).  It holds the shifts and the
// rounding of one qp, so that a coefficient costs a multiply, a shift and
// an add.
struct Dequant4 {
  int lsh, rnd, rsh;
  __device__ __forceinline__ explicit Dequant4(int qp) {
    const int q6 = qp / 6;
    lsh = max(q6 - 4, 0);
    rsh = max(4 - q6, 0);
    rnd = rsh ? 1 << (rsh - 1) : 0;
  }
  __device__ __forceinline__ int operator()(int c, int ls) const {
    return (shl(c * ls, lsh) + rnd) >> rsh;
  }
};

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

// the copies of MB mb's classes into its warp's staging buffer st, lane
// by lane (16-byte groups); an I_PCM MB's samples straight into its
// result tiles y and c
__device__ __forceinline__ void stage_mb(const ResidualArgs& a, int kind,
                                         bool use8, long mb, int* st, int* y,
                                         int* c, int lane) {
  if (a.pcm != nullptr && kind == kIPcm) {
    for (int q = lane; q < 96; q += 32)
      copy16(q < 64 ? y + 4 * q
                    : c + ((q - 64) >> 4) * kCPitch + 4 * ((q - 64) & 15),
             a.pcm + mb * 384 + 4 * q, a.vec & kVecPcm);
    return;
  }
  for (int q = lane; q < 64; q += 32) {
    if (use8)
      copy16(st + (q >> 1) * 8 + 4 * ((q & 1) ^ swz8(q >> 1)),
             a.luma8 + mb * 256 + 4 * q, a.vec & kVecLuma8);
    else if (a.luma4 != nullptr)
      copy16(st + (q >> 2) * 16 + 4 * ((q & 3) ^ swz4(q >> 2)),
             a.luma4 + mb * 256 + 4 * q, a.vec & kVecLuma4);
  }
  if (a.luma_dc != nullptr && kind == kI16 && !use8 && lane < 4)
    copy16(st + kLumaDc + 4 * lane, a.luma_dc + mb * 16 + 4 * lane,
           a.vec & kVecLumaDc);
  if (a.chroma_dc != nullptr && lane < 2)
    copy16(st + kChromaDc + 4 * lane, a.chroma_dc + mb * 8 + 4 * lane,
           a.vec & kVecChromaDc);
  if (a.chroma_ac != nullptr)
    copy16(st + kChromaAc + (lane >> 2) * 16 +
               4 * ((lane & 3) ^ swz4(lane >> 2)),
           a.chroma_ac + mb * 128 + 4 * lane, a.vec & kVecChromaAc);
}

// MB mb's residual (not I_PCM) from its staged classes st into its luma
// tile y (16x16 raster) and chroma tiles c, c + kCPitch (8x8 rasters)
__device__ __forceinline__ void compute_mb(const ResidualArgs& a, int kind,
                                           int qp, bool use8, long mb,
                                           const int* st, int* y, int* c,
                                           int lane) {
  const bool intra = kind <= kIPcm;
  const bool byp = a.bypass && qp == 0;
  const bool dc16 = a.luma_dc != nullptr && kind == kI16 && !use8;
  const bool chroma = a.chroma_ac != nullptr || a.chroma_dc != nullptr;

  if (lane < 24 && (lane >= 16 || !use8)) {
    // a 4x4 block, in one pass: lanes 0-15 luma block `blk`, 16-23
    // chroma block k of plane pl (blk = pl * 4 + k)
    const bool is_c = lane >= 16;
    const int blk = is_c ? lane - 16 : lane;
    const int pl = blk >> 2, k = blk & 3;
    int qq = qp, row = (intra ? 0 : 3) * 6 + qp % 6;
    if (is_c) {
      qq = a.cqp[min(max(qp + (pl ? a.cqp1 : a.cqp0), 0), 51)];
      row = ((intra ? 1 : 4) + pl) * 6 + qq % 6;
    }
    const bool have = is_c ? a.chroma_ac != nullptr : a.luma4 != nullptr;
    const int* co = st + (is_c ? kChromaAc : 0) + blk * 16;
    const Dequant4 dq(qq);
    int d[16], raw[16];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int4 v = have ? ld4(co + 4 * (p ^ swz4(blk)))
                          : make_int4(0, 0, 0, 0);
      const int4 l = __ldg(reinterpret_cast<const int4*>(a.ws4 + row * 16) + p);
      raw[4 * p] = v.x, raw[4 * p + 1] = v.y;
      raw[4 * p + 2] = v.z, raw[4 * p + 3] = v.w;
      d[4 * p] = dq(v.x, l.x), d[4 * p + 1] = dq(v.y, l.y);
      d[4 * p + 2] = dq(v.z, l.z), d[4 * p + 3] = dq(v.w, l.w);
    }
    if (!is_c && dc16) {               // the I16 DC's entry of this block
      const int* dc = st + kLumaDc;
      const int gy = blk >> 2, gx = blk & 3;
      int f = 0;
      for (int i = 0; i < 4; ++i)
        for (int l = 0; l < 4; ++l)
          f += hsign(gy, i) * dc[i * 4 + l] * hsign(l, gx);
      d[0] = dequant6(f, a.ws4[(qp % 6) * 16], qp);
      raw[0] = dc[blk];
    }
    if (is_c && a.chroma_dc != nullptr) {      // the 2x2 chroma DC's entry
      const int* dc = st + kChromaDc + pl * 4;
      const int sx = (k & 1) ? -1 : 1, sy = (k >> 1) ? -1 : 1;
      const int f = dc[0] + sx * dc[1] + sy * dc[2] + sx * sy * dc[3];
      d[0] = shl(f * a.ws4[row * 16], qq / 6) >> 5;
      raw[0] = dc[k];
    }
    if (!byp) idct4(d);
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = byp ? raw[i] : d[i];
    int* out = is_c ? c + pl * kCPitch + (k >> 1) * 32 + (k & 1) * 4
                    : y + (blk >> 2) * 64 + (blk & 3) * 4;
    const int pitch = is_c ? 8 : 16;
#pragma unroll
    for (int r = 0; r < 4; ++r) st4(out + r * pitch, d + r * 4);
  }
  if (use8) {                          // four 8x8 blocks on 32 lanes
    const int blk = lane >> 3, r = lane & 7;
    int* base = y + (blk >> 1) * 128 + (blk & 1) * 8;
    const int4* ls = reinterpret_cast<const int4*>(
        a.ws8 + ((intra ? 0 : 1) * 6 + qp % 6) * 64 + r * 8);
    const int4 lo = ld4(st + lane * 8 + 4 * swz8(lane));
    const int4 hi = ld4(st + lane * 8 + 4 * (1 ^ swz8(lane)));
    int v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if (!byp) {
      const int4 l0 = __ldg(ls), l1 = __ldg(ls + 1);
      const int l[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = dequant6(v[j], l[j], qp);
      idct8_line(v, 1);                // horizontal: this lane's row
    }
    st4(base + r * 16, v);
    st4(base + r * 16 + 4, v + 4);
    __syncwarp();
    if (!byp) {                        // vertical: column r of the block
      idct8_line(base + r, 16);
      for (int i = 0; i < 8; ++i)
        base[i * 16 + r] = (base[i * 16 + r] + 32) >> 6;
    }
  }
  __syncwarp();

  // lossless intra DPCM (8.3.5): lanes 0-15 scan luma columns, 16-31
  // rows; each sample belongs to one direction's cells at most, so the
  // two sets of lanes write disjoint samples
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
    if (chroma) {
      // chroma: mode 2 vertical, 1 horizontal, over the 8x8 MB
      const int cm = a.chroma_mode[mb];
      int* cp = c + (line >> 3) * kCPitch;
      const int l8 = line & 7;
      if (cm == (vert ? 2 : 1)) {
        int run_c = 0;
        for (int i = 0; i < 8; ++i) {
          int& s = vert ? cp[i * 8 + l8] : cp[l8 * 8 + i];
          run_c += s;
          s = run_c;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
residual_kernel(ResidualArgs a) {
  __shared__ __align__(16) int s_stage[kStrip][kStage];
  __shared__ __align__(16) int s_y[kStrip][kYPitch];   // the strip's MBs
  __shared__ __align__(16) int s_c[kStrip][2][kCPitch];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, my = blockIdx.y;
  const int mx0 = blockIdx.x * kStrip;
  const int nmb = min(kStrip, a.mb_w - mx0);
  const int H = a.mb_h * 16, W = a.mb_w * 16;

  if (warp < nmb) {
    const long mb = ((long)b * a.mb_h + my) * a.mb_w + mx0 + warp;
    const int kind = a.kind[mb], qp = a.qp[mb];
    const bool use8 = a.luma8 != nullptr && a.tr8[mb] > 0;
    const bool pcm = a.pcm != nullptr && kind == kIPcm;
    stage_mb(a, kind, use8, mb, s_stage[warp], s_y[warp], s_c[warp][0],
             lane);
    copy_wait_all();
    __syncwarp();
    if (!pcm)                          // I_PCM overrides all
      compute_mb(a, kind, qp, use8, mb, s_stage[warp], s_y[warp],
                 s_c[warp][0], lane);
  }
  __syncthreads();

  // the strip as int4 groups, each output word once: a full strip's luma
  // rows are kYGroups groups, its chroma rows kCGroups (powers of two:
  // shifts and masks); a ragged strip's columns past its nmb MBs are
  // masked
#pragma unroll
  for (int j = threadIdx.x; j < 16 * kYGroups; j += kThreads) {
    const int r = j / kYGroups, x = (j % kYGroups) * 4;
    if (x < nmb * 16)
      *reinterpret_cast<int4*>(
          a.res_y + ((long)b * H + my * 16 + r) * W + mx0 * 16 + x) =
          ld4(&s_y[x >> 4][r * 16 + (x & 15)]);
  }
#pragma unroll
  for (int j = threadIdx.x; j < 2 * 8 * kCGroups; j += kThreads) {
    const int pl = j / (8 * kCGroups), r = j / kCGroups % 8;
    const int x = (j % kCGroups) * 4;
    int32_t* out = pl ? a.res_cr : a.res_cb;
    if (x < nmb * 8)
      *reinterpret_cast<int4*>(
          out + ((long)b * (H / 2) + my * 8 + r) * (W / 2) + mx0 * 8 + x) =
          ld4(&s_c[x >> 3][pl][r * 8 + (x & 7)]);
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
    int bypass, int vec, void* stream) {
  ResidualArgs a{kind, qp, tr8, luma4, luma8, luma_dc, chroma_dc,
                 chroma_ac, pcm, i4_modes, i8_modes, i16_mode, chroma_mode,
                 ws4, ws8, cqp, res_y, res_cb, res_cr, B, mb_w, mb_h, cqp0,
                 cqp1, bypass, vec};
  if (B == 0 || mb_w == 0 || mb_h == 0) return 0;
  const dim3 grid((mb_w + kStrip - 1) / kStrip, mb_h, B);
  residual_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
