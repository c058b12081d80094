// Motion-compensated prediction, luma (quarter-pel) and chroma (1/8-pel).
//
// Replaces: arrow_h264_tpu/ops/pallas/mc_kernel.py::mc_luma_pallas_batch
// (:460) and ::mc_chroma_pallas_batch (:505).  The TPU kernels DMA each
// 16-row band's candidate reference slabs into VMEM (`dma_band`, packed
// u32, per-band candidate lists, a patch pass for MVs outside the slab
// window) before they compute.  Here a block stages each of its cells'
// reference windows from the dense uint8 DPB into shared memory with
// cp.async before it computes, so any MV works and there is no envelope,
// candidate list or patch pass; the predictions are uint8, as the TPU
// kernels store them.
//
// What bounds it: latency and the load/store unit before device-memory
// bytes.  Per 4x4 cell and list the work reads one slot and one MV, the
// cell's reference samples (at most two half-sample planes for luma, a
// 3x3 window of both planes for chroma) and writes 16 luma or 2 x 4
// chroma bytes; a few integer ops per byte.  A 1080p picture is ~3 us of
// bytes.  The kernels before this design (one thread per cell row, K3,
// or chroma cell, K4) took 3.5x that on fields of one MV a list or an MB
// (tools/mc_bench.py, H100 80GB HBM3 at 700 W): each thread waited for
// three dependent global loads (slot, then MV, then reference), and the
// four rows of a cell loaded its slot and MV in four warps.  On random
// per-cell fields (synthetic_abi_p) K3 took 7.5x, twice its time with
// integer MVs: there every second-plane read is a scattered sector.
// Staging per MB with a lane per cell of the MB, and a window per
// partition, was slower still: a warp's copy touched 16-32 rows of the
// DPB, and the load/store unit takes a cycle for each 128-byte line an
// instruction touches.  So lanes take neighbouring cells of one row, as
// before, and each cell stages its own window.
// What the design does about it (K3 and K4 alike):
// - A block takes a strip of SW = 8 MBs of one MB row of one stream,
//   both lists: a thread a (list, 4x4 cell), a warp the 32 cells of one
//   cell row of the strip and one list, so a warp's copy instruction
//   reads one DPB row at neighbouring columns when the MVs agree, and the
//   warps of an unused list (list 1 of a P picture) end at once.
// - Motion: the strip's mv (256 bytes an MB) and refslot (128), which are
//   contiguous, come into shared memory as one pass of 16-byte cp.async
//   (4-byte where a tensor is not 16-byte aligned), each byte read once
//   for both lists; K4 also the stream's cvoff[S].  One wait and one
//   barrier: the only dependent global round trip before the reference
//   copies.
// - Stage: each thread puts every copy of its cell in flight before its
//   one wait: per read and row (luma: 2 reads x 4 rows; chroma: 2 planes
//   x 3 rows), the aligned 8-byte piece that holds the row's first
//   sample, and the next one where the row runs into it.  Rows clamp one
//   by one (the spec's edge extension); a piece wholly outside the padded
//   plane (an MV past the 32-sample padding) is filled with the row's
//   edge sample: the spec's edge extension for columns, exact for any
//   MV.  A thread reads back only its own copies, so this wait needs no
//   barrier.
// - Compute from shared memory: the pieces are laid out piece-major,
//   thread-minor, so a warp's 8-byte reads are conflict-free; 4 bytes at
//   any offset are two words and a funnel shift.  Luma keeps the position
//   table (kLumaLo/Hi) and the SWAR rounding average, chroma the bilinear
//   weights of its 1/8-sample position.
// - Store: a warp writes 128 contiguous luma bytes (a word a lane) or 64
//   chroma bytes (two a lane) of a row.
// - The staged tile takes shared memory from the L1, which the scattered
//   reads of random fields hit: K3 asks for kLumaCarveout = 75 % of the
//   SM's shared memory (fewer blocks an SM than the whole would hold),
//   which kept real MV fields within 5 % of the time with the whole and
//   took random ones at B = 8 from 1.3x to 0.84x the time of the kernel
//   before this design (tools/mc_bench.py).
// Pieces are 8 bytes (cp.async.ca): chroma rows (Wcp = W/2 + 32) are only
// 8-byte aligned when mb_w is odd, and 8-byte pieces keep the tile at
// half the size of 16-byte ones.  A DPB whose address is not 8-byte
// aligned (the wrappers require 4) is staged in 4-byte copies (the
// G = 4 instance of each kernel).
//
// Shared-memory budget, worst case (both lists used, every luma position
// averaging two planes, every row two pieces): a thread stages LCELL =
// 2 reads x 4 rows x 2 pieces x 8 bytes (luma) or CCELL = 2 planes x 3
// rows x 2 x 8 (chroma); tests/test_torch_mc_body.py replays the plan.
// K3: LSMEM = THREADS x LCELL + SW x MOTION = 35,840 bytes a block; K4:
// CSMEM = 27,648 + 4 S; below the 48 KB that would need an opt-in.
// 1080p at B = 1 is 15 x 68 = 1020 blocks, about one wave of K4 (eight
// blocks, 2048 threads an SM) and two of K3.
//
// Offsets into the DPB and the output are 64-bit.
//
// Layouts (all contiguous; dpb 4-byte and mv 8-byte aligned):
//   dpb_y [B, S, 4, Hp, Wp] uint8, Hp = H + 2*PAD, Wp = W + 2*PAD
//   dpb_c [B, S, 2, Hcp, Wcp] uint8, Hcp = H/2 + 2*PADC, Wcp = W/2 + 2*PADC
//   mv [B, n, 4, 4, 2, 2] int32 (y4, x4, list, (x, y)) in quarter samples
//   refslot [B, n, 4, 4, 2] int32, -1 = list unused (output 0), >= S
//     clamps to S - 1
//   cvoff [B, S] int32, 1/8 chroma samples added to the vertical chroma
//     MV of reads from the slot (-2, 0 or +2; spec 8.4.1.4.1)
//   out_y [B, 2, H, W] uint8; out_c [B, 2 (list), 2 (plane), H/2, W/2]

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int PAD = 32;
constexpr int PADC = PAD >> 1;

// ---- the shared-memory plan (tests/test_torch_mc_body.py parses these)
constexpr int SW = 8;                 // MBs a block: a strip of one MB row
constexpr int THREADS = SW * 32;      // a thread a (list, cell)
constexpr int PIECE = 8;              // bytes of a staged piece
constexpr int LCELL = 2 * 4 * 2 * PIECE;   // a luma (cell, list): 2 reads
constexpr int CCELL = 2 * 3 * 2 * PIECE;   // a chroma one: 2 planes
constexpr int MV_BYTES = 256;         // an MB's mv: 16 cells x 2 lists x 2
constexpr int RS_BYTES = 128;         // an MB's refslot
constexpr int MOTION = MV_BYTES + RS_BYTES;
constexpr int LSMEM = THREADS * LCELL + SW * MOTION;   // K3's a block
constexpr int CSMEM = THREADS * CCELL + SW * MOTION;   // K4's, + 4 S
constexpr int kLumaCarveout = 75;    // K3's shared share of the SM, per cent
static_assert(LSMEM <= 48 * 1024 && CSMEM + 4 * 1024 <= 48 * 1024,
              "no opt-in above 48 KB (K4: S <= 1024 slots)");

// ops/inter.py LUMA_TAB, one byte per quarter-sample position
// yFrac * 4 + xFrac: bits 0-3 the first read, bits 4-7 the second, each
// plane (2 bits; 0 G, 1 b, 2 h, 3 j) | +1 row << 2 | +1 column << 3.
// Positions 0-7 in kLumaLo, 8-15 in kLumaHi, position p in byte p & 7:
//   0 G,G  1 G,b  2 b,b  3 b,G+1c  4 G,h  5 b,h  6 b,j  7 b,h+1c
//   8 h,h  9 h,j  10 j,j  11 j,h+1c  12 G+1r,h  13 b+1r,h  14 j,b+1r
//   15 b+1r,h+1c
constexpr uint64_t kLumaLo = 0xA131212081111000ull;
constexpr uint64_t kLumaHi = 0xA5532524A3333222ull;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// N-byte copy global -> shared without holding registers (cp.async,
// sm_80+: 16 bytes past L1, 4 or 8 through it); copy_wait_all closes this
// thread's group of copies and waits for all of them.  Compiled for the
// host (a CPU build of the kernels for debugging), plain copies.
template <int N>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(N)
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

// The PIECE bytes at src in copies of G bytes.
template <int G>
__device__ __forceinline__ void copy_piece(uint8_t* dst, const uint8_t* src) {
#pragma unroll
  for (int k = 0; k < PIECE; k += G) copy_async<G>(dst + k, src + k);
}

// One read of a cell: ROWS rows from row y0 on (each clamped to the
// padded plane: the spec's edge extension) of `plane`, each as the
// aligned piece that holds column x and, where the row runs past it to
// column x + LAST, the next one; into the thread's pieces from dst on (a
// row's two pieces THREADS * PIECE bytes apart, rows 2 THREADS * PIECE).
// A piece wholly outside the row (an MV past the padding; rows are
// multiples of PIECE long, so a piece is wholly inside or outside) is
// filled with the row's edge sample instead: the edge extension for
// columns.
template <int G, int ROWS, int LAST>
__device__ __forceinline__ void stage_read(uint8_t* dst,
                                           const uint8_t* __restrict__ plane,
                                           int y0, int x, int Hp, int Wp) {
  const int col = x & ~(PIECE - 1);
  const bool two = (x & (PIECE - 1)) + LAST >= PIECE;
  if (col >= 0 && col + 2 * PIECE <= Wp) {        // inside the row
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const uint8_t* src = plane + clampi(y0 + r, 0, Hp - 1) * Wp + col;
      uint8_t* d = dst + r * 2 * THREADS * PIECE;
      copy_piece<G>(d, src);
      if (two) copy_piece<G>(d + THREADS * PIECE, src + PIECE);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const uint8_t* row = plane + clampi(y0 + r, 0, Hp - 1) * Wp;
    for (int p = 0; p < 1 + two; ++p) {
      const int c = col + p * PIECE;
      uint8_t* d = dst + (r * 2 + p) * THREADS * PIECE;
      if (c >= 0 && c < Wp) {
        copy_piece<G>(d, row + c);
      } else {
        const uint32_t v = 0x01010101u * row[c < 0 ? 0 : Wp - 1];
        *(uint2*)d = make_uint2(v, v);
      }
    }
  }
}

// The 4 bytes from byte o (0 .. 7) of a staged row: its first piece, and
// its second where o > 4 (piece-major, thread-minor: a warp's reads are
// conflict-free).  Chroma uses bytes 0-2 only and stages the second
// piece where o > 5: at o = 5, byte 3 is whatever the slot held.
__device__ __forceinline__ uint32_t row4(const uint8_t* p, int o) {
  const uint2 a = *(const uint2*)p;
  const uint32_t hi = o > 4 ? *(const uint32_t*)(p + THREADS * PIECE) : 0u;
  return o < 4 ? __funnelshift_r(a.x, a.y, 8 * o)
               : __funnelshift_r(a.y, hi, 8 * (o - 4));
}

// The strip's motion into shared memory: SW MBs of mv and refslot from MB
// index mb0 on (nm of them exist), and cvoff[S] of stream b if cvoff is
// given; then the block's one barrier.
__device__ __forceinline__ void stage_motion(uint8_t* mv_s, uint8_t* rs_s,
                                             int32_t* cvoff_s,
                                             const int32_t* __restrict__ mv,
                                             const int32_t* __restrict__ rs,
                                             const int32_t* __restrict__ cvoff,
                                             long long mb0, int nm, int b,
                                             int S) {
  const int tid = threadIdx.x;
  const uint8_t* m = (const uint8_t*)(mv + mb0 * (MV_BYTES / 4));
  const uint8_t* r = (const uint8_t*)(rs + mb0 * (RS_BYTES / 4));
  const int nmv = nm * MV_BYTES, n = nm * MOTION;
  if ((((uintptr_t)m | (uintptr_t)r) & 15) == 0) {
    for (int i = 16 * tid; i < n; i += 16 * THREADS) {
      if (i < nmv)
        copy_async<16>(mv_s + i, m + i);
      else
        copy_async<16>(rs_s + i - nmv, r + i - nmv);
    }
  } else {
    for (int i = 4 * tid; i < n; i += 4 * THREADS) {
      if (i < nmv)
        copy_async<4>(mv_s + i, m + i);
      else
        copy_async<4>(rs_s + i - nmv, r + i - nmv);
    }
  }
  if (cvoff)
    for (int i = tid; i < S; i += THREADS)
      copy_async<4>(cvoff_s + i, cvoff + (long long)b * S + i);
  copy_wait_all();
  __syncthreads();
}

// grid (ceil(mb_w / SW), mb_h, B); block THREADS; dynamic shared LSMEM.
// Thread t is (list l, cell row y4, MB m of the strip, cell column x4),
// x4 fastest.  Shared memory: the pieces [read][row][piece][thread],
// then the strip's mv and refslot.
template <int G>
__global__ void __launch_bounds__(THREADS)
    mc_luma_kernel(const uint8_t* __restrict__ dpb,
                   const int32_t* __restrict__ mv,
                   const int32_t* __restrict__ refslot,
                   uint8_t* __restrict__ out, int S, int mb_w, int mb_h) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* mv_s = smem + THREADS * LCELL;
  uint8_t* rs_s = mv_s + SW * MV_BYTES;
  const int tid = threadIdx.x;
  const int l = tid / (16 * SW), y4 = (tid / (4 * SW)) & 3;
  const int m = (tid >> 2) % SW, x4 = tid & 3;
  const int mx0 = blockIdx.x * SW, my = blockIdx.y, b = blockIdx.z;
  const int nm = min(SW, mb_w - mx0);
  stage_motion(mv_s, rs_s, nullptr, mv, refslot, nullptr,
               ((long long)b * mb_h + my) * mb_w + mx0, nm, b, S);
  if (m >= nm) return;

  const int H = mb_h * 16, W = mb_w * 16;
  const int Hp = H + 2 * PAD, Wp = W + 2 * PAD;
  const int cell = (m * 16 + y4 * 4 + x4) * 2 + l;       // (cell, list)
  int slot = ((const int32_t*)rs_s)[cell];
  uint32_t o[4] = {0, 0, 0, 0};
  if (slot >= 0) {
    slot = slot < S ? slot : S - 1;
    const int2 v = ((const int2*)mv_s)[cell];
    const int pos = (v.y & 3) * 4 + (v.x & 3);
    const unsigned e =
        (unsigned)((pos < 8 ? kLumaLo : kLumaHi) >> (8 * (pos & 7))) & 0xffu;
    const int nread = (e & 15u) == (e >> 4) ? 1 : 2;
    // the cell's integer sample position in the padded planes
    const int X = (mx0 + m) * 16 + x4 * 4 + (v.x >> 2) + PAD;
    const int Y = my * 16 + y4 * 4 + (v.y >> 2) + PAD;
    const uint8_t* ref = dpb + ((long long)b * S + slot) * 4 * Hp * Wp;
    // read k: plane t & 3, one row down if t & 4, one column right if
    // t & 8
    const unsigned t0 = e & 15u, t1 = e >> 4;
    const int x0 = X + (int)(t0 >> 3), x1 = X + (int)(t1 >> 3);
    const long long plane = (long long)Hp * Wp;
    stage_read<G, 4, 3>(smem + tid * PIECE, ref + (t0 & 3) * plane,
                        Y + (int)((t0 >> 2) & 1), x0, Hp, Wp);
    if (nread == 2)
      stage_read<G, 4, 3>(smem + (8 * THREADS + tid) * PIECE,
                          ref + (t1 & 3) * plane, Y + (int)((t1 >> 2) & 1),
                          x1, Hp, Wp);
    copy_wait_all();
    const int k1 = nread - 1;
    const int o0 = x0 & (PIECE - 1), o1 = (k1 ? x1 : x0) & (PIECE - 1);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t a = row4(smem + (r * 2 * THREADS + tid) * PIECE, o0);
      const uint32_t c =
          row4(smem + ((k1 * 4 + r) * 2 * THREADS + tid) * PIECE, o1);
      o[r] = (a | c) - (((a ^ c) >> 1) & 0x7f7f7f7fu);
    }
  }
  uint8_t* dst = out + (((long long)b * 2 + l) * H + my * 16 + y4 * 4) * W +
                 (mx0 + m) * 16 + x4 * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) *(uint32_t*)(dst + (long long)r * W) = o[r];
}

// grid (ceil(mb_w / SW), mb_h, B); block THREADS; dynamic shared CSMEM +
// 4 S.  Threads as K3's; shared memory: the pieces [plane][row][piece]
// [thread], the strip's mv and refslot, then cvoff[S].
template <int G>
__global__ void __launch_bounds__(THREADS)
    mc_chroma_kernel(const uint8_t* __restrict__ dpb,
                     const int32_t* __restrict__ mv,
                     const int32_t* __restrict__ refslot,
                     const int32_t* __restrict__ cvoff,
                     uint8_t* __restrict__ out, int S, int mb_w, int mb_h) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* mv_s = smem + THREADS * CCELL;
  uint8_t* rs_s = mv_s + SW * MV_BYTES;
  int32_t* cvoff_s = (int32_t*)(rs_s + SW * RS_BYTES);
  const int tid = threadIdx.x;
  const int l = tid / (16 * SW), y4 = (tid / (4 * SW)) & 3;
  const int m = (tid >> 2) % SW, x4 = tid & 3;
  const int mx0 = blockIdx.x * SW, my = blockIdx.y, b = blockIdx.z;
  const int nm = min(SW, mb_w - mx0);
  stage_motion(mv_s, rs_s, cvoff_s, mv, refslot, cvoff,
               ((long long)b * mb_h + my) * mb_w + mx0, nm, b, S);
  if (m >= nm) return;

  const int Hc = mb_h * 8, Wc = mb_w * 8;
  const int Hp = Hc + 2 * PADC, Wp = Wc + 2 * PADC;
  const int cell = (m * 16 + y4 * 4 + x4) * 2 + l;
  int slot = ((const int32_t*)rs_s)[cell];
  uint32_t o[2][2] = {{0, 0}, {0, 0}};       // [plane][row]: 2 samples
  if (slot >= 0) {
    slot = slot < S ? slot : S - 1;
    const int2 v = ((const int2*)mv_s)[cell];
    const int vy = v.y + cvoff_s[slot];
    const int X = (mx0 + m) * 8 + x4 * 2 + (v.x >> 3) + PADC;
    const int Y = my * 8 + y4 * 2 + (vy >> 3) + PADC;
    const uint8_t* ref = dpb + ((long long)b * S + slot) * 2 * Hp * Wp;
    stage_read<G, 3, 2>(smem + tid * PIECE, ref, Y, X, Hp, Wp);
    stage_read<G, 3, 2>(smem + (6 * THREADS + tid) * PIECE,
                        ref + (long long)Hp * Wp, Y, X, Hp, Wp);
    copy_wait_all();
    const int xf = v.x & 7, yf = vy & 7, ox = X & (PIECE - 1);
    const int wA = (8 - xf) * (8 - yf), wB = xf * (8 - yf);
    const int wC = (8 - xf) * yf, wD = xf * yf;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      uint32_t q[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        q[r] = row4(smem + ((pl * 3 + r) * 2 * THREADS + tid) * PIECE, ox);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int A = (q[dy] >> (8 * dx)) & 0xff;
          const int B = (q[dy] >> (8 * dx + 8)) & 0xff;
          const int C = (q[dy + 1] >> (8 * dx)) & 0xff;
          const int D = (q[dy + 1] >> (8 * dx + 8)) & 0xff;
          o[pl][dy] |= (uint32_t)((wA * A + wB * B + wC * C + wD * D + 32) >>
                                  6)
                       << (8 * dx);
        }
    }
  }
#pragma unroll
  for (int pl = 0; pl < 2; ++pl) {
    uint8_t* dst = out + ((((long long)b * 2 + l) * 2 + pl) * Hc + my * 8 +
                          y4 * 2) * Wc + (mx0 + m) * 8 + x4 * 2;
    *(uint16_t*)dst = (uint16_t)o[pl][0];
    *(uint16_t*)(dst + Wc) = (uint16_t)o[pl][1];
  }
}

// Launch `kernel` with `smem_bytes` of dynamic shared memory (below the
// 48 KB that would need an opt-in) and, for carveout >= 0, that per cent
// of the SM's shared memory preferred.
template <typename K, typename... A>
int launch_with(K kernel, dim3 grid, int smem_bytes, int carveout,
                cudaStream_t stream, A... args) {
  if (carveout >= 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, THREADS, smem_bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mc_luma_launch(const uint8_t* dpb, const int32_t* mv,
                              const int32_t* refslot, uint8_t* out, int B,
                              int S, int mb_w, int mb_h, void* stream) {
  const dim3 grid((mb_w + SW - 1) / SW, mb_h, B);
  const cudaStream_t st = (cudaStream_t)stream;
  if (((uintptr_t)dpb & (PIECE - 1)) == 0)
    return launch_with(mc_luma_kernel<PIECE>, grid, LSMEM, kLumaCarveout, st,
                       dpb, mv, refslot, out, S, mb_w, mb_h);
  return launch_with(mc_luma_kernel<4>, grid, LSMEM, kLumaCarveout, st, dpb,
                     mv, refslot, out, S, mb_w, mb_h);
}

extern "C" int mc_chroma_launch(const uint8_t* dpb, const int32_t* mv,
                                const int32_t* refslot, const int32_t* cvoff,
                                uint8_t* out, int B, int S, int mb_w,
                                int mb_h, void* stream) {
  const dim3 grid((mb_w + SW - 1) / SW, mb_h, B);
  const cudaStream_t st = (cudaStream_t)stream;
  const int smem = CSMEM + 4 * S;
  if (((uintptr_t)dpb & (PIECE - 1)) == 0)
    return launch_with(mc_chroma_kernel<PIECE>, grid, smem, -1, st, dpb, mv,
                       refslot, cvoff, out, S, mb_w, mb_h);
  return launch_with(mc_chroma_kernel<4>, grid, smem, -1, st, dpb, mv,
                     refslot, cvoff, out, S, mb_w, mb_h);
}
