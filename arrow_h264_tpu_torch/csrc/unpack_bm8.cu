// The wire's bm8 coefficient expansion: every coefficient class of a wire
// round that ships as bm8 (row indices, 16-bit significance bitmaps and
// packed int8 values a lane) scattered back into its dense [B, grid, w]
// int32 form, all classes of the round in two launches of one call.
//
// Replaces: no pallas_call.  The reference expands bm8 sections in XLA
// (arrow_h264_tpu/ops/wire.py::_scatter_bm8, :1057, inside
// unpack_wire_frame, jitted and vmapped over the lanes by unpack_fn,
// :1208).  The port's plain version (ops/wire.py::_scatter_bm8) runs
// eagerly as ~15 torch launches a class, among them a cumsum in int64
// over every significance bit of every lane.
//
// What bounds it: bytes, and of them the dense output, written once
// (zero rows included): n * cells * w * 4 bytes a class and lane, 8.4 MB
// for l4 at 1080p (~0.0025 ms at 3.35 TB/s).  The bitmaps, values and
// indices are read once and are a small part.
//
// What the design does about it.  The running count of set bits is a
// scan over all rows of a (class, lane), so it is chunked, with nothing
// wider than int32, and every class of the round goes through the same
// two launches (the wrapper, ops/kernels/unpack_bm8.py, lays the classes
// out as a table in the launch's parameters; a block finds its class by
// the classes' first blocks):
//   1. `scan`: a block takes kChunk rows of one (class, lane), stages
//      their bitmaps and indices in shared memory with 16-byte copies,
//      counts each row's set bits (the first w bits), writes each row's
//      first value position within the chunk and the chunk's total, and
//      enters its rows in the row map (dense row -> bm8 row; an index
//      outside [0, grid), the bucket padding, is dropped).  A warp takes
//      kWarpRows of them, 32 consecutive rows a round (a scan by
//      shuffles, carried over the rounds), so its stores are of 32
//      consecutive rows;
//   2. `expand`: a block takes a tile of dense rows of one (class, lane)
//      (the wrapper's TILE_WORDS words, at most kTileRows rows).  A
//      thread a row reads the row map, the row's bitmap and its first
//      position in its chunk, once a row, while the block's warps scan
//      the lane's chunk totals (32 chunks a warp: the chunks before a
//      row's are its group's scan and the totals of the groups before).
//      The row map is not cleared between calls: an entry j counts only
//      where bm8 row j's index is that dense row (the indices of real
//      rows are distinct), so no launch fills it.  A tile with no live
//      row writes zeros.  Else every output word is written once, a
//      16-byte store a group of 4 (neighbouring threads on neighbouring
//      groups): a dense row no bm8 row maps to is zeros, else set bit k
//      takes the value at its row's first position plus the set bits
//      before k, clamped to the lane's last value, sign-extended.  A
//      group's values are consecutive in the lane: they are read as the
//      one or two aligned words that hold them (rows in ascending order,
//      as the host emits them, read the values in order, so neighbouring
//      groups share cache lines).

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kChunk = kThreads * kRowsPerThread;    // rows a scan block
constexpr int kWarpRows = 32 * kRowsPerThread;       // ... a warp of it
constexpr int kChunkShift = 11;                      // log2(kChunk)
constexpr int kTileRows = 512;                       // rows an expand block
constexpr int kMaxBmw = 4;                           // bitmap words a row
constexpr int kMaxChunks = 2048;                     // chunks a (class, lane)
constexpr int kMaxClasses = 5;                       // ops/wire.py's classes
static_assert(kChunk == 1 << kChunkShift, "kChunkShift");

// One class: its sections lie at src + idx (int32 [br]), src + bm (uint16
// [br, bmw]) and src + vals (int8 [bv]) for lane 0, s_* bytes further a
// lane; its output [grid, w] a lane at word out (a lane grid * w words
// further) of the output; its row map [grid], first positions [br] and
// chunk totals [chunks] a lane at words rowmap, first and sums of the
// scratch; its blocks a lane `chunks` in launch 1 (from block1) and
// `tiles` in launch 2 (from block2), of `rows` dense rows each.  Every
// field int64 (ops/kernels/unpack_bm8.py FIELDS).
struct Bm8Class {
  long long idx, bm, vals, s_idx, s_bm, s_vals, br, bmw, bv, grid, w, out,
      rowmap, first, sums, chunks, tiles, rows, block1, block2;
};

struct Bm8Args {
  unsigned long long src;    // base of every section address
  int32_t* out;
  int32_t* scratch;
  int nclass;
  // each class's first blocks, apart from its other fields: a block's
  // search reads these, which stay in the constant cache
  int block1[kMaxClasses];
  int block2[kMaxClasses];
  Bm8Class c[kMaxClasses];
};

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

// The 16-byte aligned superset of [src, src + nbytes) into dst (16-byte
// aligned), by the block's threads; returns where src's first byte lands
// in dst, so a value keeps its alignment.  The granules around a span lie
// in its allocation (CUDA's are 256-byte aligned, torch's rounded up to
// 512 bytes).
__device__ __forceinline__ int stage(uint8_t* dst, const uint8_t* src,
                                     int nbytes) {
  const uintptr_t lo = (uintptr_t)src & ~(uintptr_t)15;
  const int pieces =
      (int)((((uintptr_t)src + nbytes + 15) & ~(uintptr_t)15) - lo) / 16;
  for (int p = threadIdx.x; p < pieces; p += kThreads)
    copy_async16(dst + 16 * p, reinterpret_cast<const void*>(lo + 16 * p));
  return (int)((uintptr_t)src - lo);
}

// A row's bitmap words (bmw of them, little end first) as one word.
__device__ __forceinline__ uint64_t row_bits(const uint16_t* r, int bmw) {
  uint64_t bits = r[0];
#pragma unroll
  for (int i = 1; i < kMaxBmw; ++i)
    if (i < bmw) bits |= (uint64_t)r[i] << (16 * i);
  return bits;
}

__device__ __forceinline__ int class_of(const int* block0, int nclass,
                                        int x) {
  int k = 0;
  while (k + 1 < nclass && block0[k + 1] <= x) ++k;
  return k;
}

// __grid_constant__: the table is read where it lies in the launch's
// parameters (a dynamic index would otherwise copy it to each thread's
// local memory).
__global__ void __launch_bounds__(kThreads)
unpack_bm8_kernel_scan(const __grid_constant__ Bm8Args a) {
  __shared__ __align__(16) uint8_t s_bm[kChunk * kMaxBmw * 2 + 32];
  __shared__ __align__(16) uint8_t s_idx[kChunk * 4 + 32];
  __shared__ int s_warp[kThreads / 32];
  const int x = blockIdx.x, b = blockIdx.y;
  const int k = class_of(a.block1, a.nclass, x);
  const Bm8Class& c = a.c[k];
  const int chunk = x - a.block1[k];
  const int br = (int)c.br, bmw = (int)c.bmw, w = (int)c.w;
  const int grid = (int)c.grid;
  const int j0 = chunk * kChunk, rows = min(kChunk, br - j0);
  const uint16_t* bm = reinterpret_cast<const uint16_t*>(
      s_bm + stage(s_bm, reinterpret_cast<const uint8_t*>(
                             a.src + c.bm + b * c.s_bm) +
                             (long long)j0 * 2 * bmw,
                   rows * 2 * bmw));
  const int32_t* idx = reinterpret_cast<const int32_t*>(
      s_idx + stage(s_idx, reinterpret_cast<const uint8_t*>(
                               a.src + c.idx + b * c.s_idx) +
                               (long long)j0 * 4,
                    rows * 4));
  copy_wait_all();
  __syncthreads();

  // warp wp takes rows wp * kWarpRows.. of the chunk, lane l row
  // r * 32 + l of them in round r, so the warp's reads of the staged rows
  // and its stores of positions and row map entries are of 32
  // consecutive rows; the positions follow the rows' order (rounds, then
  // lanes, then warps)
  const uint64_t mask = w >= 64 ? ~0ull : (1ull << w) - 1;
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int i0 = wp * kWarpRows + lane;
  int pos[kRowsPerThread];
  int carry = 0;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = i0 + 32 * r;
    const int cnt =
        i < rows ? __popcll(row_bits(bm + i * bmw, bmw) & mask) : 0;
    int inc = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    pos[r] = carry + inc - cnt;
    carry += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (lane == 0) s_warp[wp] = carry;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    const int s = s_warp[i];
    before += i < wp ? s : 0;
    total += s;
  }
  int32_t* first = a.scratch + c.first + (long long)b * br + j0;
  int32_t* rowmap = a.scratch + c.rowmap + (long long)b * grid;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = i0 + 32 * r;
    if (i < rows) {
      first[i] = before + pos[r];
      const int g = idx[i];
      if (g >= 0 && g < grid) rowmap[g] = j0 + i;
    }
  }
  if (threadIdx.x == 0)
    a.scratch[c.sums + (long long)b * c.chunks + chunk] = total;
}

// The values of a group's set bits: `count` (<= 4) consecutive values
// from position p of the lane's values, byte k of the result the k-th;
// read as the one or two aligned words that hold them.  Positions past
// the lane's last value read that value (byte by byte, where the group
// reaches it).
__device__ __forceinline__ unsigned group_values(const int8_t* vals, int bv,
                                                 int p, int count) {
  if (p + count > bv) {
    unsigned x = 0;
    for (int i = 0; i < count; ++i)
      x |= (unsigned)(uint8_t)vals[min(p + i, bv - 1)] << (8 * i);
    return x;
  }
  const uintptr_t at = (uintptr_t)(vals + p);
  const unsigned* word = reinterpret_cast<const unsigned*>(at & ~(uintptr_t)3);
  const int head = (int)(at & 3);
  unsigned long long x = __ldg(word);
  if (head + count > 4) x |= (unsigned long long)__ldg(word + 1) << 32;
  return (unsigned)(x >> (8 * head));
}

__global__ void __launch_bounds__(kThreads)
unpack_bm8_kernel_expand(const __grid_constant__ Bm8Args a) {
  __shared__ int s_cex[kMaxChunks];            // within its group of 32
  __shared__ int s_gsum[kMaxChunks / 32];      // each group's total
  __shared__ uint64_t s_bits[kTileRows];
  __shared__ int s_pos[kTileRows];
  const int x = blockIdx.x, b = blockIdx.y;
  const int k = class_of(a.block2, a.nclass, x);
  const Bm8Class& c = a.c[k];
  const int br = (int)c.br, bmw = (int)c.bmw, bv = (int)c.bv;
  const int grid = (int)c.grid, w = (int)c.w, R = (int)c.rows;
  const int chunks = (int)c.chunks;
  const int g0 = (x - a.block2[k]) * R, nrows = min(R, grid - g0);
  const uint64_t mask = w >= 64 ? ~0ull : (1ull << w) - 1;
  const int32_t* idx =
      reinterpret_cast<const int32_t*>(a.src + c.idx + b * c.s_idx);
  const uint16_t* bm =
      reinterpret_cast<const uint16_t*>(a.src + c.bm + b * c.s_bm);
  const int32_t* rowmap = a.scratch + c.rowmap + (long long)b * grid + g0;
  const int32_t* first = a.scratch + c.first + (long long)b * br;
  const int32_t* sums = a.scratch + c.sums + (long long)b * chunks;

  // the lane's chunk totals, scanned a group of 32 (a warp) at a time
  for (int i = threadIdx.x; i < (chunks + 31) / 32 * 32; i += kThreads) {
    const int v = i < chunks ? sums[i] : 0;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if ((threadIdx.x & 31) >= o) inc += u;
    }
    if (i < chunks) s_cex[i] = inc - v;
    if ((threadIdx.x & 31) == 31) s_gsum[i >> 5] = inc;
  }
  // each row: its bitmap and its first position within its chunk (the
  // chunk in the top bits: < kMaxChunks, and the position < kChunk * 64)
  bool live = false;
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    const int j = rowmap[r];
    uint64_t bits = 0;
    int at = 0;
    if (j >= 0 && j < br && idx[j] == g0 + r) {
      bits = row_bits(bm + (long long)j * bmw, bmw) & mask;
      at = first[j] | (j >> kChunkShift) << 17;
    }
    s_bits[r] = bits;
    s_pos[r] = at;
    live |= bits != 0;
  }
  int4* out = reinterpret_cast<int4*>(a.out + c.out +
                                      ((long long)b * grid + g0) * w);
  const int quads = nrows * w / 4, qpr = w / 4;
  if (!__syncthreads_or(live)) {
    for (int q = threadIdx.x; q < quads; q += kThreads)
      out[q] = make_int4(0, 0, 0, 0);
    return;
  }
  // each live row's first position in the lane: the chunks before its
  // chunk (the groups before, then its group's) and its own
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    if (s_bits[r]) {
      const int at = s_pos[r], ch = at >> 17;
      int p = s_cex[ch] + (at & 0x1ffff);
      for (int g = 0; g < ch >> 5; ++g) p += s_gsum[g];
      s_pos[r] = p;
    }
  }
  __syncthreads();

  const int8_t* vals =
      reinterpret_cast<const int8_t*>(a.src + c.vals + b * c.s_vals);
  for (int q = threadIdx.x; q < quads; q += kThreads) {
    const int r = q / qpr, k0 = (q - r * qpr) * 4;
    const uint64_t bits = s_bits[r];
    int v[4] = {0, 0, 0, 0};
    const unsigned set = (unsigned)(bits >> k0) & 15;
    if (set) {
      const unsigned x = group_values(
          vals, bv, s_pos[r] + __popcll(bits & ((1ull << k0) - 1)),
          __popc(set));
      int n = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if ((set >> i) & 1) v[i] = (int)(int8_t)(x >> (8 * n++));
    }
    out[q] = make_int4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

// table: nclass rows of the 20 int64 fields of Bm8Class, in order of
// their first blocks; blocks1 and blocks2 the launches' blocks a lane.  A
// host array: the table travels as a kernel argument.  Each class's
// output region must be 16-byte aligned.
extern "C" int unpack_bm8_launch(
    const uint8_t* src, int32_t* out, int32_t* scratch,
    const long long* table, int nclass, int B, int blocks1, int blocks2,
    void* stream) {
  if (B <= 0 || nclass <= 0) return 0;
  if (nclass > kMaxClasses) return (int)cudaErrorInvalidValue;
  Bm8Args a;
  a.src = (unsigned long long)(uintptr_t)src;
  a.out = out;
  a.scratch = scratch;
  a.nclass = nclass;
  for (int k = 0; k < kMaxClasses; ++k) {
    const long long* f = table + 20 * (k < nclass ? k : nclass - 1);
    a.c[k] = Bm8Class{f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                      f[7], f[8], f[9], f[10], f[11], f[12], f[13],
                      f[14], f[15], f[16], f[17], f[18], f[19]};
    a.block1[k] = (int)f[18];
    a.block2[k] = (int)f[19];
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (blocks1 > 0)
    unpack_bm8_kernel_scan<<<dim3(blocks1, B), kThreads, 0, st>>>(a);
  if (blocks2 > 0)
    unpack_bm8_kernel_expand<<<dim3(blocks2, B), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
