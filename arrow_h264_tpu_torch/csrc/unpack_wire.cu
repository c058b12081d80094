// The wire's device unpack: every section of [B] lanes' wire buffers but
// the bm8 coefficient classes (kernel K8) expanded into the dense int32
// ABI that the decode's kernels read, in one launch, and a second launch
// that writes the rows of the sparse sections over their MBs.
//
// Replaces: no pallas_call.  The reference unpacks the wire in XLA
// (arrow_h264_tpu/ops/wire.py::unpack_wire_frame, :1072, jitted and
// vmapped over the lanes by unpack_fn, :1208).  The port's plain version
// (ops/wire.py::unpack_wire_plain) runs eagerly as ~110 torch launches a
// call: a cast, a shift, a stack or a scatter a key.
//
// What bounds it: bytes, and of them the output, written once: 288 words
// an MB (the MB fields, nz, the intra modes and availability, mv, refidx,
// refid and refslot), 9.4 MB a 1080p lane (~0.003 ms at 3.35 TB/s), plus
// 1.5 KB an MB of PCM samples where shipped, a dense coefficient class
// widened to int32 and 836 KB a lane of weight table where a lane ships
// one.  The wire itself is a small part: it is ~10x smaller than the
// output.
//
// What the design does about it: wide stores, reads from shared memory
// and no division.  The wrapper (ops/kernels/unpack_wire.py) lays the work out
// as a table of segments, one an output key (or a sparse section's rows
// of a key): the op that makes its words, its rows, the words a row, the
// wire section it reads, where its first block is, and a multiplier and
// shift that give a word's row without a division, and the words a
// block makes (fewer where wide rows would overflow the staging buffer:
// the 40-byte intra rows of a 4-word key).  A block finds its
// segment in the table (a kernel argument) by the segments' first
// blocks, kept apart in 128 bytes that stay in the constant cache.  It
// stages the wire bytes of its rows (contiguous in the lane, row_bytes
// apart) in shared memory: one pass of 16-byte cp.async over the aligned
// superset of the span, and the lane's slice table where the op reads
// it.  Then a thread makes kGroups groups of 4 consecutive output words
// (neighbouring threads on neighbouring groups) from shared memory and
// stores each as one int4; the groups are aligned to the output, so only
// a segment's or a lane's unaligned head and tail (regions are 16-byte
// aligned per key, lanes are not) go word by word.  Launch 1 (`scatter`
// 0) writes every word from the dense and base sections, zeros (or -1
// refs) where a key is sparse; launch 2 (`scatter` 1, only for a spec
// with sparse intra, inter or PCM rows) writes each sparse row over its
// MB, a group of 4 words a store (rows of a multiple of 4 words); an
// index outside the picture (the bucket padding, index == n) is dropped.
// The weight table's few shipped rows are looked up in launch 1: a thread
// searches the lane's wt_idx (at most 16 entries) for its row and reads
// the row where it lies in the wire (its rows are not contiguous).

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;                     // int4 groups a thread
constexpr int kBlockWords = kThreads * 4 * kGroups;   // words a block
constexpr int kMaxSegs = 32;
// a block's staged row bytes: kBlockWords rows of 6 bytes (the meta6
// rows, a word each) and the 16-byte alignment around them; the wrapper
// gives a block of a segment with wider rows fewer words
constexpr int kStageBytes = 6 * kBlockWords + 32;
constexpr int kTabBytes = 6 * 16 + 32;         // the slice table, aligned
constexpr int kNxMask = 64 - 1;                // ops/wire.py NX_FLAG - 1

// What a segment's words are (ops/kernels/unpack_wire.py OPS, in order).
enum Op {
  kKind = 0, kQp = 1, kSliceId = 2, kTr8 = 3, kMbAvail = 4, kI16Mode = 5,
  kChromaMode = 6, kDisableIdc = 7, kAlphaOff = 8, kBetaOff = 9, kNz = 10,
  kSlogwd = 11, kI4Modes = 12, kI4Avail = 13, kI8Modes = 14, kI8Avail = 15,
  kMvBase = 16, kMvRows = 17, kRefIdxBase = 18, kRefIdxRows = 19,
  kRefIdBase = 20, kRefIdRows = 21, kRefSlotBase = 22, kRefSlotRows = 23,
  kU8 = 24, kI16 = 25, kI32 = 26, kWtab = 27,
};

// One segment: `rows` rows of `wpm` words.  Its source row r lies at byte
// src + r * row_bytes of a lane's wire (src < 0: no source, the op's
// absent value).  A scatter segment's row r goes to the output row
// idx[r] (int32 at byte idx of the lane's wire) when that lies in
// [0, lane_words / wpm); any other segment's word i to word i of the
// lane.  kWtab reads idx (nidx entries) to find its row's source.  Its
// lane's words start at element out + b * lane_words of the output.  A
// word i < 2^31 lies in row (i * mul) >> shift.  A block makes
// block_words of its words (kBlockWords, or fewer where the rows those
// span would overflow the staging buffer: a multiple of 4).
struct Seg {
  long long op, rows, wpm, block0, src, row_bytes, idx, nidx, lane_words,
      out, mul, shift, block_words;
};

struct UnpackArgs {
  const uint8_t* buf;        // [B, total] wire, lane stride `stride` bytes
  int32_t* out;              // every output key, one allocation
  long long stride;
  long long slice8;          // byte offset of the slice table
  int nseg;
  // each segment's first block, apart from its other fields: a block's
  // search reads these 128 bytes, which stay in the constant cache (a
  // search over seg[].block0, 80 bytes apart, missed it at every step
  // and made a 1080p launch ~4x slower)
  int block0[kMaxSegs];
  Seg seg[kMaxSegs];
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
// in dst.  The granules around a span lie in its allocation (CUDA's are
// 256-byte aligned, torch's rounded up to 512 bytes).
__device__ __forceinline__ int stage(uint8_t* dst, const uint8_t* src,
                                     int nbytes) {
  const uintptr_t lo = (uintptr_t)src & ~(uintptr_t)15;
  const int chunks =
      (int)((((uintptr_t)src + nbytes + 15) & ~(uintptr_t)15) - lo) / 16;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    copy_async16(dst + 16 * c, reinterpret_cast<const void*>(lo + 16 * c));
  return (int)((uintptr_t)src - lo);
}

__device__ __forceinline__ int row_of(int i, unsigned long long mul,
                                      int shift) {
  return (int)(((unsigned long long)(unsigned)i * mul) >> shift);
}

__device__ __forceinline__ int i8(const uint8_t* p) {
  return (int)(int8_t)*p;
}

// Rows keep their alignment in shared memory (a span lands at its
// offset in a 16-byte granule), so 2- and 4-byte values are read whole.
__device__ __forceinline__ int i16(const uint8_t* p, int j) {
  return (int)reinterpret_cast<const int16_t*>(p)[j];
}

// Word j of a row; `row` is its source (nullptr: the op's absent value),
// `tab` the lane's slice table.
__device__ __forceinline__ int word(int op, const uint8_t* row,
                                   const uint8_t* tab, int j) {
  switch (op) {
    case kKind: return row[0];
    case kQp: return row[1];
    case kSliceId: return row[2] & 15;
    case kTr8: return row[3] & 1;
    case kMbAvail: return (row[3] >> (1 + j)) & 1;
    case kI16Mode: return (row[3] >> 4) & 3;
    case kChromaMode: return (row[3] >> 6) & 3;
    case kDisableIdc:
      // bit 4 of the slice byte: the per-MB deblock-disable override
      return (row[2] >> 4) & 1 ? 1 : i8(tab + (row[2] & 15) * 6);
    case kAlphaOff: return i8(tab + (row[2] & 15) * 6 + 1);
    case kBetaOff: return i8(tab + (row[2] & 15) * 6 + 2);
    case kNz: return (row[4 + j / 8] >> (j % 8)) & 1;
    case kSlogwd: return i8(row + (j / 2) * 6 + 3 + j % 2);
    case kI4Modes: return row ? row[j] : 0;
    case kI4Avail: return row ? (row[16 + j / 4] >> (j % 4)) & 1 : 0;
    case kI8Modes: return row ? row[32 + j] : 0;
    case kI8Avail: return row ? (row[36 + j / 4] >> (j % 4)) & 1 : 0;
    case kMvBase: return i16(row, j % 4);
    case kMvRows: return row ? i16(row, j) : 0;
    case kRefIdxBase: return i8(row + j % 2);
    case kRefIdxRows: return row ? i8(row + j) : -1;
    case kRefIdBase: return i8(row + 2 + j % 2);
    case kRefIdRows: return row ? i8(row + 32 + j) : -1;
    case kRefSlotBase:
    case kRefSlotRows: {
      // refid's slot without NX_FLAG (a non-existing picture's mark)
      const int r = op == kRefSlotBase ? i8(row + 2 + j % 2)
                                       : row ? i8(row + 32 + j) : -1;
      return r >= 0 ? r & kNxMask : r;
    }
    case kU8: return row ? row[j] : 0;
    case kI16: return i16(row, j);
    case kI32: return reinterpret_cast<const int32_t*>(row)[j];
  }
  return 0;
}

// __grid_constant__: the table is read where it lies in the launch's
// parameters (a dynamic index would otherwise copy it to each thread's
// local memory).
__global__ void __launch_bounds__(kThreads)
unpack_wire_kernel(const __grid_constant__ UnpackArgs a, int scatter) {
  __shared__ __align__(16) uint8_t s_rows[kStageBytes];
  __shared__ __align__(16) uint8_t s_tab[kTabBytes];
  const int x = blockIdx.x, b = blockIdx.y;
  int s = 0;
  while (s + 1 < a.nseg && a.block0[s + 1] <= x) ++s;
  const Seg& g = a.seg[s];
  // a lane's words of one segment number fewer than 2^31 (the wrapper
  // checks), so the rows and words are int arithmetic
  const int op = (int)g.op, wpm = (int)g.wpm, words = (int)(g.rows * wpm);
  const int row_bytes = (int)g.row_bytes, shift = (int)g.shift;
  const int block_words = (int)g.block_words;
  const unsigned long long mul = (unsigned long long)g.mul;
  const uint8_t* lane = a.buf + b * a.stride;
  int32_t* out = a.out + g.out + b * g.lane_words;
  // the block's positions first + 4 k are 16-byte aligned in the output
  // (launch 2's rows are: its segments start a region and hold rows of a
  // multiple of 4 words); its words are [lo, hi)
  const int first = (x - a.block0[s]) * block_words -
                    (scatter ? 0 : (int)((g.out + b * g.lane_words) & 3));
  const int lo = max(first, 0), hi = min(first + block_words, words);
  if (lo >= hi) return;
  const int r_lo = row_of(lo, mul, shift);
  const uint8_t* rows = nullptr;       // row r_lo's bytes, staged
  if (g.src >= 0 && op != kWtab) {
    const int span = (row_of(hi - 1, mul, shift) - r_lo + 1) * row_bytes;
    rows = s_rows + stage(s_rows, lane + g.src + (long long)r_lo * row_bytes,
                          span);
  }
  const uint8_t* tab = nullptr;
  if (op == kDisableIdc || op == kAlphaOff || op == kBetaOff)
    tab = s_tab + stage(s_tab, lane + a.slice8, 6 * 16);
  copy_wait_all();
  __syncthreads();

  const int32_t* idx = reinterpret_cast<const int32_t*>(lane + g.idx);
  const int nidx = (int)g.nidx;
  for (int k = 0; k < kGroups; ++k) {
    const int at = 4 * (k * kThreads + threadIdx.x);
    const int i0 = first + at;
    if (at >= block_words || i0 + 3 < lo || i0 >= hi) continue;
    const int i1 = max(i0, lo);
    int r = row_of(i1, mul, shift), j = i1 - r * wpm;
    const int r0 = r;
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i0 + u < lo || i0 + u >= hi) continue;
      if (op == kWtab) {
        // the identity (weights 1, offsets 0) unless the lane ships row r
        int t = 0;
        while (t < nidx && idx[t] != r) ++t;
        v[u] = t < nidx ? i16(lane + g.src + (long long)t * row_bytes, j)
                        : (j & 1) == 0;
      } else {
        v[u] = word(op, rows ? rows + (r - r_lo) * row_bytes : nullptr, tab,
                    j);
      }
      if (++j == wpm) {
        j = 0;
        ++r;
      }
    }
    if (scatter) {
      // the group is one row's words j0..j0 + 3; an index outside the
      // picture (the bucket padding) is dropped
      const int m = idx[r0], j0 = i0 - r0 * wpm;
      if (m >= 0 && m < row_of((int)g.lane_words, mul, shift))
        reinterpret_cast<int4*>(out + (long long)m * wpm + j0)[0] =
            make_int4(v[0], v[1], v[2], v[3]);
    } else if (i0 >= lo && i0 + 3 < hi) {
      reinterpret_cast<int4*>(out + i0)[0] =
          make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u >= lo && i0 + u < hi) out[i0 + u] = v[u];
    }
  }
}

}  // namespace

// segs: nseg rows of the 13 int64 fields of Seg, launch 1's segments
// then launch 2's (n1 and nseg - n1 of them), each group ordered by
// block0; blocks1 and blocks2 the launches' blocks a lane.  A host array:
// the table travels as a kernel argument.  The output allocation must be
// 16-byte aligned.
extern "C" int unpack_wire_launch(
    const uint8_t* buf, int32_t* out, const long long* segs, int nseg,
    int n1, int blocks1, int blocks2, int B, int stride, int slice8,
    void* stream) {
  if (B <= 0) return 0;
  if (nseg > 2 * kMaxSegs || n1 > kMaxSegs || nseg - n1 > kMaxSegs)
    return (int)cudaErrorInvalidValue;
  UnpackArgs a;
  a.buf = buf;
  a.out = out;
  a.stride = stride;
  a.slice8 = slice8;
  const cudaStream_t st = (cudaStream_t)stream;
  for (int pass = 0; pass < 2; ++pass) {
    const int first = pass ? n1 : 0, count = pass ? nseg - n1 : n1;
    const int blocks = pass ? blocks2 : blocks1;
    if (count == 0 || blocks == 0) continue;
    a.nseg = count;
    for (int k = 0; k < count; ++k) {
      const long long* f = segs + 13 * (first + k);
      a.seg[k] = Seg{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8],
                     f[9], f[10], f[11], f[12]};
      a.block0[k] = (int)f[3];
    }
    unpack_wire_kernel<<<dim3(blocks, B), kThreads, 0, st>>>(a, pass);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
