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
// What the design does about it: each thread writes kWordsPerThread
// output words kThreads apart, and the words of a warp are consecutive,
// so every store is coalesced.  The wrapper (ops/kernels/unpack_wire.py)
// lays the work out as a table of segments, one an output key (or a
// sparse section's rows of a key): the op that makes its words, its
// rows, the words a row, the wire section it reads and where its first
// block is.  A block finds its segment in the table (a kernel argument)
// by the segments' first blocks, kept apart in 128 bytes that stay in
// the constant cache, and a thread its row and word; the op reads the
// row's bytes where they lie in the wire (lanes a row stride apart), so
// nothing is copied first.  Launch 1 (`scatter` 0) writes every word from
// the dense and base sections, zeros (or -1 refs) where a key is sparse;
// launch 2 (`scatter` 1, only for a spec with sparse intra, inter or PCM
// rows) writes each sparse row over its MB; an index outside the picture
// (the bucket padding, index == n) is dropped.  The weight table's few
// shipped rows are looked up in launch 1: a thread searches the lane's
// wt_idx (at most 16 entries) for its row.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;
constexpr int kBlockWords = kThreads * kWordsPerThread;   // words a block
constexpr int kMaxSegs = 32;
constexpr int kNxMask = 64 - 1;                  // ops/wire.py NX_FLAG - 1

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
// lane's words start at element out + b * lane_words of the output.
struct Seg {
  long long op, rows, wpm, block0, src, row_bytes, idx, nidx, lane_words,
      out;
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

__device__ __forceinline__ int i8(const uint8_t* p) {
  return (int)(int8_t)*p;
}

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
  const int x = blockIdx.x, b = blockIdx.y;
  int s = 0;
  while (s + 1 < a.nseg && a.block0[s + 1] <= x) ++s;
  const Seg& g = a.seg[s];
  // a lane's words of one segment number fewer than 2^31 (the wrapper
  // checks), so the rows and words are int arithmetic
  const int op = (int)g.op, wpm = (int)g.wpm, words = (int)g.rows * wpm;
  const int nidx = (int)g.nidx, out_rows = (int)(g.lane_words / wpm);
  const long long src = g.src, row_bytes = g.row_bytes;
  const uint8_t* lane = a.buf + b * a.stride;
  const uint8_t* tab = lane + a.slice8;
  const int32_t* idx = reinterpret_cast<const int32_t*>(lane + g.idx);
  int32_t* out = a.out + g.out + b * g.lane_words;
  const int first = (x - a.block0[s]) * kBlockWords + threadIdx.x;
  for (int i = first; i < first + kBlockWords && i < words; i += kThreads) {
    const int r = i / wpm, j = i % wpm;
    if (op == kWtab) {
      // the identity (weights 1, offsets 0) unless the lane ships row r
      int k = 0;
      while (k < nidx && idx[k] != r) ++k;
      out[i] = k < nidx ? i16(lane + src + k * row_bytes, j) : (j & 1) == 0;
      continue;
    }
    const uint8_t* row = src >= 0 ? lane + src + r * row_bytes : nullptr;
    if (!scatter) {
      out[i] = word(op, row, tab, j);
      continue;
    }
    const int m = idx[r];
    if (m >= 0 && m < out_rows)                     // else bucket padding
      out[(long long)m * wpm + j] = word(op, row, tab, j);
  }
}

}  // namespace

// segs: nseg rows of the 10 int64 fields of Seg, launch 1's segments
// then launch 2's (n1 and nseg - n1 of them), each group ordered by
// block0; blocks1 and blocks2 the launches' blocks a lane.  A host array:
// the table travels as a kernel argument.
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
      const long long* f = segs + 10 * (first + k);
      a.seg[k] = Seg{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8],
                     f[9]};
      a.block0[k] = (int)f[3];
    }
    unpack_wire_kernel<<<dim3(blocks, B), kThreads, 0, st>>>(a, pass);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
