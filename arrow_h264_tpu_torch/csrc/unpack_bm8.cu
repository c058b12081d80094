// The wire's bm8 coefficient expansion: one coefficient class of [B]
// lanes, shipped as row indices, 16-bit significance bitmaps and packed
// int8 values, scattered back into its dense [B, grid, w] int32 form.
//
// Replaces: no pallas_call.  The reference expands bm8 sections in XLA
// (arrow_h264_tpu/ops/wire.py::_scatter_bm8, :1057, inside
// unpack_wire_frame, jitted and vmapped over the lanes by unpack_fn,
// :1208).  The port's plain version (ops/wire.py::_scatter_bm8) runs
// eagerly as ~15 torch launches a class, among them a cumsum in int64
// over every significance bit of every lane (8.4 M a lane for the l4
// class of a 4K picture, the 4K batch's largest device cost); this is
// that stage as three launches of one wrapper call.
//
// What bounds it: bytes, and of them the dense output, written once
// (zero rows included): n * cells * w * 4 bytes, 8.4 MB for l4 at 1080p
// (~0.0025 ms at 3.35 TB/s).  The bitmaps, values and indices are read
// once and are a small part.
//
// What the design does about it: the running count of set bits is a scan
// over all rows of a lane, so one block a lane would serialise a single
// stream.  It is a chunked scan instead, with nothing wider than int32:
//   1. `sums`: each block takes kChunk rows of a lane and writes their
//      set bits' total (the first w bits of each row count); the blocks
//      also fill the lane's row map (dense row -> bm8 row) with -1;
//   2. `offsets`: each block adds up the totals of the chunks before its
//      own, scans its rows' counts and writes each row's first value
//      position, and enters its rows in the row map (an index equal to
//      grid is the bucket padding and is dropped);
//   3. `expand`: one thread a run of 4 output words, so every output
//      word is written once, with a 16-byte store: a dense row that no
//      bm8 row maps to is zeros, else each set bit k takes the value at
//      its row's first position plus the set bits before k, clamped to
//      the lane's last value, sign-extended.
// The row map makes the output a single write; it costs 4 bytes a dense
// row (1/w of the output) twice.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kChunk = kThreads * kRowsPerThread;   // rows a block scans

struct Bm8Args {
  const int32_t* idx;        // [B, br], lane stride s_idx elements
  const uint16_t* bm;        // [B, br, bmw], lane stride s_bm elements
  const int8_t* vals;        // [B, bv], lane stride s_vals elements
  int32_t* out;              // [B, grid, w]
  int32_t* rowmap;           // [B, grid]: bm8 row of each dense row, or -1
  int32_t* first;            // [B, br]: first value position of each row
  int32_t* sums;             // [B, chunks]: set bits of each chunk
  long s_idx, s_bm, s_vals;
  int br, bmw, bv, grid, w, chunks;
};

// The first w bits of bm8 row j of lane b.
__device__ __forceinline__ uint64_t row_bits(const Bm8Args& a, int b, int j) {
  const uint16_t* r = a.bm + b * a.s_bm + (long)j * a.bmw;
  uint64_t bits = 0;
  for (int i = 0; i < a.bmw; ++i) bits |= (uint64_t)r[i] << (16 * i);
  return a.w >= 64 ? bits : bits & ((1ull << a.w) - 1);
}

// Sum of v over the block; every thread gets it.
__device__ int block_sum(int v, int* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                     // s_warp free from any earlier use
  if (lane == 0) s_warp[w] = v;
  __syncthreads();
  int t = 0;
  for (int i = 0; i < kThreads / 32; ++i) t += s_warp[i];
  return t;
}

// Exclusive prefix of v over the block's threads in order.
__device__ int block_exclusive(int v, int* s_warp) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  __syncthreads();
  if (lane == 31) s_warp[w] = inc;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < w; ++i) before += s_warp[i];
  return before + inc - v;
}

__global__ void __launch_bounds__(kThreads)
unpack_bm8_kernel_sums(Bm8Args a) {
  __shared__ int s_warp[kThreads / 32];
  const int b = blockIdx.y, c = blockIdx.x;
  int32_t* rowmap = a.rowmap + (long)b * a.grid;
  for (long g = (long)c * kThreads + threadIdx.x; g < a.grid;
       g += (long)gridDim.x * kThreads)
    rowmap[g] = -1;
  if (c >= a.chunks) return;           // a block of the fill only
  const int j0 = c * kChunk + threadIdx.x * kRowsPerThread;
  int v = 0;
  for (int r = 0; r < kRowsPerThread; ++r)
    if (j0 + r < a.br) v += __popcll(row_bits(a, b, j0 + r));
  v = block_sum(v, s_warp);
  if (threadIdx.x == 0) a.sums[(long)b * a.chunks + c] = v;
}

__global__ void __launch_bounds__(kThreads)
unpack_bm8_kernel_offsets(Bm8Args a) {
  __shared__ int s_warp[kThreads / 32];
  const int b = blockIdx.y, c = blockIdx.x;
  // the set bits of the lane's chunks before this one
  int before = 0;
  for (int i = threadIdx.x; i < c; i += kThreads)
    before += a.sums[(long)b * a.chunks + i];
  before = block_sum(before, s_warp);
  const int j0 = c * kChunk + threadIdx.x * kRowsPerThread;
  int cnt[kRowsPerThread];
  int v = 0;
  for (int r = 0; r < kRowsPerThread; ++r) {
    cnt[r] = j0 + r < a.br ? __popcll(row_bits(a, b, j0 + r)) : 0;
    v += cnt[r];
  }
  int pos = before + block_exclusive(v, s_warp);
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int j = j0 + r;
    if (j >= a.br) break;
    a.first[(long)b * a.br + j] = pos;
    pos += cnt[r];
    const int g = a.idx[b * a.s_idx + j];
    if (g >= 0 && g < a.grid) a.rowmap[(long)b * a.grid + g] = j;
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_bm8_kernel_expand(Bm8Args a) {
  const int b = blockIdx.y;
  const long quads = (long)a.grid * (a.w / 4);
  const long q = (long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= quads) return;
  const int g = q / (a.w / 4), k0 = (q % (a.w / 4)) * 4;
  const int j = a.rowmap[(long)b * a.grid + g];
  int4 o = make_int4(0, 0, 0, 0);
  if (j >= 0) {
    const uint64_t bits = row_bits(a, b, j);
    const int8_t* vals = a.vals + b * a.s_vals;
    int pos = a.first[(long)b * a.br + j] +
              __popcll(bits & ((1ull << k0) - 1));
    int v[4];
    for (int i = 0; i < 4; ++i) {
      v[i] = 0;
      if ((bits >> (k0 + i)) & 1) {
        v[i] = vals[pos < a.bv - 1 ? pos : a.bv - 1];
        ++pos;
      }
    }
    o = make_int4(v[0], v[1], v[2], v[3]);
  }
  reinterpret_cast<int4*>(a.out + (long)b * a.grid * a.w)[q] = o;
}

}  // namespace

extern "C" int unpack_bm8_launch(
    const int32_t* idx, const uint16_t* bm, const int8_t* vals, int32_t* out,
    int32_t* scratch, int s_idx, int s_bm, int s_vals, int B, int br,
    int bmw, int bv, int grid, int w, void* stream) {
  if (B <= 0 || grid <= 0) return 0;
  const int chunks = (br + kChunk - 1) / kChunk;
  Bm8Args a{idx, bm, vals, out, scratch, scratch + (long)B * grid,
            scratch + (long)B * grid + (long)B * br, s_idx, s_bm, s_vals,
            br, bmw, bv, grid, w, chunks};
  const cudaStream_t s = (cudaStream_t)stream;
  // enough blocks for the row map's fill to take ~16 words a thread
  const long fill = ((long)grid + 16 * kThreads - 1) / (16 * kThreads);
  const long blocks1 = chunks > fill ? chunks : fill;
  unpack_bm8_kernel_sums<<<dim3((unsigned)blocks1, B), kThreads, 0, s>>>(a);
  if (chunks > 0)
    unpack_bm8_kernel_offsets<<<dim3(chunks, B), kThreads, 0, s>>>(a);
  const long quads = (long)grid * (w / 4);
  unpack_bm8_kernel_expand<<<dim3((unsigned)((quads + kThreads - 1) /
                                             kThreads), B),
                             kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
