// Inter combine (spec 8.4.2.3): the weighted or bi-predictive combine of
// the two lists' predictions, plus the residual, clipped, for the inter
// MBs of [B] pictures in one launch.
//
// Replaces: no pallas_call.  The reference combines the lists in XLA,
// inside the one jitted executable of decode_frames_batch_fn
// (arrow_h264_tpu/ops/pallas/mc_kernel.py::_mc_combine, :565, with
// arrow_h264_tpu/models/pipeline.py::resolve_weights, :81, and the add
// and clip of _post_mc, :184-189).  The port's plain version
// (ops/inter.py::inter_init_plain) runs eagerly as ~150 small torch
// operations over per-sample int32 planes; this kernel is that stage as
// one launch.
//
// What bounds it: bytes.  At 1080p it reads K3's and K4's uint8
// predictions of the lists each inter cell uses (3.1 MB a list), the
// int32 residual planes of the inter MBs (up to 12.4 MB), the motion and
// weight fields of each inter 4x4 cell, and writes the int32 init planes
// (12.4 MB): up to ~31 MB, ~0.009 ms at 3.35 TB/s.
//
// What the design does about it: one thread a 4x4 luma cell (and the 2x2
// chroma cells under it), consecutive threads along the picture's rows, and
// each row of a cell one access of each kind: a 4-byte load of each list's
// prediction the cell combines (one list for a unidirectional cell), a
// 16-byte residual load and a 16-byte store (chroma: 2-byte prediction
// loads, 8-byte residual loads and stores), so that a warp's row of 32 cells
// reads and writes 512 contiguous bytes of residual and of output in one
// instruction each.  The four threads of an MB's cells in a row take kind,
// slice_id and the MB's logwd (slogwd at slice_id, or the dense logwd) from
// the first of them by shuffles, so they are read once an MB row, while each
// thread reads its cell's refslot and refidx pairs (8-byte loads).  An inter
// cell then issues every other load before its first store: its residual
// rows, its weights, three 16-byte loads, and the predictions of the lists
// it reads.  The weights are the per-slice table's entry (wtab [B, 16, 33,
// 33, 3, 4] at slice_id and both lists' refidx, clamped to [-1, 31] and
// offset by one, 48 bytes), or, with the dense upload, the cell's wp [B, n,
// 4, 4, 2, 3, 2] (48 bytes).  wtab may be one table for every lane (lane
// stride 0).  Intra MBs write their zeros with the same stores.  The wrapper
// checks the alignments these accesses need (ops/kernels/inter_combine.py).
//
// The plain version's rules that this reproduces word for word:
// - a list is used where its refslot >= 0; both used: the weighted
//   bi-prediction; list 0 unused: list 1's unidirectional weighting
//   (whether list 1 is used or not); else list 0's;
// - unidirectional weighting with logwd 0 is p * w + o, with logwd >= 1
//   ((p * w + 2^(logwd-1)) >> logwd) + o; bi-prediction is
//   ((p0 * w0 + p1 * w1 + 2^logwd) >> (logwd + 1)) + ((o0 + o1 + 1) >> 1);
//   each clipped to 0..255 before the residual is added and the sum
//   clipped again;
// - MBs that are not inter (kind < 4) come out 0.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kKindP = 4;
constexpr int kSlices = 16, kRefs = 33;

struct CombineArgs {
  const uint8_t* pred_y;               // [B, 2, H, W]
  const uint8_t* pred_c;               // [B, 2 (list), 2 (plane), H/2, W/2]
  const int32_t* res_y;                // [B, H, W]
  const int32_t* res_cb;               // [B, H/2, W/2]
  const int32_t* res_cr;
  const int32_t* kind;                 // [B, n]
  const int32_t* refslot;              // [B, n, 4, 4, 2]
  const int32_t* wtab;                 // [B, 16, 33, 33, 3, 4] (tables)
  const int32_t* slogwd;               // [B, 16, 2]
  const int32_t* slice_id;             // [B, n]
  const int32_t* refidx;               // [B, n, 4, 4, 2]
  const int32_t* wp;                   // [B, n, 4, 4, 2, 3, 2] (dense)
  const int32_t* logwd;                // [B, n, 2]
  int32_t* init_y;                     // [B, H, W]
  int32_t* init_cb;                    // [B, H/2, W/2]
  int32_t* init_cr;
  int wtab_stride;                     // elements between lanes' tables
  int B, mb_w, mb_h, dense;
};

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// a plane's (w, o) of both lists
struct Weights {
  int w0, o0, w1, o1;
};

// ops/inter.py::mc_combine for one sample
__device__ __forceinline__ int combine(int p0, int p1, const Weights& w,
                                       int lw, bool both, bool only1) {
  if (both)
    return clip255(((p0 * w.w0 + p1 * w.w1 + (1 << lw)) >> (lw + 1)) +
                   ((w.o0 + w.o1 + 1) >> 1));
  const int p = only1 ? p1 : p0, ww = only1 ? w.w1 : w.w0;
  const int o = only1 ? w.o1 : w.o0;
  return clip255(lw >= 1 ? ((p * ww + (1 << (lw - 1))) >> lw) + o
                         : p * ww + o);
}

// byte k of a row's packed predictions
__device__ __forceinline__ int byte_of(unsigned v, int k) {
  return (v >> (8 * k)) & 255;
}

// a luma row: the combined samples plus the residual, clipped, as one
// 16-byte store
__device__ __forceinline__ void store_row(int32_t* out, const int* v,
                                          int4 res) {
  *reinterpret_cast<int4*>(out) =
      make_int4(clip255(v[0] + res.x), clip255(v[1] + res.y),
                clip255(v[2] + res.z), clip255(v[3] + res.w));
}

__global__ void __launch_bounds__(kThreads)
inter_combine_kernel(CombineArgs a) {
  const int cw = 4 * a.mb_w, ch = 4 * a.mb_h;
  const long total = (long)a.B * ch * cw;
  const long t = (long)blockIdx.x * kThreads + threadIdx.x;
  // a thread past the end stands in for cell 0 until the shuffles are done
  const bool live = t < total;
  const long tc = live ? t : 0;
  const int cx = tc % cw, cy = (tc / cw) % ch;
  const int b = tc / ((long)cw * ch);
  const int n = a.mb_w * a.mb_h;
  const long mb = (long)b * n + (cy >> 2) * a.mb_w + (cx >> 2);
  const long cell = mb * 16 + (cy & 3) * 4 + (cx & 3);

  // the MB's fields, read by the first of its four threads (cw is a
  // multiple of 4, so the four are lanes 4k..4k+3 of one warp), while
  // each thread reads its cell's pair of lists (and of refidx)
  const int lane = threadIdx.x & 31, lead = lane & ~3;
  int kind = 0, sid = 0;
  int2 lw = make_int2(0, 0);
  if (lane == lead) {
    kind = __ldg(a.kind + mb);
    if (a.dense) {
      lw = __ldg(reinterpret_cast<const int2*>(a.logwd + mb * 2));
    } else {
      sid = __ldg(a.slice_id + mb);
      lw = __ldg(reinterpret_cast<const int2*>(
          a.slogwd + ((long)b * kSlices + sid) * 2));
    }
  }
  const int2 slot = __ldg(reinterpret_cast<const int2*>(a.refslot +
                                                        cell * 2));
  const int2 ri = a.dense ? make_int2(0, 0)
                          : __ldg(reinterpret_cast<const int2*>(
                                a.refidx + cell * 2));
  kind = __shfl_sync(0xffffffffu, kind, lead);
  sid = __shfl_sync(0xffffffffu, sid, lead);
  lw.x = __shfl_sync(0xffffffffu, lw.x, lead);
  lw.y = __shfl_sync(0xffffffffu, lw.y, lead);
  if (!live) return;

  const int H = 16 * a.mb_h, W = 16 * a.mb_w, Hc = H / 2, Wc = W / 2;
  const long ry = ((long)b * H + cy * 4) * W + cx * 4;
  const long rc = ((long)b * Hc + cy * 2) * Wc + cx * 2;
  if (kind < kKindP) {                 // intra: 0
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<int4*>(a.init_y + ry + r * W) = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<int2*>(a.init_cb + rc + r * Wc) = make_int2(0, 0);
      *reinterpret_cast<int2*>(a.init_cr + rc + r * Wc) = make_int2(0, 0);
    }
    return;
  }
  // every other load of the cell before its stores, so that they are in
  // flight together: the residual rows, its weights and the predictions
  // of the lists it reads
  int4 res_y[4];
  int2 res_c[2][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    res_y[r] = __ldg(reinterpret_cast<const int4*>(a.res_y + ry + r * W));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    res_c[0][r] = __ldg(reinterpret_cast<const int2*>(a.res_cb + rc +
                                                       r * Wc));
    res_c[1][r] = __ldg(reinterpret_cast<const int2*>(a.res_cr + rc +
                                                       r * Wc));
  }
  const bool u0 = slot.x >= 0, u1 = slot.y >= 0;
  const bool both = u0 && u1, only1 = !u0;
  const bool read0 = !only1, read1 = u1 || only1;   // the lists it reads
  const int4* wt;
  if (a.dense) {
    wt = reinterpret_cast<const int4*>(a.wp + cell * 12);
  } else {
    const int r0 = min(max(ri.x, -1), 31) + 1;
    const int r1 = min(max(ri.y, -1), 31) + 1;
    wt = reinterpret_cast<const int4*>(
        a.wtab + (long)b * a.wtab_stride +
        (((long)sid * kRefs + r0) * kRefs + r1) * 12);
  }
  const int4 q0 = __ldg(wt), q1 = __ldg(wt + 1), q2 = __ldg(wt + 2);
  const long plane_y = (long)H * W, plane_c = (long)Hc * Wc;
  const uint8_t* py =
      a.pred_y + (long)b * 2 * plane_y + (long)(cy * 4) * W + cx * 4;
  const uint8_t* pc =
      a.pred_c + (long)b * 4 * plane_c + (long)(cy * 2) * Wc + cx * 2;
  unsigned p_y[2][4], p_c[2][2][2];     // [list][(plane,) row]
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const bool read = l ? read1 : read0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p_y[l][r] = read ? __ldg(reinterpret_cast<const unsigned*>(
                             py + l * plane_y + r * W))
                       : 0u;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        p_c[l][pl][r] = read ? __ldg(reinterpret_cast<const unsigned short*>(
                                   pc + (2 * l + pl) * plane_c + r * Wc))
                             : 0u;
  }
  Weights w[3];
  if (a.dense) {                       // [list][plane][w, o]
    w[0] = {q0.x, q0.y, q1.z, q1.w};
    w[1] = {q0.z, q0.w, q2.x, q2.y};
    w[2] = {q1.x, q1.y, q2.z, q2.w};
  } else {                             // [plane][w0, o0, w1, o1]
    w[0] = {q0.x, q0.y, q0.z, q0.w};
    w[1] = {q1.x, q1.y, q1.z, q1.w};
    w[2] = {q2.x, q2.y, q2.z, q2.w};
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int v[4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      v[x] = combine(byte_of(p_y[0][r], x), byte_of(p_y[1][r], x), w[0],
                     lw.x, both, only1);
    store_row(a.init_y + ry + r * W, v, res_y[r]);
  }
#pragma unroll
  for (int pl = 0; pl < 2; ++pl) {
    int32_t* out = pl ? a.init_cr : a.init_cb;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int2 rv = res_c[pl][r];
      *reinterpret_cast<int2*>(out + rc + r * Wc) = make_int2(
          clip255(combine(byte_of(p_c[0][pl][r], 0), byte_of(p_c[1][pl][r], 0),
                          w[1 + pl], lw.y, both, only1) + rv.x),
          clip255(combine(byte_of(p_c[0][pl][r], 1), byte_of(p_c[1][pl][r], 1),
                          w[1 + pl], lw.y, both, only1) + rv.y));
    }
  }
}

}  // namespace

extern "C" int inter_combine_launch(
    const uint8_t* pred_y, const uint8_t* pred_c, const int32_t* res_y,
    const int32_t* res_cb, const int32_t* res_cr, const int32_t* kind,
    const int32_t* refslot, const int32_t* wtab, const int32_t* slogwd,
    const int32_t* slice_id, const int32_t* refidx, const int32_t* wp,
    const int32_t* logwd, int32_t* init_y, int32_t* init_cb,
    int32_t* init_cr, int wtab_stride, int B, int mb_w, int mb_h,
    int dense, void* stream) {
  CombineArgs a{pred_y, pred_c, res_y, res_cb, res_cr, kind, refslot,
                wtab, slogwd, slice_id, refidx, wp, logwd, init_y, init_cb,
                init_cr, wtab_stride, B, mb_w, mb_h, dense};
  const long threads = 16L * B * mb_w * mb_h;
  if (threads == 0) return 0;
  const long grid = (threads + kThreads - 1) / kThreads;
  inter_combine_kernel<<<(unsigned)grid, kThreads, 0,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
