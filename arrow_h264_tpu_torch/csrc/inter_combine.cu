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
// chroma cell under it), consecutive threads along the picture's rows, so
// a warp reads and writes 32 adjacent cells of a row of samples.  A cell
// reads the predictions of the lists it combines only: one list for a
// unidirectional cell.  Each
// thread looks its weights up once: from the per-slice table (wtab
// [B, 16, 33, 33, 3, 4] at slice_id and both lists' refidx, clamped to
// [-1, 31] and offset by one; slogwd [B, 16, 2] at slice_id), or, with
// the dense upload, from wp [B, n, 4, 4, 2, 3, 2] and logwd [B, n, 2].
// wtab may be one table for every lane (lane stride 0).
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

__global__ void __launch_bounds__(kThreads)
inter_combine_kernel(CombineArgs a) {
  const int cw = 4 * a.mb_w, ch = 4 * a.mb_h;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)a.B * ch * cw) return;
  const int cx = t % cw, cy = (t / cw) % ch;
  const int b = t / ((long)cw * ch);
  const int n = a.mb_w * a.mb_h;
  const long mb = (long)b * n + (cy >> 2) * a.mb_w + (cx >> 2);
  const long cell = mb * 16 + (cy & 3) * 4 + (cx & 3);
  const int H = 16 * a.mb_h, W = 16 * a.mb_w, Hc = H / 2, Wc = W / 2;
  const long ry = ((long)b * H + cy * 4) * W + cx * 4;
  const long rc = ((long)b * Hc + cy * 2) * Wc + cx * 2;

  if (a.kind[mb] < kKindP) {           // intra: 0
    for (int r = 0; r < 4; ++r)
      for (int x = 0; x < 4; ++x) a.init_y[ry + r * W + x] = 0;
    for (int r = 0; r < 2; ++r)
      for (int x = 0; x < 2; ++x) {
        a.init_cb[rc + r * Wc + x] = 0;
        a.init_cr[rc + r * Wc + x] = 0;
      }
    return;
  }
  const bool u0 = a.refslot[cell * 2] >= 0, u1 = a.refslot[cell * 2 + 1] >= 0;
  const bool both = u0 && u1, only1 = !u0;
  Weights w[3];
  int lw[2];
  if (a.dense) {
    const int32_t* p = a.wp + cell * 12;     // [list][plane][w, o]
    for (int pl = 0; pl < 3; ++pl)
      w[pl] = {p[pl * 2], p[pl * 2 + 1], p[6 + pl * 2], p[6 + pl * 2 + 1]};
    lw[0] = a.logwd[mb * 2];
    lw[1] = a.logwd[mb * 2 + 1];
  } else {
    const int sid = a.slice_id[mb];
    const int r0 = min(max(a.refidx[cell * 2], -1), 31) + 1;
    const int r1 = min(max(a.refidx[cell * 2 + 1], -1), 31) + 1;
    const int32_t* p = a.wtab + (long)b * a.wtab_stride +
                       (((long)sid * kRefs + r0) * kRefs + r1) * 12;
    for (int pl = 0; pl < 3; ++pl)
      w[pl] = {p[pl * 4], p[pl * 4 + 1], p[pl * 4 + 2], p[pl * 4 + 3]};
    lw[0] = a.slogwd[((long)b * kSlices + sid) * 2];
    lw[1] = a.slogwd[((long)b * kSlices + sid) * 2 + 1];
  }

  const long plane_y = (long)H * W;
  const uint8_t* py = a.pred_y + (long)b * 2 * plane_y;
  for (int r = 0; r < 4; ++r)
    for (int x = 0; x < 4; ++x) {
      const long o = (long)(cy * 4 + r) * W + cx * 4 + x;
      const int v = combine(only1 ? 0 : py[o], u1 || only1 ? py[plane_y + o]
                            : 0, w[0], lw[0], both, only1);
      a.init_y[ry + r * W + x] = clip255(v + a.res_y[ry + r * W + x]);
    }
  const long plane_c = (long)Hc * Wc;
  const uint8_t* pc = a.pred_c + (long)b * 4 * plane_c;
  for (int pl = 0; pl < 2; ++pl) {
    const int32_t* res = pl ? a.res_cr : a.res_cb;
    int32_t* out = pl ? a.init_cr : a.init_cb;
    for (int r = 0; r < 2; ++r)
      for (int x = 0; x < 2; ++x) {
        const long o = (long)(cy * 2 + r) * Wc + cx * 2 + x;
        const int v = combine(
            only1 ? 0 : pc[pl * plane_c + o],
            u1 || only1 ? pc[(2 + pl) * plane_c + o] : 0, w[1 + pl], lw[1],
            both, only1);
        out[rc + r * Wc + x] = clip255(v + res[rc + r * Wc + x]);
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
