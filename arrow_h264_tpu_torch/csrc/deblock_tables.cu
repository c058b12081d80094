// Deblocking tables (spec 8.7.2): every edge's bS, tc0, alpha and beta
// for [B] pictures, in one launch.
//
// Replaces: no pallas_call.  The reference computes these tables in XLA,
// inside the one jitted executable of decode_frames_batch_fn
// (arrow_h264_tpu/ops/deblock.py::deblock_tables, :354, called at
// arrow_h264_tpu/models/pipeline.py:191), where XLA fuses them into a
// few device programs.  The port's plain version (ops/deblock.py::
// deblock_tables) runs eagerly as ~450 small torch operations a call, so
// the host's launch time, not the card, set its cost (9.1 ms of a 1080p
// frame); this kernel is that stage as one launch.
//
// What bounds it: bytes.  An MB reads 119 int32 ABI words (kind, qp,
// slice_id, disable_idc, alpha_off, beta_off, tr8, nz [4,4], mv
// [4,4,2,2], refid [4,4,2]: 476 bytes) and writes 144 table words (576
// bytes); at 1080p that is ~8.6 MB, ~0.0026 ms at 3.35 TB/s.  The
// arithmetic is a few hundred integer operations an MB.
//
// What the design does about it: every read is coalesced and every
// store 16 bytes wide where the layout allows.  A block takes a strip of
// kStrip consecutive MBs of one lane and stages, with 16-byte cp.async,
// the strip's nz, mv and refid, those of the MB before it (the left
// neighbour of the strip's first MB), the bottom row of 4x4 blocks
// (12-15) of each MB above, and the scalar fields.  A scalar field whose
// spans in the lane and in shared memory do not share their 16-byte
// alignment (a lane start b * n that is not a multiple of 4, e.g. n = 99)
// and the head and tail of a span come word by word; a ragged last strip
// stages only its MBs.  Then a thread an (MB, direction, edge), 8 an MB,
// computes its edge's 4 segments from shared memory and writes its bS
// and tc0 as one int4 each, neighbouring threads on neighbouring 16-byte
// chunks, and its alpha and beta; the threads of edges 0 and 2 also
// write that chroma edge's tables (bS one int4, tc0 two, alpha and beta
// an int2 each).  Every table is a 16-byte aligned view of one
// allocation (the wrapper's).  The four constant tables (alpha, beta,
// tc0 [3, 52], the chroma QP map) arrive as device tensors from
// common/tables.py and are staged too, so this file holds no copy of
// them.  No array is indexed at run time in registers (that put a stack
// frame in local memory): a segment's list is chosen by selects.
//
// The plain version's rules that this reproduces word for word:
// - at the picture border (column 0 for vertical edges, row 0 for
//   horizontal ones) the neighbour is the MB itself, as the plain
//   version's shift replicates the MB's own column; bS is masked to 0
//   there, but alpha, beta and tc0 come from the MB's own qp;
// - tc0 where bS is 0 is tc0[0][indexA]; bS 4 reads row 2;
// - internal edges 1 and 3 are masked by tr8, edge 2 is not;
//   disable_idc 1 masks every edge, disable_idc 2 the MB edge across a
//   slice change;
// - field pictures: the vertical MV limit is 2 quarter samples, and
//   intra MBs give bS 3 on horizontal MB edges;
// - refid is compared only for validity (>= 0) and equality, so wire
//   uploads (slot | NX_FLAG) and dense ones (picture uids) agree.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 32;             // MBs a block, consecutive in a lane
constexpr int kThreads = 8 * kStrip;   // a thread a (MB, direction, edge)
constexpr int kPitch = 20;             // 4x4 blocks an MB in shared memory
                                       // (16 used; 20 spreads a warp's
                                       // column reads over the banks)
constexpr int kQp = 52;                // entries of each QP-indexed table

struct TablesArgs {
  // ABI, [B, n] or [B, n, ...] int32
  const int32_t* kind;
  const int32_t* qp;
  const int32_t* slice_id;
  const int32_t* disable_idc;
  const int32_t* alpha_off;
  const int32_t* beta_off;
  const int32_t* tr8;
  const int32_t* nz;                   // [B, n, 4, 4]
  const int32_t* mv;                   // [B, n, 4, 4, 2, 2]
  const int32_t* refid;                // [B, n, 4, 4, 2]
  // constant tables
  const int32_t* alpha;                // [52]
  const int32_t* beta;                 // [52]
  const int32_t* tc0;                  // [3, 52]
  const int32_t* cqp;                  // [52]
  // outputs (ops/deblock.py::deblock_tables's keys and shapes), each
  // 16-byte aligned
  int32_t* bs_v;                       // [B, n, 4(e), 4(s)]
  int32_t* tc_v;
  int32_t* a_v;                        // [B, n, 4(e)]
  int32_t* b_v;
  int32_t* bs_h;
  int32_t* tc_h;
  int32_t* a_h;
  int32_t* b_h;
  int32_t* bs_c;                       // [B, n, 2(d), 2(e), 4(s)]
  int32_t* tc_c;                       // [B, n, 2(d), 2(e), 4(s), 2(pl)]
  int32_t* a_c;                        // [B, n, 2(d), 2(e), 2(pl)]
  int32_t* b_c;
  int B, mb_w, mb_h, cqp0, cqp1, field;
};

// A strip's staged inputs.  A 4x4 block's mv [list][component] is one
// int4, its refid [list] one int2.  Slot k of the full MBs holds MB
// m0 - 1 + k (slot 0: the MB before the strip); top_* hold row 3 of the
// MB above each strip MB; left_* the scalars of slot 0.
struct Stage {
  int4 mv[kStrip + 1][kPitch];
  int2 ref[kStrip + 1][kPitch];
  int nz[kStrip + 1][kPitch];
  int4 top_mv[kStrip][4];
  int2 top_ref[kStrip][4];
  int top_nz[kStrip][4];
  int kind[kStrip], qp[kStrip], slice[kStrip], dis[kStrip], aoff[kStrip],
      boff[kStrip], tr8[kStrip];
  int top_kind[kStrip], top_qp[kStrip], top_slice[kStrip];
  int left_kind, left_qp, left_slice;
  int alpha[kQp], beta[kQp], tc0[3 * kQp], cqp[kQp];
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

// 16 bytes global -> shared: one copy where `vec` (the ABI arrays are
// 16-byte aligned), else four of a word.
__device__ __forceinline__ void copy16(void* dst, const int32_t* src,
                                       bool vec) {
  if (vec) {
    copy_async<16>(dst, src);
    return;
  }
  for (int k = 0; k < 4; ++k)
    copy_async<4>(static_cast<int32_t*>(dst) + k, src + k);
}

// `count` words global -> shared, by the block's threads: 16-byte copies
// where the two spans share their 16-byte alignment, between a head
// that reaches it and a tail (up to 3 words each); word by word where
// they do not.
__device__ __forceinline__ void stage_words(int32_t* dst, const int32_t* src,
                                            int count) {
  int head = count;
  if ((((uintptr_t)src ^ (uintptr_t)dst) & 15) == 0) {
    const int to_align = (int)((16 - ((uintptr_t)src & 15)) & 15) / 4;
    head = to_align < count ? to_align : count;
  }
  const int chunks = (count - head) / 4, tail = head + 4 * chunks;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    copy_async<16>(dst + head + 4 * c, src + head + 4 * c);
  for (int i = threadIdx.x; i < head + count - tail; i += blockDim.x) {
    const int w = i < head ? i : tail + i - head;
    copy_async<4>(dst + w, src + w);
  }
}

__device__ __forceinline__ int clamp51(int v) {
  return v < 0 ? 0 : (v > 51 ? 51 : v);
}

__device__ __forceinline__ int tc_row(int bs) {   // tc0's row for bS
  return bs - 1 < 0 ? 0 : (bs - 1 > 2 ? 2 : bs - 1);
}

__device__ __forceinline__ bool mv_far(int px, int py, int qx, int qy,
                                       int limit_y) {
  return abs(px - qx) >= 4 || abs(py - qy) >= limit_y;
}

// Boundary strength of one edge segment (spec 8.7.2.1) where neither MB
// is intra, before masking: ops/deblock.py::_bs_pair's later rules.
// rp/rq: the two lists' refids (-1 unused); mp/mq: [list][component].
__device__ __forceinline__ int bs_inter(bool nzp, bool nzq, int2 rp,
                                        int2 rq, int4 mp, int4 mq,
                                        int limit_y) {
  if (nzp || nzq) return 2;
  const int n_p = (rp.x >= 0) + (rp.y >= 0);
  const int n_q = (rq.x >= 0) + (rq.y >= 0);
  const bool sets_eq = min(rp.x, rp.y) == min(rq.x, rq.y) &&
                       max(rp.x, rp.y) == max(rq.x, rq.y);
  if (n_p != n_q || !sets_eq) return 1;
  if (n_p == 1) {                      // the list each side uses
    const bool p0 = rp.x >= 0, q0 = rq.x >= 0;
    return mv_far(p0 ? mp.x : mp.z, p0 ? mp.y : mp.w, q0 ? mq.x : mq.z,
                  q0 ? mq.y : mq.w, limit_y);
  }
  if (n_p == 2) {
    const bool straight = mv_far(mp.x, mp.y, mq.x, mq.y, limit_y) ||
                          mv_far(mp.z, mp.w, mq.z, mq.w, limit_y);
    const bool crossed = mv_far(mp.x, mp.y, mq.z, mq.w, limit_y) ||
                         mv_far(mp.z, mp.w, mq.x, mq.y, limit_y);
    if (rp.x == rp.y) return straight && crossed;
    return rq.x == rp.x ? straight : crossed;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
deblock_tables_kernel(TablesArgs a) {
  __shared__ Stage S;
  const int n = a.mb_w * a.mb_h, m0 = blockIdx.x * kStrip;
  const int count = min(kStrip, n - m0);         // the last strip: ragged
  const long lane = (long)blockIdx.y * n;
  const int tid = threadIdx.x;

  // ---- stage ----
  const bool vec = (((uintptr_t)a.nz | (uintptr_t)a.mv |
                     (uintptr_t)a.refid) & 15) == 0;
  // every MB of the strip and the one before it (none before MB 0): 28
  // chunks of 16 bytes an MB (nz 4, mv 16, refid 8)
  const int first = m0 > 0 ? 0 : 1;
  for (int c = tid; c < (count + 1 - first) * 28; c += kThreads) {
    const int k = first + c / 28, w = c % 28;
    const long mb = lane + m0 - 1 + k;
    if (w < 4)
      copy16(&S.nz[k][4 * w], a.nz + mb * 16 + 4 * w, vec);
    else if (w < 20)
      copy16(&S.mv[k][w - 4], a.mv + mb * 64 + 4 * (w - 4), vec);
    else
      copy16(&S.ref[k][2 * (w - 20)], a.refid + mb * 32 + 4 * (w - 20),
             vec);
  }
  // row 3 of the MB above each strip MB from t0 on (those below row 0):
  // 7 chunks an MB (nz 1, mv 4, refid 2)
  const int t0 = max(0, a.mb_w - m0), tops = max(0, count - t0);
  for (int c = tid; c < tops * 7; c += kThreads) {
    const int l = t0 + c / 7, w = c % 7;
    const long mb = lane + m0 + l - a.mb_w;
    if (w == 0)
      copy16(S.top_nz[l], a.nz + mb * 16 + 12, vec);
    else if (w < 5)
      copy16(&S.top_mv[l][w - 1], a.mv + mb * 64 + 48 + 4 * (w - 1), vec);
    else
      copy16(&S.top_ref[l][2 * (w - 5)], a.refid + mb * 32 + 24 +
             4 * (w - 5), vec);
  }
  const long s0 = lane + m0;
  stage_words(S.kind, a.kind + s0, count);
  stage_words(S.qp, a.qp + s0, count);
  stage_words(S.slice, a.slice_id + s0, count);
  stage_words(S.dis, a.disable_idc + s0, count);
  stage_words(S.aoff, a.alpha_off + s0, count);
  stage_words(S.boff, a.beta_off + s0, count);
  stage_words(S.tr8, a.tr8 + s0, count);
  if (tops > 0) {
    stage_words(S.top_kind + t0, a.kind + s0 + t0 - a.mb_w, tops);
    stage_words(S.top_qp + t0, a.qp + s0 + t0 - a.mb_w, tops);
    stage_words(S.top_slice + t0, a.slice_id + s0 + t0 - a.mb_w, tops);
  }
  if (m0 > 0 && tid == 0) {
    copy_async<4>(&S.left_kind, a.kind + s0 - 1);
    copy_async<4>(&S.left_qp, a.qp + s0 - 1);
    copy_async<4>(&S.left_slice, a.slice_id + s0 - 1);
  }
  for (int i = tid; i < 3 * kQp; i += kThreads) {
    copy_async<4>(&S.tc0[i], a.tc0 + i);
    if (i < kQp) {
      copy_async<4>(&S.alpha[i], a.alpha + i);
      copy_async<4>(&S.beta[i], a.beta + i);
      copy_async<4>(&S.cqp[i], a.cqp + i);
    }
  }
  copy_wait_all();
  __syncthreads();

  // ---- a thread a (MB l, direction d, edge e): warps 0-3 vertical
  // edges, 4-7 horizontal; a warp's threads 8 MBs x 4 edges ----
  const int d = tid / (4 * kStrip), l = (tid / 4) % kStrip, e = tid % 4;
  if (l >= count) return;
  const int m = m0 + l;
  const bool horiz = d == 1;
  // the neighbour across edge 0: left or top, or the MB itself at the
  // picture border (the plain version's shift replicates it)
  const bool has_nb = horiz ? m >= a.mb_w : m % a.mb_w > 0;
  int nb_kind = S.kind[l], nb_qp = S.qp[l], nb_slice = S.slice[l];
  if (has_nb && horiz) {
    nb_kind = S.top_kind[l];
    nb_qp = S.top_qp[l];
    nb_slice = S.top_slice[l];
  } else if (has_nb) {
    nb_kind = l > 0 ? S.kind[l - 1] : S.left_kind;
    nb_qp = l > 0 ? S.qp[l - 1] : S.left_qp;
    nb_slice = l > 0 ? S.slice[l - 1] : S.left_slice;
  }
  const int qp = S.qp[l], dis = S.dis[l];
  const bool do_any = dis != 1, mb_edge = e == 0;
  const bool mask = mb_edge
      ? do_any && has_nb && !(dis == 2 && nb_slice != S.slice[l])
      : do_any && (e == 2 || S.tr8[l] <= 0);
  const int qpp = mb_edge ? nb_qp : qp;
  const int qpav = (qpp + qp + 1) >> 1;
  const int aoff = S.aoff[l], boff = S.boff[l];
  const int ia = clamp51(qpav + aoff), ib = clamp51(qpav + boff);
  const bool field = a.field != 0;
  const bool intra = S.kind[l] <= 3 || (mb_edge ? nb_kind : S.kind[l]) <= 3;
  const int strong = mb_edge && !(field && horiz) ? 4 : 3;
  const int limit_y = field ? 2 : 4;

  // block (row, column) of segment s: vertical edges [s, e], horizontal
  // [e, s]; p, the block before the edge, lies in the neighbour for edge
  // 0 (its column 3, or the MB above's row 3, staged as blocks 0-3)
  const int step = horiz ? 1 : 4, q0 = horiz ? 4 * e : e;
  const int4* pmv = S.mv[l + 1];
  const int2* pref = S.ref[l + 1];
  const int* pnz = S.nz[l + 1];
  int p0 = horiz ? 4 * (e - 1) : e - 1;
  if (mb_edge && !horiz) {
    pmv = S.mv[has_nb ? l : l + 1];
    pref = S.ref[has_nb ? l : l + 1];
    pnz = S.nz[has_nb ? l : l + 1];
    p0 = 3;
  } else if (mb_edge) {
    pmv = has_nb ? S.top_mv[l] : pmv;
    pref = has_nb ? S.top_ref[l] : pref;
    pnz = has_nb ? S.top_nz[l] : pnz;
    p0 = has_nb ? 0 : 12;
  }
  int bs[4], tc[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int qb = q0 + s * step, pb = p0 + s * step;
    int v = intra ? strong
                  : bs_inter(pnz[pb] > 0, S.nz[l + 1][qb] > 0, pref[pb],
                             S.ref[l + 1][qb], pmv[pb], S.mv[l + 1][qb],
                             limit_y);
    if (!mask) v = 0;
    bs[s] = v;
    tc[s] = S.tc0[tc_row(v) * kQp + ia];
  }
  const long self = lane + m, at = self * 4 + e;
  reinterpret_cast<int4*>(horiz ? a.bs_h : a.bs_v)[at] =
      make_int4(bs[0], bs[1], bs[2], bs[3]);
  reinterpret_cast<int4*>(horiz ? a.tc_h : a.tc_v)[at] =
      make_int4(tc[0], tc[1], tc[2], tc[3]);
  (horiz ? a.a_h : a.a_v)[at] = S.alpha[ia];
  (horiz ? a.b_h : a.b_v)[at] = S.beta[ib];
  if (e & 1) return;

  // chroma edge e / 2 of this direction: luma edge e's bS, per plane
  const long de = (self * 2 + d) * 2 + (e >> 1);
  reinterpret_cast<int4*>(a.bs_c)[de] = make_int4(bs[0], bs[1], bs[2], bs[3]);
  int ac[2], bc[2], tcc[2][4];
#pragma unroll
  for (int pl = 0; pl < 2; ++pl) {
    const int off = pl ? a.cqp1 : a.cqp0;
    const int qpc_p = S.cqp[clamp51(qpp + off)];
    const int qpc_q = S.cqp[clamp51(qp + off)];
    const int qpavc = (qpc_p + qpc_q + 1) >> 1;
    const int iac = clamp51(qpavc + aoff), ibc = clamp51(qpavc + boff);
    ac[pl] = S.alpha[iac];
    bc[pl] = S.beta[ibc];
#pragma unroll
    for (int s = 0; s < 4; ++s) tcc[pl][s] = S.tc0[tc_row(bs[s]) * kQp + iac];
  }
  int4* tc_c = reinterpret_cast<int4*>(a.tc_c) + 2 * de;   // [s][pl]
  tc_c[0] = make_int4(tcc[0][0], tcc[1][0], tcc[0][1], tcc[1][1]);
  tc_c[1] = make_int4(tcc[0][2], tcc[1][2], tcc[0][3], tcc[1][3]);
  reinterpret_cast<int2*>(a.a_c)[de] = make_int2(ac[0], ac[1]);
  reinterpret_cast<int2*>(a.b_c)[de] = make_int2(bc[0], bc[1]);
}

}  // namespace

// The twelve output tables must be 16-byte aligned (the wrapper cuts them
// from one allocation); B at most 65535.
extern "C" int deblock_tables_launch(
    const int32_t* kind, const int32_t* qp, const int32_t* slice_id,
    const int32_t* disable_idc, const int32_t* alpha_off,
    const int32_t* beta_off, const int32_t* tr8, const int32_t* nz,
    const int32_t* mv, const int32_t* refid, const int32_t* alpha,
    const int32_t* beta, const int32_t* tc0, const int32_t* cqp,
    int32_t* bs_v, int32_t* tc_v, int32_t* a_v, int32_t* b_v,
    int32_t* bs_h, int32_t* tc_h, int32_t* a_h, int32_t* b_h,
    int32_t* bs_c, int32_t* tc_c, int32_t* a_c, int32_t* b_c, int B,
    int mb_w, int mb_h, int cqp0, int cqp1, int field, void* stream) {
  TablesArgs a{kind, qp, slice_id, disable_idc, alpha_off, beta_off, tr8,
               nz, mv, refid, alpha, beta, tc0, cqp, bs_v, tc_v, a_v, b_v,
               bs_h, tc_h, a_h, b_h, bs_c, tc_c, a_c, b_c, B, mb_w, mb_h,
               cqp0, cqp1, field};
  const int n = mb_w * mb_h;
  if (B == 0 || n == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kStrip - 1) / kStrip, B);
  deblock_tables_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
