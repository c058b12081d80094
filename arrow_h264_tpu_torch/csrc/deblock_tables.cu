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
// What the design does about it: nothing beyond being one launch.  One
// thread per (MB, direction): it reads its own MB's words and the last
// column (vertical edges) or row (horizontal edges) of blocks of its
// left or top neighbour, and writes that direction's luma and chroma
// tables of its MB.  The four constant tables (alpha, beta, tc0 [3, 52],
// the chroma QP map) arrive as device tensors from common/tables.py and
// are staged in shared memory, so this file holds no copy of them.
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
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
  // outputs (ops/deblock.py::deblock_tables's keys and shapes)
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

__device__ __forceinline__ int clamp51(int v) {
  return v < 0 ? 0 : (v > 51 ? 51 : v);
}

__device__ __forceinline__ bool mv_far(const int* a, const int* b,
                                       int limit_y) {
  return abs(a[0] - b[0]) >= 4 || abs(a[1] - b[1]) >= limit_y;
}

// Boundary strength of one edge segment (spec 8.7.2.1), before masking:
// ops/deblock.py::_bs_pair.  rp/rq: the two lists' refids (-1 unused);
// mvp/mvq [list][component].
__device__ int bs_pair(bool ip, bool iq, bool mb_edge, bool nzp, bool nzq,
                       const int* rp, const int* rq, const int (*mvp)[2],
                       const int (*mvq)[2], bool field, bool horiz) {
  if (ip || iq) return mb_edge && !(field && horiz) ? 4 : 3;
  if (nzp || nzq) return 2;
  const int limit_y = field ? 2 : 4;
  const int n_p = (rp[0] >= 0) + (rp[1] >= 0);
  const int n_q = (rq[0] >= 0) + (rq[1] >= 0);
  const bool sets_eq = min(rp[0], rp[1]) == min(rq[0], rq[1]) &&
                       max(rp[0], rp[1]) == max(rq[0], rq[1]);
  if (n_p != n_q || !sets_eq) return 1;
  if (n_p == 1)                        // the list each side uses
    return mv_far(mvp[rp[0] >= 0 ? 0 : 1], mvq[rq[0] >= 0 ? 0 : 1],
                  limit_y);
  if (n_p == 2) {
    const bool straight = mv_far(mvp[0], mvq[0], limit_y) ||
                          mv_far(mvp[1], mvq[1], limit_y);
    const bool crossed = mv_far(mvp[0], mvq[1], limit_y) ||
                         mv_far(mvp[1], mvq[0], limit_y);
    if (rp[0] == rp[1]) return straight && crossed;
    return rq[0] == rp[0] ? straight : crossed;
  }
  return 0;
}

// One 4x4 block's coding data: nz, both lists' refids and MVs.
struct Blk {
  bool nz;
  int ref[2];
  int mv[2][2];
};

__device__ __forceinline__ Blk load_blk(const TablesArgs& a, long mb,
                                        int blk) {
  const long c = mb * 16 + blk;
  Blk o;
  o.nz = a.nz[c] > 0;
  for (int l = 0; l < 2; ++l) {
    o.ref[l] = a.refid[c * 2 + l];
    for (int k = 0; k < 2; ++k) o.mv[l][k] = a.mv[(c * 2 + l) * 2 + k];
  }
  return o;
}

__global__ void __launch_bounds__(kThreads)
deblock_tables_kernel(TablesArgs a) {
  __shared__ int s_alpha[kQp], s_beta[kQp], s_tc0[3 * kQp], s_cqp[kQp];
  for (int i = threadIdx.x; i < 3 * kQp; i += blockDim.x) {
    s_tc0[i] = a.tc0[i];
    if (i < kQp) {
      s_alpha[i] = a.alpha[i];
      s_beta[i] = a.beta[i];
      s_cqp[i] = a.cqp[i];
    }
  }
  __syncthreads();
  const int n = a.mb_w * a.mb_h;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2L * a.B * n) return;
  const int d = t & 1;                 // 0 vertical edges, 1 horizontal
  const long self = t >> 1;            // b * n + m
  const int m = self % n;
  const int mx = m % a.mb_w, my = m / a.mb_w;
  const bool horiz = d == 1;
  // the neighbour across edge 0: left or top, or the MB itself at the
  // picture border (the plain version's shift replicates it)
  const bool has_nb = horiz ? my > 0 : mx > 0;
  const long nb = has_nb ? self - (horiz ? a.mb_w : 1) : self;

  const bool q_intra = a.kind[self] <= 3, p_intra = a.kind[nb] <= 3;
  const int qp = a.qp[self], qp_nb = a.qp[nb];
  const int dis = a.disable_idc[self];
  const bool do_any = dis != 1;
  const bool edge0_ok = do_any && has_nb &&
                        !(dis == 2 && a.slice_id[nb] != a.slice_id[self]);
  const bool tr8 = a.tr8[self] > 0;
  const int aoff = a.alpha_off[self], boff = a.beta_off[self];
  const bool field = a.field != 0;

  int32_t* bs_o = horiz ? a.bs_h : a.bs_v;
  int32_t* tc_o = horiz ? a.tc_h : a.tc_v;
  int32_t* a_o = horiz ? a.a_h : a.a_v;
  int32_t* b_o = horiz ? a.b_h : a.b_v;
  int bs_chroma[2][4];                 // luma edges 0 and 2
  for (int e = 0; e < 4; ++e) {
    const bool mb_edge = e == 0;
    const bool mask = mb_edge ? edge0_ok : do_any && (e == 2 || !tr8);
    const long p_mb = mb_edge ? nb : self;
    const int qpp = mb_edge ? qp_nb : qp;
    const int qpav = (qpp + qp + 1) >> 1;
    const int ia = clamp51(qpav + aoff), ib = clamp51(qpav + boff);
    a_o[self * 4 + e] = s_alpha[ia];
    b_o[self * 4 + e] = s_beta[ib];
    for (int s = 0; s < 4; ++s) {
      // block (row, column): vertical edges [s, e], horizontal [e, s];
      // p is the block before the edge, in the neighbour for edge 0
      const int q_blk = horiz ? e * 4 + s : s * 4 + e;
      const int pe = mb_edge ? 3 : e - 1;
      const int p_blk = horiz ? pe * 4 + s : s * 4 + pe;
      const Blk p = load_blk(a, p_mb, p_blk), q = load_blk(a, self, q_blk);
      int bs = bs_pair(mb_edge ? p_intra : q_intra, q_intra, mb_edge, p.nz,
                       q.nz, p.ref, q.ref, p.mv, q.mv, field, horiz);
      if (!mask) bs = 0;
      const int row = bs - 1 < 0 ? 0 : (bs - 1 > 2 ? 2 : bs - 1);
      bs_o[(self * 4 + e) * 4 + s] = bs;
      tc_o[(self * 4 + e) * 4 + s] = s_tc0[row * kQp + ia];
      if (!(e & 1)) bs_chroma[e >> 1][s] = bs;
    }
  }

  // chroma: luma edges 0 and 2 of this direction, per plane
  const int cqp_off[2] = {a.cqp0, a.cqp1};
  for (int e = 0; e < 2; ++e) {
    const int qpp = e == 0 ? qp_nb : qp;
    const long de = (self * 2 + d) * 2 + e;
    for (int s = 0; s < 4; ++s) a.bs_c[de * 4 + s] = bs_chroma[e][s];
    for (int pl = 0; pl < 2; ++pl) {
      const int qpc_p = s_cqp[clamp51(qpp + cqp_off[pl])];
      const int qpc_q = s_cqp[clamp51(qp + cqp_off[pl])];
      const int qpav = (qpc_p + qpc_q + 1) >> 1;
      const int ia = clamp51(qpav + aoff), ib = clamp51(qpav + boff);
      a.a_c[de * 2 + pl] = s_alpha[ia];
      a.b_c[de * 2 + pl] = s_beta[ib];
      for (int s = 0; s < 4; ++s) {
        const int bs = bs_chroma[e][s];
        const int row = bs - 1 < 0 ? 0 : (bs - 1 > 2 ? 2 : bs - 1);
        a.tc_c[(de * 4 + s) * 2 + pl] = s_tc0[row * kQp + ia];
      }
    }
  }
}

}  // namespace

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
  const long threads = 2L * B * mb_w * mb_h;
  if (threads == 0) return 0;
  const long grid = (threads + kThreads - 1) / kThreads;
  deblock_tables_kernel<<<(unsigned)grid, kThreads, 0,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
