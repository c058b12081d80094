// arrow_h264_tpu host entropy library (C++).
//
// Reference parity: the JM-lineage host entropy layers (SURVEY.md §2:
// vlc.c, cabac.c, mb_read.c, mv_prediction.c) re-implemented as a single
// slice-data parser that writes the MB-tensor ABI arrays directly
// (SURVEY.md §7 step 5).  Semantics mirror arrow_h264_tpu/mb/parse.py and
// mb/cabac_parse.py exactly; differential tests enforce bit-identical
// outputs against the Python oracle parser.
//
// Build: g++ -O3 -shared -fPIC -o libh264entropy.so entropy.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <utility>
#include <vector>

#include "tables_gen.h"

#if defined(__GNUC__)
#define H264E_LIKELY(x) __builtin_expect(!!(x), 1)
#define H264E_UNLIKELY(x) __builtin_expect(!!(x), 0)
#define H264E_INLINE inline __attribute__((always_inline))
#define H264E_NOINLINE __attribute__((noinline))
#else
#define H264E_LIKELY(x) (x)
#define H264E_UNLIKELY(x) (x)
#define H264E_INLINE inline
#define H264E_NOINLINE
#endif

#ifdef H264E_STATS
// Optional per-run counters/section-timers for performance analysis;
// compiled out of the shipped library.
#include <x86intrin.h>
struct H264eStats {
  uint64_t decisions, bypasses, blocks, coeffs, mbs, sig_iters;
  uint64_t t_resid, t_scatter, t_motion, t_total, t_skip, t_tail;
  uint64_t t_imb, t_presid;   // parse_i_mb; parse_residual incl. glue
};
static H264eStats g_h264e_stats;
extern "C" H264eStats* h264e_stats() { return &g_h264e_stats; }
#define H264E_STAT(field, n) (g_h264e_stats.field += (n))
#define H264E_TSC(field, expr) do { uint64_t t0_ = __rdtsc(); expr; g_h264e_stats.field += __rdtsc() - t0_; } while (0)
#else
#define H264E_STAT(field, n)
#define H264E_TSC(field, expr) expr
#endif

#ifdef H264E_TRACE
// SE-level trace (the JM TRACE analog; trace.py dump_se_log).  A
// -DH264E_TRACE build records every syntax-element read into a
// caller-provided buffer with the SAME records the Python
// TracingBitReader/CabacDecoder produce, so the two engines'traces
// diff equal on a conforming stream (differential-tested):
//   kind 0..3 = u/ue/se/te raw reads (CAVLC slices only; CABAC slices
//   mute raw reads exactly like CabacDecoder sets r.mute), kind 4 =
//   CABAC decision (n = ctx index), kind 5 = bypass (n = -1).
// Compiled out of the shipped library (zero overhead when undefined).
struct H264eTraceRec { int32_t kind, pos, n, v; };
static H264eTraceRec* g_tr_buf = nullptr;
static long g_tr_len = 0, g_tr_cap = 0;
static bool g_tr_raw = false;   // raw bit reads logged (CAVLC slices)
extern "C" void h264e_trace_set(void* buf, long cap) {
  g_tr_buf = (H264eTraceRec*)buf;
  g_tr_cap = cap;
  g_tr_len = 0;
}
extern "C" long h264e_trace_count() { return g_tr_len; }
static inline void h264e_tr(int kind, int64_t pos, int n, int v) {
  if (g_tr_buf == nullptr) return;
  if (g_tr_len < g_tr_cap) {
    g_tr_buf[g_tr_len].kind = kind;
    g_tr_buf[g_tr_len].pos = (int32_t)pos;
    g_tr_buf[g_tr_len].n = n;
    g_tr_buf[g_tr_len].v = v;
  }
  g_tr_len++;                   // counts past cap to signal overflow
}
#define H264E_TR(k, p, n, v) h264e_tr(k, p, n, v)
#define H264E_TR_RAW(k, p, n, v) do { if (g_tr_raw) h264e_tr(k, p, n, v); } while (0)
#define H264E_TR_SETRAW(flag) (g_tr_raw = (flag))
#else
#define H264E_TR(k, p, n, v)
#define H264E_TR_RAW(k, p, n, v)
#define H264E_TR_SETRAW(flag)
#endif

namespace {

constexpr int32_t ORDER_UNDECODED = 1 << 30;

// MB categories (mb/types.py)
enum {
  CAT_I4 = 0, CAT_I8 = 1, CAT_I16 = 2, CAT_IPCM = 3,
  CAT_P = 4, CAT_PSKIP = 5, CAT_B = 6, CAT_BSKIP = 7, CAT_BDIR16 = 8,
};

inline bool cat_is_intra(int c) { return c <= CAT_IPCM; }
inline bool cat_is_intra_nxn(int c) { return c == CAT_I4 || c == CAT_I8; }

// ---------------------------------------------------------------------------
// Bit reader (bitstream/bits.py) — 64-bit word-cached.
//
// `cache` holds the next unconsumed bits left-aligned (bit 63 = next bit),
// zero-padded past the end of the buffer; `ncache` counts valid cache bits.
// Invariant on entry to every public read: ncache >= 33, so any single
// fixed-size read (max 32 bits) and any peek up to 32 bits is one shift.
// Refill is one 8-byte load + bswap per ~4 consumed bytes instead of the
// per-bit loads of the naive reader.
// ---------------------------------------------------------------------------
struct BitReader {
  const uint8_t* d;
  int64_t nbits;
  int64_t nbytes;
  bool error = false;
  uint64_t cache = 0;
  int ncache = 0;
  int64_t pos = 0;  // absolute bit index of the next unconsumed bit

  BitReader(const uint8_t* data, int64_t nbytes_, int64_t bitpos)
      : d(data), nbits(nbytes_ * 8), nbytes(nbytes_), pos(bitpos) {
    reload();
  }

  H264E_NOINLINE void reload() {
    int64_t byte0 = pos >> 3;
    uint64_t v;
    if (H264E_LIKELY(byte0 + 8 <= nbytes)) {
      memcpy(&v, d + byte0, 8);
      v = __builtin_bswap64(v);
    } else {
      if (pos > nbits) error = true;  // ran past the stream (corrupt input)
      v = 0;
      for (int i = 0; i < 8; i++)
        v = (v << 8) | (byte0 + i < nbytes ? d[byte0 + i] : 0);
    }
    int sh = (int)(pos & 7);
    cache = v << sh;
    ncache = 64 - sh;  // 57..64
  }

  H264E_INLINE void consume(int n) {  // n <= ncache
    pos += n;
    cache <<= n;
    ncache -= n;
    if (H264E_UNLIKELY(ncache < 33)) reload();
  }
  H264E_INLINE void skip(int n) { consume(n); }

  // CABAC refill: no per-read bounds check (the cache zero-pads past the
  // end and reload() flags `error` when the position has run past the
  // stream, so corrupt/truncated slices are still detected within ~32
  // bits — checked per-MB by the slice loop).  sh in 0..9.
  H264E_INLINE uint32_t refill_bits(int sh) {
    uint32_t v = (uint32_t)((cache >> 1) >> (63 - sh));
    pos += sh;
    cache <<= sh;
    ncache -= sh;
    if (H264E_UNLIKELY(ncache < 33)) reload();
    return v;
  }

  H264E_INLINE int u1_raw() {
    if (H264E_UNLIKELY(pos >= nbits)) { error = true; return 0; }
    int b = (int)(cache >> 63);
    consume(1);
    return b;
  }
  H264E_INLINE uint32_t u_raw(int n) {  // n in 0..32
    if (n == 0) return 0;
    if (H264E_UNLIKELY(pos + n > nbits)) error = true;
    uint32_t v = (uint32_t)(cache >> (64 - n));
    consume(n);
    return v;
  }
  H264E_INLINE uint32_t peek(int n) const {  // n in 1..32, zero-padded past end
    return (uint32_t)(cache >> (64 - n));
  }
  H264E_INLINE uint32_t ue_raw() {
    int lz = cache ? __builtin_clzll(cache) : 64;
    if (H264E_UNLIKELY(lz >= ncache)) {  // zeros may extend past the cache
      reload();
      lz = cache ? __builtin_clzll(cache) : 64;
    }
    if (H264E_UNLIKELY(lz > 32)) { error = true; return 0; }
    int total = 2 * lz + 1;
    if (H264E_LIKELY(total <= ncache)) {
      if (H264E_UNLIKELY(pos + total > nbits)) error = true;
      uint32_t v = (uint32_t)((cache >> (64 - total)) - 1);
      consume(total);
      return v;
    }
    // long codeword spanning the cache: two-step (rare)
    if (H264E_UNLIKELY(pos + total > nbits)) error = true;
    consume(lz + 1);
    return (uint32_t)((1ull << lz) - 1 + u_raw(lz));
  }
  // Public reads log SE-trace records in -DH264E_TRACE builds with the
  // exact granularity of the Python TracingBitReader (composite ue/se/
  // te codes log once; their inner fixed reads stay raw).
  H264E_INLINE int u1() {
    int64_t p = pos; (void)p;
    int b = u1_raw();
    H264E_TR_RAW(0, p, 1, b);
    return b;
  }
  H264E_INLINE uint32_t u(int n) {
    int64_t p = pos; (void)p;
    uint32_t v = u_raw(n);
    H264E_TR_RAW(0, p, n, (int)v);
    return v;
  }
  H264E_INLINE uint32_t ue() {
    int64_t p = pos; (void)p;
    uint32_t v = ue_raw();
    H264E_TR_RAW(1, p, (int)(pos - p), (int)v);
    return v;
  }
  H264E_INLINE int32_t se() {
    int64_t p = pos; (void)p;
    uint32_t k = ue_raw();
    int32_t v = (k & 1) ? (int32_t)((k + 1) >> 1) : -(int32_t)(k >> 1);
    H264E_TR_RAW(2, p, (int)(pos - p), v);
    return v;
  }
  H264E_INLINE uint32_t te(int max_val) {
    int64_t p = pos; (void)p;
    uint32_t v = (max_val == 1) ? (uint32_t)(1 - u1_raw()) : ue_raw();
    H264E_TR_RAW(3, p, (int)(pos - p), (int)v);
    return v;
  }
  // VLC table consume: synthesizes the per-bit records the Python
  // oracle's _read_vlc emits (one ("u", p, 1, bit) per code bit)
  H264E_INLINE void skip_vlc(int n) {
#ifdef H264E_TRACE
    if (g_tr_raw) {
      uint32_t b = peek(n);
      for (int i = 0; i < n; i++)
        h264e_tr(0, pos + i, 1, (int)((b >> (n - 1 - i)) & 1));
    }
#endif
    consume(n);
  }
  inline void align() {
    int rem = (int)(pos & 7);
    if (rem) consume(8 - rem);
  }
  bool more_rbsp_data() const {
    if (pos >= nbits) return false;
    int64_t last = nbits / 8 - 1;
    while (last >= 0 && d[last] == 0) last--;
    if (last < 0) return false;
    uint8_t b = d[last];
    int low = 0;
    while (!((b >> low) & 1)) low++;
    int64_t stop = last * 8 + (7 - low);
    return pos < stop;
  }
};

// ---------------------------------------------------------------------------
// CABAC engine (entropy/cabac.py, spec 9.3) — branchless hot path.
//
// Context state is packed one byte per context: s2 = (state << 1) | mps.
// Transition tables are precomputed over s2 so an MPS/LPS step is a single
// table load + store; the MPS-vs-LPS split and the renormalization are
// mask/cmov + one clz shift (no data-dependent branches — CABAC bins are
// near-incompressible, so branches on them mispredict at the LPS rate).
// ---------------------------------------------------------------------------
struct CabacTables {
  uint8_t lps2[128 * 4];    // rangeTabLPS indexed by packed state
  uint8_t next_mps[128];    // s2 after an MPS decision
  uint8_t next_lps[128];    // s2 after an LPS decision (state 0 flips MPS)
  CabacTables() {
    for (int s = 0; s < 64; s++)
      for (int m = 0; m < 2; m++) {
        int s2 = (s << 1) | m;
        for (int q = 0; q < 4; q++) lps2[s2 * 4 + q] = kRangeLPS[s * 4 + q];
        next_mps[s2] = (uint8_t)((kTransMPS[s] << 1) | m);
        next_lps[s2] = (uint8_t)((kTransLPS[s] << 1) | (s == 0 ? m ^ 1 : m));
      }
  }
};
static const CabacTables kCT;

struct Cabac {
  BitReader* r;
  int32_t range_, offset_;
  uint8_t pstate[1024];  // (state << 1) | mps per context

  void start(BitReader* br) {
    r = br;
    r->align();
    range_ = 510;
    int64_t p = r->pos; (void)p;
    offset_ = (int32_t)r->u_raw(9);
    // CabacDecoder.__init__ reads the 9 init bits before muting the
    // raw log, so the Python SE trace carries this one record
    H264E_TR(0, p, 9, offset_);
  }
  void init_ctx(int qp, const int8_t* tab) {
    if (qp < 0) qp = 0;
    if (qp > 51) qp = 51;
    for (int i = 0; i < 1024; i++) {
      int m = tab[2 * i], n = tab[2 * i + 1];
      int pre = ((m * qp) >> 4) + n;
      if (pre < 1) pre = 1;
      if (pre > 126) pre = 126;
      if (pre <= 63) pstate[i] = (uint8_t)((63 - pre) << 1);
      else pstate[i] = (uint8_t)(((pre - 64) << 1) | 1);
    }
  }
  // One-shift renorm: doubling count = clz(range)-23 for range in [2,255],
  // clamped to 0 when no renorm is needed; refill comes from the reader's
  // 64-bit cache (the round-2 engine read one bit per loop iteration).
  H264E_INLINE void renorm() {
    int sh = __builtin_clz((unsigned)range_) - 23;
    sh &= ~(sh >> 31);  // max(sh, 0)
    range_ <<= sh;
    offset_ = (offset_ << sh) | (int32_t)r->refill_bits(sh);
  }
  H264E_INLINE int decision(int ctx) {
    H264E_STAT(decisions, 1);
    int64_t p = r->pos; (void)p;
    unsigned s2 = pstate[ctx];
    int lps = kCT.lps2[s2 * 4 + ((range_ >> 6) & 3)];
    range_ -= lps;
    int32_t diff = offset_ - range_;
    int32_t mps_mask = diff >> 31;  // -1 on MPS, 0 on LPS
    int bit = (int)(s2 & 1) ^ (int)(~mps_mask & 1);
    offset_ = mps_mask ? offset_ : diff;
    range_ = mps_mask ? range_ : lps;
    pstate[ctx] = mps_mask ? kCT.next_mps[s2] : kCT.next_lps[s2];
    renorm();
    H264E_TR(4, p, ctx, bit);
    return bit;
  }
  H264E_INLINE int bypass() {
    H264E_STAT(bypasses, 1);
    int64_t p = r->pos; (void)p;
    offset_ = (offset_ << 1) | (int32_t)r->refill_bits(1);
    int32_t diff = offset_ - range_;
    int one = (int)(~(diff >> 31) & 1);
    offset_ = one ? diff : offset_;
    H264E_TR(5, p, -1, one);
    return one;
  }
  H264E_INLINE int terminate() {
    range_ -= 2;
    if (offset_ >= range_) return 1;
    renorm();
    return 0;
  }
  void flush() {
    range_ = 2;
    renorm();
  }
  void reinit() {
    r->align();
    range_ = 510;
    offset_ = (int32_t)r->u_raw(9);  // raw: the Python engine re-reads
                                     // with the trace log muted
  }
  H264E_INLINE int eg_bypass(int k) {
    int v = 0;
    while (bypass()) {
      v += 1 << k;
      k++;
      if (k > 32) { r->error = true; return 0; }
    }
    while (k > 0) {
      k--;
      if (bypass()) v += 1 << k;
    }
    return v;
  }
};

// Register-resident CABAC view for the residual hot loop.
//
// Two tricks versus the member-field engine:
//  * all state lives in locals for the duration of one block, so the
//    compiler keeps it in registers (member fields were spilled around
//    the out-of-line refill call — that traffic cost more than the
//    CABAC arithmetic itself);
//  * the offset is kept SCALED: low = offset_spec * 2^s + (next s
//    prefetched stream bits).  offset_spec >= range  <=>  low >=
//    range << s, so renormalization is just `s -= shift` and bits are
//    refilled 32 at a time every ~25 bins instead of per bin.
//  The MPS/LPS split stays a branch: context skew makes it ~80-90%
//  predictable, and prediction breaks the range dependency chain
//  (a cmov version measured slower on dense 1080p streams).
struct FastCab {
  uint64_t low;    // offset_spec << s | prefetched bits
  int32_t range;   // unscaled, in [256, 510] after renorm
  int32_t s;       // number of prefetched bits in low (0..39)
  uint64_t cache;  // BitReader view (see BitReader::reload)
  int32_t ncache;
  int64_t pos;
  const uint8_t* d;
  int64_t nbytes;
  uint8_t* ps;
  bool err;

  H264E_INLINE static FastCab enter(Cabac& c) {
    BitReader& R = *c.r;
    return FastCab{(uint64_t)c.offset_, c.range_, 0,
                   R.cache, R.ncache, R.pos,
                   R.d, R.nbytes, c.pstate, false};
  }
  H264E_INLINE void exit(Cabac& c) {
    BitReader& R = *c.r;
    c.range_ = range;
    c.offset_ = (int32_t)(low >> s);
    R.pos = pos - s;  // un-consume the prefetched bits
    R.reload();
    if (H264E_UNLIKELY(err || R.pos > R.nbits)) R.error = true;
  }
  H264E_NOINLINE void refill32() {
    uint32_t v = (uint32_t)(cache >> 32);  // ncache >= 33 invariant
    pos += 32;
    int64_t byte0 = pos >> 3;
    uint64_t w;
    if (H264E_LIKELY(byte0 + 8 <= nbytes)) {
      memcpy(&w, d + byte0, 8);
      w = __builtin_bswap64(w);
    } else {
      w = 0;
      for (int i = 0; i < 8; i++)
        w = (w << 8) | (byte0 + i < nbytes ? d[byte0 + i] : 0);
    }
    int sh2 = (int)(pos & 7);
    cache = w << sh2;
    ncache = 64 - sh2;
    low = (low << 32) | v;
    s += 32;
  }
  H264E_INLINE int dec(int ctx) {
    H264E_STAT(decisions, 1);
    int64_t p = pos - s; (void)p;  // logical consumed bits (pos - s is
                                   // refill-invariant; see exit())
    unsigned s2 = ps[ctx];
    int lps = kCT.lps2[s2 * 4 + ((range >> 6) & 3)];
    range -= lps;
    uint64_t rs = (uint64_t)range << s;
    int bit = (int)(s2 & 1);
    if (H264E_UNLIKELY(low >= rs)) {
      low -= rs;
      range = lps;
      bit ^= 1;
      ps[ctx] = kCT.next_lps[s2];
    } else {
      ps[ctx] = kCT.next_mps[s2];
    }
    int sh = __builtin_clz((unsigned)range) - 23;
    sh &= ~(sh >> 31);  // max(sh, 0); <= 7
    range <<= sh;
    s -= sh;
    if (H264E_UNLIKELY(s < 8)) refill32();
    H264E_TR(4, p, ctx, bit);
    return bit;
  }
  H264E_INLINE int byp() {
    H264E_STAT(bypasses, 1);
    int64_t p = pos - s; (void)p;
    s -= 1;
    if (H264E_UNLIKELY(s < 8)) refill32();
    uint64_t rs = (uint64_t)range << s;
    int one = 0;
    if (low >= rs) { low -= rs; one = 1; }
    H264E_TR(5, p, -1, one);
    return one;
  }
  H264E_INLINE int eg0() {  // exp-golomb k=0 bypass suffix (abs >= 15)
    int k = 0, v = 0;
    while (byp()) {
      v += 1 << k;
      if (H264E_UNLIKELY(++k > 32)) { err = true; return 0; }
    }
    while (k > 0) {
      k--;
      if (byp()) v += 1 << k;
    }
    return v;
  }
  H264E_INLINE int eg(int k) {  // exp-golomb order-k bypass suffix
    int v = 0;
    while (byp()) {
      v += 1 << k;
      if (H264E_UNLIKELY(++k > 32)) { err = true; return 0; }
    }
    while (k > 0) {
      k--;
      if (byp()) v += 1 << k;
    }
    return v;
  }
  // end_of_slice_flag (spec 9.3.3.2.4).  On 1 the engine is NOT
  // renormalized (the caller flushes/aligns); on 0 it is.
  H264E_INLINE int term() {
    range -= 2;
    uint64_t rs = (uint64_t)range << s;
    if (H264E_UNLIKELY(low >= rs)) return 1;
    int sh = __builtin_clz((unsigned)range) - 23;
    sh &= ~(sh >> 31);
    range <<= sh;
    s -= sh;
    if (H264E_UNLIKELY(s < 8)) refill32();
    return 0;
  }
};

// ---------------------------------------------------------------------------
// Parameter blocks passed from Python (layouts must match centropy.py)
// ---------------------------------------------------------------------------
struct PicBuf {
  int32_t mb_w, mb_h;
  int32_t transform_8x8_mode;   // PPS flag
  int32_t constrained_intra;
  int32_t direct_8x8_inference;
  // ABI outputs (int32 unless noted)
  int32_t* kind;
  int32_t* cat;          // internal category per MB
  int32_t* qp;
  int32_t* tr8;
  int32_t* nz;           // [n,16]
  int32_t* slice_id_arr;
  int32_t* disable_idc;
  int32_t* alpha_off;
  int32_t* beta_off;
  int32_t* luma4;        // [n,16,16] raster blocks, raster coeffs
  int32_t* luma8;        // [n,4,64]
  int32_t* luma_dc;      // [n,16]
  int32_t* chroma_dc;    // [n,2,4]
  int32_t* chroma_ac;    // [n,2,4,16] (blk raster y2*2+x2, raster coeffs)
  int32_t* i4_modes;     // [n,16] raster
  int32_t* i8_modes;     // [n,4]
  int32_t* i16_mode;
  int32_t* chroma_mode;
  int32_t* i4_avail;     // [n,16,4]
  int32_t* i8_avail;     // [n,4,4]
  int32_t* mb_avail;     // [n,3]
  int32_t* pcm;          // [n,384]
  int32_t* mv;           // [n,4,4,2,2]
  int32_t* refidx;       // [n,4,4,2]
  int32_t* cbp;          // [n,2]
  int32_t* refslot;      // [n,4,4,2] device DPB slot per cell (-1 unused)
  int32_t* refid;        // [n,4,4,2] unique picture uid per cell (-1)
  // state grids
  int32_t* tc_luma;      // [h4,w4]
  int32_t* tc_cb;        // [h2,w2]
  int32_t* tc_cr;
  int32_t* mode_map;     // [h4,w4]
  int32_t* slice_map;    // [mbh,mbw], init -1
  int32_t* mv_grid;      // [2,h4,w4,2]
  int32_t* ref_grid;     // [2,h4,w4], init -1
  int32_t* order_grid;   // [h4,w4], init ORDER_UNDECODED
  int32_t* direct_grid;  // [h4,w4]
  int32_t* cbf_luma;     // [h4,w4]
  int32_t* cbf_luma_dc;  // [mbh,mbw]
  int32_t* cbf_cdc;      // [2,mbh,mbw]
  int32_t* cbf_cac;      // [2,h2,w2]
  int32_t* mvd_grid;     // [2,h4,w4,2]
  // Nonzero-row hints recorded AT DECODE TIME so the wire pack can
  // gather known rows instead of rescanning the dense coeff arrays
  // (~8 MB/frame of read traffic at 1080p).  Row indices are into the
  // wire's flattened layouts (luma4 [n*16,16], luma8 [n*4,64],
  // chroma_ac [n*8,16], luma_dc [n,16], chroma_dc [n,8]); appended in
  // ascending order for in-order slices (the gather verifies and falls
  // back to a full scan otherwise, e.g. ASO).  Counts in nzr_cnt[0..4]
  // ordered (l4, l8, ca, ldc, cdc) to match ops/wire._COEFF_FIELDS.
  int32_t* nzr_l4;
  int32_t* nzr_l8;
  int32_t* nzr_ca;
  int32_t* nzr_ldc;
  int32_t* nzr_cdc;
  int32_t* nzr_cnt;      // [5]
};

struct SliceParams {
  int32_t slice_type;    // 0 P, 1 B, 2 I
  int32_t first_mb;
  int32_t slice_qp;
  int32_t cabac;
  int32_t cabac_init_idc;
  int32_t num_ref_l0, num_ref_l1;
  int32_t direct_spatial;
  int32_t slice_id;
  int32_t cur_poc;
  int32_t disable_deblock_idc, alpha_off, beta_off;
  // colocated picture info (list1[0]) for B direct
  const int32_t* col_mv;      // [h4,w4,2] or null
  const int8_t* col_refidx;   // [h4,w4]
  const int32_t* col_ref_uid; // [h4,w4]
  int32_t col_longterm;
  int32_t col_poc;
  // extended ref lists
  const int32_t* l0_poc; const uint8_t* l0_lt; const int32_t* l0_uid;
  int32_t l0_len;
  const int32_t* l1_poc; const uint8_t* l1_lt; const int32_t* l1_uid;
  int32_t l1_len;
  const int32_t* l0_slot; const int32_t* l1_slot;  // device DPB slot per idx
  int32_t field_pic;     // coded FIELD picture (PAFF): field scans + field
                         // CABAC significance contexts (Tables 8-14 / 9-40)
  const int32_t* next_mb;  // FMO: dense NextMbAddress table (spec 8.2.2.8),
                           // next_mb[a] == n signals end of slice group;
                           // null = raster order (single slice group)
};

// ---------------------------------------------------------------------------
// Slice parser
// ---------------------------------------------------------------------------
struct Parser {
  PicBuf* pb;
  SliceParams* sp;
  BitReader r;
  Cabac cab;
  FastCab fc;   // register-resident engine view, live for the whole slice
  int mb_w, mb_h, w4, h4, w2, h2, n;
  int prev_qp_delta = 0;
  const int8_t* zz4;   // inverse-scan tables: frame zigzag or field scan
  const int8_t* zz8;
  int8_t zz8i[4][16];  // CAVLC 8x8 interleave: zz8i[sub][k] = zz8[4k+sub]

  Parser(PicBuf* pb_, SliceParams* sp_, const uint8_t* data, int64_t nbytes,
         int64_t bitpos)
      : pb(pb_), sp(sp_), r(data, nbytes, bitpos) {
    mb_w = pb->mb_w; mb_h = pb->mb_h;
    w4 = mb_w * 4; h4 = mb_h * 4;
    w2 = mb_w * 2; h2 = mb_h * 2;
    n = mb_w * mb_h;
    zz4 = sp->field_pic ? kFieldScan4 : kZigzag4;
    zz8 = sp->field_pic ? kFieldScan8 : kZigzag8;
    for (int sub = 0; sub < 4; sub++)
      for (int k = 0; k < 16; k++) zz8i[sub][k] = zz8[4 * k + sub];
  }

  // ---- grid helpers ----
  inline int32_t& tc_l(int by, int bx) { return pb->tc_luma[by * w4 + bx]; }
  inline int32_t& mode_at(int by, int bx) { return pb->mode_map[by * w4 + bx]; }
  inline int32_t& order_at(int by, int bx) { return pb->order_grid[by * w4 + bx]; }
  inline int32_t smap(int my, int mx) { return pb->slice_map[my * mb_w + mx]; }
  inline int cat_at(int my, int mx) { return pb->cat[my * mb_w + mx]; }

  inline bool mb_avail(int mx, int my) {
    if (mx < 0 || my < 0 || mx >= mb_w || my >= mb_h) return false;
    return smap(my, mx) == sp->slice_id;
  }

  // ---- nC derivation (9.2.1) ----
  int nc_from_luma(int bx, int by) {  // -1 = unavailable
    if (bx < 0 || by < 0) return -1;
    int mx = bx / 4, my = by / 4;
    if (!mb_avail(mx, my)) return -1;
    if (cat_at(my, mx) == CAT_IPCM) return 16;
    return pb->tc_luma[by * w4 + bx];
  }
  int luma_nc(int bx, int by) {
    int na = nc_from_luma(bx - 1, by);
    int nb = nc_from_luma(bx, by - 1);
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    if (na >= 0) return na;
    if (nb >= 0) return nb;
    return 0;
  }
  int nc_from_chroma(int pl, int bx, int by) {
    if (bx < 0 || by < 0) return -1;
    int mx = bx / 2, my = by / 2;
    if (!mb_avail(mx, my)) return -1;
    if (cat_at(my, mx) == CAT_IPCM) return 16;
    const int32_t* m = pl == 0 ? pb->tc_cb : pb->tc_cr;
    return m[by * w2 + bx];
  }
  int chroma_nc(int pl, int bx, int by) {
    int na = nc_from_chroma(pl, bx - 1, by);
    int nb = nc_from_chroma(pl, bx, by - 1);
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    if (na >= 0) return na;
    if (nb >= 0) return nb;
    return 0;
  }

  // ---- CAVLC residual (entropy/cavlc.py) ----
  // Writes ONLY the nonzero levels, each at out[perm[scan_pos]]
  // (perm = inverse-scan table, e.g. zz4 / zz4+1 / zz8); returns
  // total_coeff.  Callers rely on the reset_pic invariant that the
  // target row is all-zero, so skipping the zero positions replaces
  // the old zero-init + full permuted copy (t_scatter, ~9% of parse).
  int cavlc_block(int nc, int max_coeff, int32_t* out,
                  const int8_t* perm) {
    int total_coeff, trailing_ones;
    if (nc == -1) {
      uint32_t p16 = r.peek(16);
      int len = kCoeffTokLen3[p16];
      int val = kCoeffTokVal3[p16];
      if (len == 0) { r.error = true; return 0; }
      r.skip_vlc(len);
      total_coeff = val >> 2; trailing_ones = val & 3;
    } else if (nc < 8) {
      int cls = nc < 2 ? 0 : (nc < 4 ? 1 : 2);
      uint32_t p16 = r.peek(16);
      const int16_t* tv = cls == 0 ? kCoeffTokVal0 : (cls == 1 ? kCoeffTokVal1 : kCoeffTokVal2);
      const int8_t* tl = cls == 0 ? kCoeffTokLen0 : (cls == 1 ? kCoeffTokLen1 : kCoeffTokLen2);
      int len = tl[p16];
      if (len == 0) { r.error = true; return 0; }
      int val = tv[p16];
      r.skip_vlc(len);
      total_coeff = val >> 2; trailing_ones = val & 3;
    } else {
      uint32_t v = r.u(6);
      if (v == 3) { total_coeff = 0; trailing_ones = 0; }
      else { total_coeff = (v >> 2) + 1; trailing_ones = v & 3; }
    }
    if (total_coeff == 0) return 0;

    int32_t lv[64];
    for (int i = 0; i < trailing_ones; i++) lv[i] = r.u1() ? -1 : 1;
    int suffix_length = (total_coeff > 10 && trailing_ones < 3) ? 1 : 0;
    for (int i = trailing_ones; i < total_coeff; i++) {
      int level_prefix = 0;
      while (r.u1() == 0) {
        if (++level_prefix > 32) { r.error = true; return 0; }
      }
      int suffix_size = suffix_length;
      if (level_prefix == 14 && suffix_length == 0) suffix_size = 4;
      else if (level_prefix >= 15) suffix_size = level_prefix - 3;
      int level_code = ((level_prefix < 15 ? level_prefix : 15) << suffix_length);
      if (suffix_size) level_code += (int)r.u(suffix_size);
      if (level_prefix >= 15 && suffix_length == 0) level_code += 15;
      if (level_prefix >= 16) level_code += (1 << (level_prefix - 3)) - 4096;
      if (i == trailing_ones && trailing_ones < 3) level_code += 2;
      lv[i] = (level_code % 2 == 0) ? ((level_code + 2) >> 1)
                                    : -((level_code + 1) >> 1);
      if (suffix_length == 0) suffix_length = 1;
      int a = lv[i] < 0 ? -lv[i] : lv[i];
      if (a > (3 << (suffix_length - 1)) && suffix_length < 6) suffix_length++;
    }

    int total_zeros = 0;
    if (total_coeff < max_coeff) {
      if (max_coeff == 4) {
        uint32_t p = r.peek(3);
        int len = kTzcLen[total_coeff][p];
        if (len == 0) { r.error = true; return 0; }
        total_zeros = kTzcVal[total_coeff][p];
        r.skip_vlc(len);
      } else {
        uint32_t p = r.peek(9);
        int len = kTz4Len[total_coeff][p];
        if (len == 0) { r.error = true; return 0; }
        total_zeros = kTz4Val[total_coeff][p];
        r.skip_vlc(len);
      }
    }

    // spec 9.2.3 bounds; CORRUPT streams violate them (the VLC tables
    // alone don't: run_before's zl>6 codes reach 14 regardless of the
    // actual zeros left) and a negative placement index writes below
    // the caller's coefficient buffer (ASAN fuzz find, 2026-08-19)
    if (total_coeff + total_zeros > max_coeff) { r.error = true; return 0; }

    int runs[64];
    int zeros_left = total_zeros;
    for (int i = 0; i < total_coeff - 1; i++) {
      runs[i] = 0;
      if (zeros_left > 0) {
        int zl = zeros_left < 7 ? zeros_left : 7;
        uint32_t p = r.peek(11);
        int len = kRunLen[zl][p];
        if (len == 0) { r.error = true; return 0; }
        runs[i] = kRunVal[zl][p];
        if (runs[i] > zeros_left) { r.error = true; return 0; }
        r.skip_vlc(len);
      }
      zeros_left -= runs[i];
    }
    runs[total_coeff - 1] = zeros_left;

    int posi = total_coeff + total_zeros - 1;
    for (int i = 0; i < total_coeff; i++) {
      out[perm[posi]] = lv[i];
      posi -= runs[i] + 1;
    }
    return total_coeff;
  }

  // ---- CABAC neighbor ctx helpers (mb/cabac_parse.py) ----
  inline int nb_cat(int mx, int my) {  // -1 = unavailable
    if (!mb_avail(mx, my)) return -1;
    return cat_at(my, mx);
  }
  int skip_inc(int mx, int my) {
    int inc = 0;
    int a = nb_cat(mx - 1, my), b = nb_cat(mx, my - 1);
    if (a >= 0 && a != CAT_PSKIP && a != CAT_BSKIP) inc++;
    if (b >= 0 && b != CAT_PSKIP && b != CAT_BSKIP) inc++;
    return inc;
  }
  int imbtype_inc(int mx, int my) {
    int inc = 0;
    int a = nb_cat(mx - 1, my), b = nb_cat(mx, my - 1);
    if (a >= 0 && a != CAT_I4 && a != CAT_I8) inc++;
    if (b >= 0 && b != CAT_I4 && b != CAT_I8) inc++;
    return inc;
  }
  int bmbtype_inc(int mx, int my) {
    int inc = 0;
    int a = nb_cat(mx - 1, my), b = nb_cat(mx, my - 1);
    if (a >= 0 && a != CAT_BSKIP && a != CAT_BDIR16) inc++;
    if (b >= 0 && b != CAT_BSKIP && b != CAT_BDIR16) inc++;
    return inc;
  }
  int tr8_inc(int mx, int my) {
    int inc = 0;
    if (mb_avail(mx - 1, my) && pb->tr8[my * mb_w + mx - 1]) inc++;
    if (mb_avail(mx, my - 1) && pb->tr8[(my - 1) * mb_w + mx]) inc++;
    return inc;
  }
  int chroma_mode_inc(int mx, int my) {
    int inc = 0;
    for (int k = 0; k < 2; k++) {
      int nx = k == 0 ? mx - 1 : mx, ny = k == 0 ? my : my - 1;
      int c = nb_cat(nx, ny);
      if (c >= 0 && cat_is_intra(c) && c != CAT_IPCM &&
          pb->chroma_mode[ny * mb_w + nx] != 0)
        inc++;
    }
    return inc;
  }

  int cab_qp_delta() {
    if (!fc.dec(60 + (prev_qp_delta ? 1 : 0))) {
      prev_qp_delta = 0;
      return 0;
    }
    int k = 1;
    while (fc.dec(k == 1 ? 62 : 63)) {
      k++;
      if (k > 2048) { fc.err = true; return 0; }
    }
    int delta = (k & 1) ? ((k + 1) >> 1) : -(k >> 1);
    prev_qp_delta = delta;
    return delta;
  }
  int cab_chroma_mode(int mx, int my) {
    if (!fc.dec(64 + chroma_mode_inc(mx, my))) return 0;
    int k = 0;
    while (k < 2 && fc.dec(67)) k++;
    return 1 + k;
  }
  int cab_intra4x4_mode(int pred) {
    if (fc.dec(68)) return pred;
    int rem = fc.dec(69);
    rem |= fc.dec(69) << 1;
    rem |= fc.dec(69) << 2;
    return rem < pred ? rem : rem + 1;
  }
  void cab_cbp(int mx, int my, int* cbp_l_out, int* cbp_c_out) {
    int ca = nb_cat(mx - 1, my), cb_ = nb_cat(mx, my - 1);
    auto l_bit = [&](int c, int nx, int ny, int b8) -> int {
      if (c < 0) return 1;
      if (c == CAT_IPCM) return 1;
      if (c == CAT_PSKIP || c == CAT_BSKIP) return 0;
      return (pb->cbp[(ny * mb_w + nx) * 2] >> b8) & 1;
    };
    int cbp_l = 0;
    for (int b8 = 0; b8 < 4; b8++) {
      int x8 = b8 & 1, y8 = b8 >> 1;
      int a = x8 == 0 ? l_bit(ca, mx - 1, my, y8 * 2 + 1)
                      : ((cbp_l >> (y8 * 2)) & 1);
      int b = y8 == 0 ? l_bit(cb_, mx, my - 1, 2 + x8) : ((cbp_l >> x8) & 1);
      int ctx = 73 + (1 - a) + 2 * (1 - b);
      if (fc.dec(ctx)) cbp_l |= 1 << b8;
    }
    auto c_val = [&](int c, int nx, int ny) -> int {
      if (c < 0) return 0;
      if (c == CAT_IPCM) return 2;
      if (c == CAT_PSKIP || c == CAT_BSKIP) return 0;
      return pb->cbp[(ny * mb_w + nx) * 2 + 1];
    };
    int va = c_val(ca, mx - 1, my), vb = c_val(cb_, mx, my - 1);
    int cbp_c = 0;
    if (fc.dec(77 + (va ? 1 : 0) + 2 * (vb ? 1 : 0)))
      cbp_c = fc.dec(81 + (va == 2 ? 1 : 0) + 2 * (vb == 2 ? 1 : 0)) ? 2 : 1;
    *cbp_l_out = cbp_l;
    *cbp_c_out = cbp_c;
  }

  // ---- motion neighbor access (mb/parse.py) ----
  struct NB { bool av; int ref; int mvx, mvy; };
  NB mv_neighbor(int lst, int px, int py, int cur_key) {
    NB o{false, -1, 0, 0};
    if (px < 0 || py < 0 || px >= mb_w * 16 || py >= mb_h * 16) return o;
    int bx = px >> 2, by = py >> 2;
    if (!(order_at(by, bx) < cur_key)) return o;
    if (smap(by / 4, bx / 4) != sp->slice_id) return o;
    o.av = true;
    int ref = pb->ref_grid[lst * h4 * w4 + by * w4 + bx];
    if (ref < 0) return o;  // intra / unused list: av, ref -1, mv 0
    o.ref = ref;
    const int32_t* mg = pb->mv_grid + ((lst * h4 + by) * w4 + bx) * 2;
    o.mvx = mg[0]; o.mvy = mg[1];
    return o;
  }

  static inline int med3(int a, int b, int c) {
    if (a > b) { int t = a; a = b; b = t; }
    if (b > c) { b = c; }
    return a > b ? a : b;
  }

  void predict_mv(int lst, int ref_idx, int x0, int y0, int w, int h,
                  int part_kind, int cur_key, int* outx, int* outy) {
    NB A = mv_neighbor(lst, x0 - 1, y0, cur_key);
    NB B = mv_neighbor(lst, x0, y0 - 1, cur_key);
    NB C = mv_neighbor(lst, x0 + w, y0 - 1, cur_key);
    if (!C.av) C = mv_neighbor(lst, x0 - 1, y0 - 1, cur_key);
    if (part_kind == 1 && B.ref == ref_idx) { *outx = B.mvx; *outy = B.mvy; return; }
    if (part_kind == 2 && A.ref == ref_idx) { *outx = A.mvx; *outy = A.mvy; return; }
    if (part_kind == 3 && A.ref == ref_idx) { *outx = A.mvx; *outy = A.mvy; return; }
    if (part_kind == 4 && C.ref == ref_idx) { *outx = C.mvx; *outy = C.mvy; return; }
    if (!B.av && !C.av && A.av) { *outx = A.mvx; *outy = A.mvy; return; }
    int hits = (A.ref == ref_idx) + (B.ref == ref_idx) + (C.ref == ref_idx);
    if (hits == 1) {
      if (A.ref == ref_idx) { *outx = A.mvx; *outy = A.mvy; return; }
      if (B.ref == ref_idx) { *outx = B.mvx; *outy = B.mvy; return; }
      *outx = C.mvx; *outy = C.mvy; return;
    }
    *outx = med3(A.mvx, B.mvx, C.mvx);
    *outy = med3(A.mvy, B.mvy, C.mvy);
  }

  void skip_mv(int x0, int y0, int* outx, int* outy) {
    NB A = mv_neighbor(0, x0 - 1, y0, 0);
    NB B = mv_neighbor(0, x0, y0 - 1, 0);
    if (!A.av || !B.av || (A.ref == 0 && A.mvx == 0 && A.mvy == 0) ||
        (B.ref == 0 && B.mvx == 0 && B.mvy == 0)) {
      *outx = 0; *outy = 0; return;
    }
    predict_mv(0, 0, x0, y0, 16, 16, 0, 0, outx, outy);
  }

  void set_part(int addr, int lst, int x0, int y0, int w, int h, int ref,
                int mvx, int mvy) {
    int bx0 = x0 >> 2, by0 = y0 >> 2;
    // resolve ref idx -> device DPB slot / picture uid once per partition
    // (the ABI refslot/refid arrays used to be filled in Python per frame)
    int slot = -1, uid = -1;
    if (ref >= 0) {
      int len = lst == 0 ? sp->l0_len : sp->l1_len;
      if (ref < len) {
        const int32_t* slots = lst == 0 ? sp->l0_slot : sp->l1_slot;
        const int32_t* uids = lst == 0 ? sp->l0_uid : sp->l1_uid;
        if (slots) slot = slots[ref];
        if (uids) uid = uids[ref];
      }
    }
    for (int by = by0; by < by0 + (h >> 2); by++)
      for (int bx = bx0; bx < bx0 + (w >> 2); bx++) {
        pb->ref_grid[lst * h4 * w4 + by * w4 + bx] = ref;
        int32_t* mg = pb->mv_grid + ((lst * h4 + by) * w4 + bx) * 2;
        mg[0] = mvx; mg[1] = mvy;
        // MB record arrays
        int my = by / 4, mx = bx / 4;
        int ly = by & 3, lx = bx & 3;
        int64_t cell = ((int64_t)(my * mb_w + mx) * 4 + ly) * 4 + lx;
        int32_t* mvp = pb->mv + (cell * 2 + lst) * 2;
        mvp[0] = mvx; mvp[1] = mvy;
        pb->refidx[cell * 2 + lst] = ref;
        pb->refslot[cell * 2 + lst] = slot;
        pb->refid[cell * 2 + lst] = uid;
        (void)addr;
      }
  }

  inline void assign_key(int x0, int y0, int w, int h, int key) {
    int bx0 = x0 >> 2, by0 = y0 >> 2;
    for (int by = by0; by < by0 + (h >> 2); by++)
      for (int bx = bx0; bx < bx0 + (w >> 2); bx++) order_at(by, bx) = key;
  }
  inline void finish_mb_keys(int mx, int my) {
    for (int by = my * 4; by < my * 4 + 4; by++)
      for (int bx = mx * 4; bx < mx * 4 + 4; bx++) order_at(by, bx) = -1;
  }
  static void sub_part_xy(int sx0, int sy0, int sw, int sh, int s, int* px,
                          int* py) {
    if (sw == 8 && sh == 8) { *px = sx0; *py = sy0; }
    else if (sw == 8) { *px = sx0; *py = sy0 + s * 4; }
    else if (sh == 8) { *px = sx0 + s * 4; *py = sy0; }
    else { *px = sx0 + (s % 2) * 4; *py = sy0 + (s / 2) * 4; }
  }

  // ---- direct modes (mb/parse.py fill_direct) ----
  static inline int min_positive(int a, int b) {
    if (a >= 0 && b >= 0) return a < b ? a : b;
    return a > b ? a : b;
  }

  void direct_spatial_ctx(int mx, int my, int* ref0o, int* ref1o,
                          int* m0x, int* m0y, int* m1x, int* m1y,
                          int* zero_pred) {
    int x0 = mx * 16, y0 = my * 16;
    int refs[2];
    for (int lst = 0; lst < 2; lst++) {
      NB A = mv_neighbor(lst, x0 - 1, y0, 0);
      NB B = mv_neighbor(lst, x0, y0 - 1, 0);
      NB C = mv_neighbor(lst, x0 + 16, y0 - 1, 0);
      if (!C.av) C = mv_neighbor(lst, x0 - 1, y0 - 1, 0);
      refs[lst] = min_positive(min_positive(A.ref, B.ref), C.ref);
    }
    *zero_pred = (refs[0] < 0 && refs[1] < 0) ? 1 : 0;
    if (*zero_pred) { refs[0] = 0; refs[1] = 0; }
    if (refs[0] >= 0) predict_mv(0, refs[0], x0, y0, 16, 16, 0, 0, m0x, m0y);
    else { *m0x = 0; *m0y = 0; }
    if (refs[1] >= 0) predict_mv(1, refs[1], x0, y0, 16, 16, 0, 0, m1x, m1y);
    else { *m1x = 0; *m1y = 0; }
    *ref0o = refs[0]; *ref1o = refs[1];
  }

  void col_block(int mx, int my, int y4, int x4, int* cmx, int* cmy,
                 int* crefidx, int* cuid) {
    if (pb->direct_8x8_inference) {
      y4 = 3 * (y4 / 2);
      x4 = 3 * (x4 / 2);
    }
    int by = my * 4 + y4, bx = mx * 4 + x4;
    if (!sp->col_mv) { *cmx = 0; *cmy = 0; *crefidx = -1; *cuid = -1; return; }
    *cmx = sp->col_mv[(by * w4 + bx) * 2];
    *cmy = sp->col_mv[(by * w4 + bx) * 2 + 1];
    *crefidx = sp->col_refidx[by * w4 + bx];
    *cuid = sp->col_ref_uid[by * w4 + bx];
  }

  void fill_direct(int addr, int mx, int my, const int* cells, int ncells) {
    static const int all_cells[32] = {0, 0, 0, 1, 0, 2, 0, 3, 1, 0, 1, 1, 1, 2,
                                      1, 3, 2, 0, 2, 1, 2, 2, 2, 3, 3, 0, 3, 1,
                                      3, 2, 3, 3};
    if (!cells) { cells = all_cells; ncells = 16; }
    for (int c = 0; c < ncells; c++)
      pb->direct_grid[(my * 4 + cells[2 * c]) * w4 + mx * 4 + cells[2 * c + 1]] = 1;
    if (sp->direct_spatial) {
      int ref0, ref1, m0x, m0y, m1x, m1y, zp;
      direct_spatial_ctx(mx, my, &ref0, &ref1, &m0x, &m0y, &m1x, &m1y, &zp);
      for (int c = 0; c < ncells; c++) {
        int y4 = cells[2 * c], x4 = cells[2 * c + 1];
        int cmx, cmy, cref, cuid;
        col_block(mx, my, y4, x4, &cmx, &cmy, &cref, &cuid);
        bool col_zero = !sp->col_longterm && cref == 0 &&
                        cmx >= -1 && cmx <= 1 && cmy >= -1 && cmy <= 1;
        for (int lst = 0; lst < 2; lst++) {
          int ref = lst == 0 ? ref0 : ref1;
          int vx, vy;
          if (ref < 0) { vx = 0; vy = 0; }
          else if (zp || (ref == 0 && col_zero)) { vx = 0; vy = 0; }
          else if (lst == 0) { vx = m0x; vy = m0y; }
          else { vx = m1x; vy = m1y; }
          set_part(addr, lst, mx * 16 + 4 * x4, my * 16 + 4 * y4, 4, 4, ref,
                   vx, vy);
        }
      }
    } else {
      for (int c = 0; c < ncells; c++) {
        int y4 = cells[2 * c], x4 = cells[2 * c + 1];
        int cmx, cmy, cref, cuid;
        col_block(mx, my, y4, x4, &cmx, &cmy, &cref, &cuid);
        int ref0 = 0;
        if (cref < 0) { cmx = 0; cmy = 0; }
        else {
          ref0 = 0;
          for (int i = 0; i < sp->l0_len; i++)
            if (sp->l0_uid[i] == cuid) { ref0 = i; break; }
        }
        int px = mx * 16 + 4 * x4, py = my * 16 + 4 * y4;
        int m0x, m0y, m1x, m1y;
        if (sp->l0_lt[ref0] || sp->col_poc == sp->l0_poc[ref0]) {
          m0x = cmx; m0y = cmy; m1x = 0; m1y = 0;
        } else {
          int tb = sp->cur_poc - sp->l0_poc[ref0];
          if (tb < -128) tb = -128; if (tb > 127) tb = 127;
          int td = sp->col_poc - sp->l0_poc[ref0];
          if (td < -128) td = -128; if (td > 127) td = 127;
          int tx = td > 0 ? (16384 + (td >> 1)) / td
                          : -((16384 + ((-td) >> 1)) / (-td));
          // match python: tx = (16384 + (abs(td) >> 1)) // td  (floor div)
          {
            long long num = 16384 + ((td < 0 ? -td : td) >> 1);
            long long q = num / td;
            if ((num % td != 0) && ((num < 0) != (td < 0))) q -= 1;
            tx = (int)q;
          }
          long long dsfl = ((long long)tb * tx + 32) >> 6;
          if (dsfl < -1024) dsfl = -1024; if (dsfl > 1023) dsfl = 1023;
          int dsf = (int)dsfl;
          m0x = (int)(((long long)dsf * cmx + 128) >> 8);
          m0y = (int)(((long long)dsf * cmy + 128) >> 8);
          m1x = m0x - cmx; m1y = m0y - cmy;
        }
        set_part(addr, 0, px, py, 4, 4, ref0, m0x, m0y);
        set_part(addr, 1, px, py, 4, 4, 0, m1x, m1y);
      }
    }
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// wire-format scan helper (ops/wire.py): find nonzero rows of a dense
// int32 coefficient matrix and gather them as int16 in one pass.  numpy
// needs ~16 ms/frame for the same scans at 1080p; this runs at memory
// speed on the parse thread.
// Returns the TOTAL number of nonzero rows (may exceed cap; writing
// stops at cap — the caller falls back to the dense wire encoding).
// *overflow is set if any gathered value doesn't fit int16.
extern "C" long h264e_scan_rows32(const int32_t* src, long rows, int cols,
                                  int32_t* idx, int16_t* vals, long cap,
                                  int* overflow) {
  long k = 0;
  int ovf = 0;
  for (long r = 0; r < rows; r++) {
    const int32_t* p = src + (long)r * cols;
    int32_t acc = 0;
    for (int c = 0; c < cols; c++) acc |= p[c];
    if (H264E_LIKELY(acc == 0)) continue;
    if (k < cap) {
      idx[k] = (int32_t)r;
      int16_t* v = vals + k * cols;
      for (int c = 0; c < cols; c++) {
        int32_t x = p[c];
        if (H264E_UNLIKELY(x < -32768 || x > 32767)) ovf = 1;
        v[c] = (int16_t)x;
      }
    }
    k++;
  }
  *overflow = ovf;
  return k;
}

// One row of a bitmap+packed class (wire v3): a nonzero row of `cols`
// values at p is emitted as (row index r, per-16-lane significance
// bitmaps, nonzero values packed contiguously as int8) while fewer than
// cap_r rows / cap_v values were written, and counted in k / nv either
// way.  *ovf is set when a value misses int8.  Returns whether the row is
// nonzero.  Shrinks a sparse 4x4 coefficient block from 36 wire bytes to
// ~6 + nnz.
namespace {
H264E_INLINE bool bm8_row(const int32_t* p, int cols, int32_t r,
                          int32_t* idx, uint16_t* bm, int8_t* vals,
                          long cap_r, long cap_v, long& k, long& nv,
                          int& ovf) {
  int32_t acc = 0;
  for (int c = 0; c < cols; c++) acc |= p[c];
  if (acc == 0) return false;
  if (k < cap_r) {
    const int bmw = (cols + 15) / 16;
    idx[k] = r;
    uint16_t* b = bm + k * bmw;
    uint32_t wide = 0;
    for (int g = 0; g < bmw; g++) {
      const int32_t* q = p + g * 16;
      const int lim = cols - g * 16 < 16 ? cols - g * 16 : 16;
      uint32_t m = 0;
      for (int c = 0; c < lim; c++) m |= (uint32_t)(q[c] != 0) << c;
      b[g] = (uint16_t)m;
      for (; m; m &= m - 1) {            // the nonzero values, in order
        const int32_t x = q[__builtin_ctz(m)];
        wide |= (uint32_t)x + 128u > 255u;
        if (nv < cap_v) vals[nv] = (int8_t)x;
        nv++;
      }
    }
    ovf |= wide != 0;
  }
  k++;
  return true;
}
}  // namespace

// Bitmap+packed scan of a dense int32 matrix: bm8_row over every row.
// The caller falls back to a dense encoding when either cap or the int8
// range overflows.  Returns total nonzero rows; *nnz_total gets the
// number of values written.
extern "C" long h264e_scan_blocks8(const int32_t* src, long rows, int cols,
                                   int32_t* idx, uint16_t* bm, int8_t* vals,
                                   long cap_r, long cap_v,
                                   long* nnz_total, int* overflow) {
  long k = 0, nv = 0;
  int ovf = 0;
  for (long r = 0; r < rows; r++)
    bm8_row(src + r * cols, cols, (int32_t)r, idx, bm, vals, cap_r, cap_v,
            k, nv, ovf);
  *nnz_total = nv;
  *overflow = ovf | (nv > cap_v);
  return k;
}

// Hinted variant of h264e_scan_blocks8: visit only the rows the parser
// recorded at decode time (PicBuf::nzr_*) instead of scanning the whole
// dense array.  Rows must be strictly ascending and in range (in-order
// slices produce that; ASO does not) — otherwise returns -1 and the
// caller falls back to the full scan.  All-zero listed rows (e.g. a
// concealed MB whose partial parse state was wiped) are skipped, so the
// output is byte-identical to the full scan's.
extern "C" long h264e_gather_blocks8(const int32_t* src, long rows, int cols,
                                     const int32_t* ridx, long nr,
                                     int32_t* idx, uint16_t* bm, int8_t* vals,
                                     long cap_r, long cap_v,
                                     long* nnz_total, int* overflow) {
  long k = 0, nv = 0;
  int ovf = 0;
  int32_t prev = -1;
  for (long i = 0; i < nr; i++) {
    int32_t r = ridx[i];
    if (H264E_UNLIKELY(r <= prev || r >= rows)) return -1;
    prev = r;
    bm8_row(src + (long)r * cols, cols, r, idx, bm, vals, cap_r, cap_v, k,
            nv, ovf);
  }
  *nnz_total = nv;
  *overflow = ovf | (nv > cap_v);
  return k;
}

// Inter-field uniformity scan (wire v3).  mv [n,16,2,2] i32, refidx /
// refslot [n,16,2] i32.  A row is "uniform" when all 16 cells carry
// cell 0's mv+refidx+refslot for both lists (16x16 / skip MBs — the
// overwhelming majority).  Emits per-MB bases (mv_base [n,4] i16,
// ref_base [n,4] i8) plus a sparse list of non-uniform rows in the
// dense layouts (mv64 [cap,64] i16; ref64 [cap,64] i8 = refidx|refslot).
// Returns total non-uniform rows (may exceed cap -> caller goes dense).
extern "C" long h264e_scan_inter(const int32_t* mv, const int32_t* refidx,
                                 const int32_t* refslot, long n,
                                 int16_t* mv_base, int8_t* ref_base,
                                 int32_t* idx, int16_t* mv_nu,
                                 int8_t* ref_nu, long cap) {
  long k = 0;
  for (long r = 0; r < n; r++) {
    const int32_t* m = mv + r * 64;
    const int32_t* ri = refidx + r * 32;
    const int32_t* rs = refslot + r * 32;
    mv_base[r * 4 + 0] = (int16_t)m[0];
    mv_base[r * 4 + 1] = (int16_t)m[1];
    mv_base[r * 4 + 2] = (int16_t)m[2];
    mv_base[r * 4 + 3] = (int16_t)m[3];
    ref_base[r * 4 + 0] = (int8_t)ri[0];
    ref_base[r * 4 + 1] = (int8_t)ri[1];
    ref_base[r * 4 + 2] = (int8_t)rs[0];
    ref_base[r * 4 + 3] = (int8_t)rs[1];
    int32_t diff = 0;
    for (int c = 1; c < 16; c++) {
      diff |= (m[c * 4 + 0] ^ m[0]) | (m[c * 4 + 1] ^ m[1]) |
              (m[c * 4 + 2] ^ m[2]) | (m[c * 4 + 3] ^ m[3]);
      diff |= (ri[c * 2 + 0] ^ ri[0]) | (ri[c * 2 + 1] ^ ri[1]);
      diff |= (rs[c * 2 + 0] ^ rs[0]) | (rs[c * 2 + 1] ^ rs[1]);
    }
    if (H264E_LIKELY(diff == 0)) continue;
    if (k < cap) {
      idx[k] = (int32_t)r;
      int16_t* mo = mv_nu + k * 64;
      for (int c = 0; c < 64; c++) mo[c] = (int16_t)m[c];
      int8_t* ro = ref_nu + k * 64;
      for (int c = 0; c < 32; c++) ro[c] = (int8_t)ri[c];
      for (int c = 0; c < 32; c++) ro[32 + c] = (int8_t)rs[c];
    }
    k++;
  }
  return k;
}

// ---------------------------------------------------------------------------
// Colocated motion for temporal-direct (centropy.build_col_motion): pick
// per 4x4 block the list-0 motion if referenced, else list-1, and map the
// refidx to a picture uid via the per-slice uid table.  The numpy version
// ran ~7 ms of GIL-held np.where over the [h4,w4] grids per stored
// reference picture; this runs GIL-released on the parse thread.
//
// ref_grid [2,h4,w4] i32, mv_grid [2,h4,w4,2] i32, slice_id_mb [mb_h,mb_w]
// i32, uid_tab [n_slices,2,32] i32 (-1 padded).  Outputs: col_mv [h4,w4,2]
// i32, col_ref [h4,w4] i8, col_uid [h4,w4] i32.
extern "C" void h264e_build_col(
    const int32_t* ref_grid, const int32_t* mv_grid,
    const int32_t* slice_id_mb, const int32_t* uid_tab, int n_slices,
    int mb_w, int mb_h, int32_t* col_mv, int8_t* col_ref,
    int32_t* col_uid) {
  const int h4 = mb_h * 4, w4 = mb_w * 4;
  const long plane = (long)h4 * w4;
  for (int by = 0; by < h4; by++) {
    const int32_t* r0 = ref_grid + (long)by * w4;
    const int32_t* r1 = ref_grid + plane + (long)by * w4;
    const int32_t* m0 = mv_grid + ((long)by * w4) * 2;
    const int32_t* m1 = mv_grid + (plane + (long)by * w4) * 2;
    const int32_t* sid_row = slice_id_mb + (long)(by / 4) * mb_w;
    int32_t* omv = col_mv + ((long)by * w4) * 2;
    int8_t* oref = col_ref + (long)by * w4;
    int32_t* ouid = col_uid + (long)by * w4;
    for (int bx = 0; bx < w4; bx++) {
      int lst, ref;
      if (r0[bx] >= 0) { lst = 0; ref = r0[bx]; }
      else if (r1[bx] >= 0) { lst = 1; ref = r1[bx]; }
      else {
        omv[2 * bx] = 0; omv[2 * bx + 1] = 0;
        oref[bx] = -1; ouid[bx] = -1;
        continue;
      }
      const int32_t* m = lst ? m1 : m0;
      omv[2 * bx] = m[2 * bx];
      omv[2 * bx + 1] = m[2 * bx + 1];
      oref[bx] = (int8_t)ref;
      int sid = sid_row[bx / 4];
      ouid[bx] = (sid >= 0 && sid < n_slices && ref < 32)
                     ? uid_tab[((long)sid * 2 + lst) * 32 + ref]
                     : -1;
    }
  }
}

// ---------------------------------------------------------------------------
// Per-frame MC-variant selection (models/pipeline.select_inter_mode).
// The Pallas MC kernel requires MVs inside its slab window, <= max_slots
// distinct DPB slots, and <= cap distinct (slot, mv_int) candidates per
// 16-row band; violating cells are evicted into `patch` (repaired on
// device by the gather pass).  The numpy version loops np.unique over
// every band (68 at 1080p) on the GIL; this runs on the parse thread.
//
// kind [n] i32, mv [n,4,4,2,2] i32, refslot [n,4,4,2] i32 (ABI layout).
// Returns mode: 0=none, 1=pl0, 2=pl01, 3=gather.  slot_list [max_slots]
// gets the kept DPB slots ascending (-1 padded); patch [patch_cap] the
// evicted flat cell ids (mb*16+cell, -1 padded); *n_patch their count.
// Tie-breaks match the numpy oracle's kind="stable" argsorts exactly
// (differential-tested), though any kept subset decodes correctly.
extern "C" int h264e_select_inter_mode(
    const int32_t* kind, const int32_t* mv, const int32_t* refslot,
    long n, int mb_w, int mb_h, int max_slots, int cap,
    int dx_min, int dx_max, int dy_min, int dy_max,
    long patch_cap, int32_t* slot_list, int32_t* patch, long* n_patch) {
  *n_patch = 0;
  for (int i = 0; i < max_slots; i++) slot_list[i] = -1;
  bool any_inter = false;
  for (long r = 0; r < n; r++)
    if (kind[r] >= CAT_P) { any_inter = true; break; }
  if (!any_inter) return 0;

  std::vector<uint8_t> viol((size_t)n * 16, 0);
  bool use_l1 = false;
  // (a) envelope violations + slot usage counts (over ALL used cells,
  // matching np.unique(refslot[used])).  Flat-array counting: device
  // DPB slots are small nonneg ints; a std::map here cost ~2 ms/frame
  // at 1080p (260k lookups).
  constexpr int kSlotCap = 1024;
  std::vector<long> slot_count_arr(kSlotCap, 0);
  std::map<int32_t, long> slot_count;  // overflow fallback (slot >= cap)
  for (long r = 0; r < n; r++) {
    const int32_t* m = mv + r * 64;
    const int32_t* rs = refslot + r * 32;
    for (int c = 0; c < 16; c++) {
      for (int l = 0; l < 2; l++) {
        int32_t s = rs[c * 2 + l];
        if (s < 0) continue;
        if (l == 1) use_l1 = true;
        if (H264E_LIKELY(s < kSlotCap)) slot_count_arr[s]++;
        else slot_count[s]++;
        int32_t dx = m[c * 4 + l * 2 + 0] >> 2;
        int32_t dy = m[c * 4 + l * 2 + 1] >> 2;
        if (dx < dx_min || dx > dx_max || dy < dy_min || dy > dy_max)
          viol[r * 16 + c] = 1;
      }
    }
  }
  for (int s2 = 0; s2 < kSlotCap; s2++)
    if (slot_count_arr[s2]) slot_count[s2] = slot_count_arr[s2];
  // (b) slot pressure: keep the max_slots most-referenced slots
  // (stable by ascending slot among count ties)
  std::vector<std::pair<int32_t, long>> sc(slot_count.begin(),
                                           slot_count.end());
  if ((long)sc.size() > max_slots) {
    std::stable_sort(sc.begin(), sc.end(),
                     [](const std::pair<int32_t, long>& a,
                        const std::pair<int32_t, long>& b) {
                       return a.second > b.second;
                     });
    sc.resize(max_slots);
    std::sort(sc.begin(), sc.end());
    for (long r = 0; r < n; r++) {
      const int32_t* rs = refslot + r * 32;
      for (int c = 0; c < 16; c++) {
        if (viol[r * 16 + c]) continue;
        for (int l = 0; l < 2; l++) {
          int32_t s = rs[c * 2 + l];
          if (s < 0) continue;
          bool kept = false;
          for (auto& p : sc) kept |= (p.first == s);
          if (!kept) { viol[r * 16 + c] = 1; break; }
        }
      }
    }
  }
  // slot -> kernel index k (ascending slot order, as numpy sorts);
  // flat array (same rationale as slot_count_arr)
  std::map<int32_t, int32_t> kmap;
  std::vector<int32_t> karr(kSlotCap, -1);
  for (size_t i = 0; i < sc.size(); i++) {
    slot_list[i] = sc[i].first;
    kmap[sc[i].first] = (int32_t)i;
    if (sc[i].first < kSlotCap) karr[sc[i].first] = (int32_t)i;
  }
  auto kidx = [&](int32_t s2) -> int32_t {
    return H264E_LIKELY(s2 < kSlotCap) ? karr[s2] : kmap[s2];
  };
  // (c) per-band candidate-cap overflow: evict rarest candidates
  // (stable by ascending candidate value among count ties)
  std::vector<int32_t> cands;
  std::vector<int32_t> evicted;
  for (int band = 0; band < mb_h; band++) {
    cands.clear();
    const long r0 = (long)band * mb_w, r1 = r0 + mb_w;
    for (long r = r0; r < r1; r++) {
      const int32_t* m = mv + r * 64;
      const int32_t* rs = refslot + r * 32;
      for (int c = 0; c < 16; c++) {
        if (viol[r * 16 + c]) continue;
        for (int l = 0; l < 2; l++) {
          int32_t s = rs[c * 2 + l];
          if (s < 0) continue;
          int32_t dx = m[c * 4 + l * 2 + 0] >> 2;
          int32_t dy = m[c * 4 + l * 2 + 1] >> 2;
          cands.push_back((kidx(s) << 13) | ((dy + 32) << 7) | (dx + 48));
        }
      }
    }
    if (cands.empty()) continue;
    std::sort(cands.begin(), cands.end());
    // run-length the sorted values -> unique (value, count) ascending
    std::vector<std::pair<int32_t, long>> uc;
    for (size_t i = 0; i < cands.size();) {
      size_t j = i;
      while (j < cands.size() && cands[j] == cands[i]) j++;
      uc.push_back({cands[i], (long)(j - i)});
      i = j;
    }
    if ((long)uc.size() <= cap) continue;
    std::stable_sort(uc.begin(), uc.end(),
                     [](const std::pair<int32_t, long>& a,
                        const std::pair<int32_t, long>& b) {
                       return a.second < b.second;
                     });
    evicted.clear();
    for (long i = 0; i < (long)uc.size() - cap; i++)
      evicted.push_back(uc[i].first);
    std::sort(evicted.begin(), evicted.end());
    for (long r = r0; r < r1; r++) {
      const int32_t* m = mv + r * 64;
      const int32_t* rs = refslot + r * 32;
      for (int c = 0; c < 16; c++) {
        if (viol[r * 16 + c]) continue;
        for (int l = 0; l < 2; l++) {
          int32_t s = rs[c * 2 + l];
          if (s < 0) continue;
          int32_t dx = m[c * 4 + l * 2 + 0] >> 2;
          int32_t dy = m[c * 4 + l * 2 + 1] >> 2;
          int32_t v = (kidx(s) << 13) | ((dy + 32) << 7) | (dx + 48);
          if (std::binary_search(evicted.begin(), evicted.end(), v)) {
            viol[r * 16 + c] = 1;
            break;
          }
        }
      }
    }
  }
  // compact the evicted cells into the patch list
  long k = 0;
  for (long i = 0; i < n * 16; i++) {
    if (!viol[i]) continue;
    if (k < patch_cap) patch[k] = (int32_t)i;
    k++;
  }
  if (k > patch_cap) {
    *n_patch = 0;
    for (long i = 0; i < patch_cap; i++) patch[i] = -1;
    return 3;
  }
  *n_patch = k;
  return use_l1 ? 2 : 1;
}

// continued in entropy_mb.inc (macroblock layer + slice loop)
#include "entropy_mb.inc"
// the wire pack (ops/wire.py::pack_wire_raw)
#include "entropy_wire.inc"
