// Accounting for the host stitcher: per thread, the time and work inside
// stitch_chain and inside the DP primitives it calls.
//
// The library links with -Wl,--wrap=<name> for the four DP primitives
// below, so every call that stitch.cpp (and align_eq.cpp's nw_align, for
// its traceback) makes to one of them goes through the __wrap_ version
// here; the exported symbols that ctypes callers bind stay the real
// ones.  lf_stitch_chain_timed has stitch_chain's exact signature and is
// what the Python loader binds as stitch_chain (native/__init__.py).
//
// lf_trace_begin(acc) arms this thread's accounting into a caller's int64
// array of lf_trace_fields() entries (the Field order below);
// lf_trace_end() disarms it.  Only calls made inside an armed
// stitch_chain are counted, and a wrapped DP that runs inside another
// (nw_align's edlib_band_path) counts as part of the outer one, so the
// fields' times never overlap.  Disarmed, each wrapper is one test and a
// call.

#include <cstdint>
#include <ctime>

namespace {

enum Field {
  NATIVE_NS,         // inside stitch_chain
  WINDOWS,           // stitch_chain calls
  OVERFLOW,          // of them returning < 0 (record or string buffers
                     // too small: the caller's Python fallback)
  REBUILD_NS,        // inside edlib_band_path: a known gap's path
  REBUILDS,          // edlib_band_path calls
  REBUILD_FALLBACK,  // of them returning non-zero (nw_align follows)
  LOCAL_NS,          // inside nw_align, shw_best_end, sw_extend
  LOCAL_DPS,         // their calls
  LOCAL_CELLS,       // their query x target cells
  N_FIELDS
};

thread_local int64_t* t_armed = nullptr;  // set by lf_trace_begin
thread_local int64_t* t_acc = nullptr;    // t_armed inside stitch_chain

inline int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

// Opens the accounting of one wrapped call: the caller's accumulator,
// cleared for the call's duration so that nested wrapped calls pass
// straight through.
struct Span {
  int64_t* acc;
  int64_t t0;
  Span() : acc(t_acc), t0(0) {
    if (acc) {
      t_acc = nullptr;
      t0 = now_ns();
    }
  }
  void close(Field ns_field) {
    acc[ns_field] += now_ns() - t0;
    t_acc = acc;
  }
};

}  // namespace

extern "C" {

int64_t __real_nw_align(const uint8_t* q, int64_t ql, const uint8_t* t,
                        int64_t tl, uint8_t* moves, int64_t* moves_len);
int __real_edlib_band_path(const uint8_t* q, int64_t ql, const uint8_t* t,
                           int64_t tl, int64_t k, uint8_t* moves,
                           int64_t* moves_len);
int64_t __real_shw_best_end(const uint8_t* q, int64_t ql, const uint8_t* t,
                            int64_t tl, int64_t* end_out);
int32_t __real_sw_extend(int32_t qlen, const uint8_t* query, int32_t tlen,
                         const uint8_t* target, int32_t m, const int8_t* mat,
                         int32_t o_del, int32_t e_del, int32_t o_ins,
                         int32_t e_ins, int32_t w, int32_t end_bonus,
                         int32_t zdrop, int32_t h0, int32_t* qle,
                         int32_t* tle, int32_t* gtle, int32_t* gscore_out,
                         int32_t* max_off_out);
int32_t stitch_chain(
    const int64_t* chain_q, const int64_t* chain_t, const int64_t* chain_l,
    int32_t n, const uint8_t* query, int64_t read_len, int32_t is_rev,
    const uint8_t* ref_slice, int64_t ref_off, int64_t ref_slice_len,
    int64_t chr_beg, int64_t chr_end,
    int32_t clip_len, double clip_sim, int32_t split_len, double split_sim,
    double reverse_sim, int32_t slack, const int8_t* mat_clip,
    int32_t clip_gapo, int32_t clip_gape, int32_t clip_band,
    int32_t clip_zdrop, int32_t split_odel, int32_t split_edel,
    int32_t split_oins, int32_t split_eins, int32_t split_band,
    int32_t split_zdrop, double gap_penalty, void* recs,
    int32_t max_recs, char* strbuf, int64_t strbuf_cap,
    int64_t* total_score_out,
    const uint8_t* pre_has, const int64_t* pre_dist, const int64_t* pre_end,
    const uint8_t* pre_moves, const int64_t* pre_off,
    const int64_t* pre_len,
    const uint8_t* esc_has, const int64_t* esc_a, const int64_t* esc_b,
    const uint8_t* esc_moves, const int64_t* esc_off);

int lf_trace_fields() { return N_FIELDS; }

void lf_trace_begin(int64_t* acc) { t_armed = acc; }

void lf_trace_end() { t_armed = nullptr; }

int64_t __wrap_nw_align(const uint8_t* q, int64_t ql, const uint8_t* t,
                        int64_t tl, uint8_t* moves, int64_t* moves_len) {
  Span s;
  int64_t r = __real_nw_align(q, ql, t, tl, moves, moves_len);
  if (s.acc) {
    s.close(LOCAL_NS);
    s.acc[LOCAL_DPS] += 1;
    s.acc[LOCAL_CELLS] += ql * tl;
  }
  return r;
}

int64_t __wrap_shw_best_end(const uint8_t* q, int64_t ql, const uint8_t* t,
                            int64_t tl, int64_t* end_out) {
  Span s;
  int64_t r = __real_shw_best_end(q, ql, t, tl, end_out);
  if (s.acc) {
    s.close(LOCAL_NS);
    s.acc[LOCAL_DPS] += 1;
    s.acc[LOCAL_CELLS] += ql * tl;
  }
  return r;
}

int32_t __wrap_sw_extend(int32_t qlen, const uint8_t* query, int32_t tlen,
                         const uint8_t* target, int32_t m, const int8_t* mat,
                         int32_t o_del, int32_t e_del, int32_t o_ins,
                         int32_t e_ins, int32_t w, int32_t end_bonus,
                         int32_t zdrop, int32_t h0, int32_t* qle,
                         int32_t* tle, int32_t* gtle, int32_t* gscore_out,
                         int32_t* max_off_out) {
  Span s;
  int32_t r = __real_sw_extend(qlen, query, tlen, target, m, mat, o_del,
                               e_del, o_ins, e_ins, w, end_bonus, zdrop, h0,
                               qle, tle, gtle, gscore_out, max_off_out);
  if (s.acc) {
    s.close(LOCAL_NS);
    s.acc[LOCAL_DPS] += 1;
    s.acc[LOCAL_CELLS] += (int64_t)qlen * tlen;
  }
  return r;
}

int __wrap_edlib_band_path(const uint8_t* q, int64_t ql, const uint8_t* t,
                           int64_t tl, int64_t k, uint8_t* moves,
                           int64_t* moves_len) {
  Span s;
  int r = __real_edlib_band_path(q, ql, t, tl, k, moves, moves_len);
  if (s.acc) {
    s.close(REBUILD_NS);
    s.acc[REBUILDS] += 1;
    s.acc[REBUILD_FALLBACK] += (r != 0);
  }
  return r;
}

int32_t lf_stitch_chain_timed(
    const int64_t* chain_q, const int64_t* chain_t, const int64_t* chain_l,
    int32_t n, const uint8_t* query, int64_t read_len, int32_t is_rev,
    const uint8_t* ref_slice, int64_t ref_off, int64_t ref_slice_len,
    int64_t chr_beg, int64_t chr_end,
    int32_t clip_len, double clip_sim, int32_t split_len, double split_sim,
    double reverse_sim, int32_t slack, const int8_t* mat_clip,
    int32_t clip_gapo, int32_t clip_gape, int32_t clip_band,
    int32_t clip_zdrop, int32_t split_odel, int32_t split_edel,
    int32_t split_oins, int32_t split_eins, int32_t split_band,
    int32_t split_zdrop, double gap_penalty, void* recs,
    int32_t max_recs, char* strbuf, int64_t strbuf_cap,
    int64_t* total_score_out,
    const uint8_t* pre_has, const int64_t* pre_dist, const int64_t* pre_end,
    const uint8_t* pre_moves, const int64_t* pre_off,
    const int64_t* pre_len,
    const uint8_t* esc_has, const int64_t* esc_a, const int64_t* esc_b,
    const uint8_t* esc_moves, const int64_t* esc_off) {
  int64_t* acc = t_armed;
  t_acc = acc;
  const int64_t t0 = acc ? now_ns() : 0;
  int32_t r = stitch_chain(
      chain_q, chain_t, chain_l, n, query, read_len, is_rev, ref_slice,
      ref_off, ref_slice_len, chr_beg, chr_end, clip_len, clip_sim,
      split_len, split_sim, reverse_sim, slack, mat_clip, clip_gapo,
      clip_gape, clip_band, clip_zdrop, split_odel, split_edel, split_oins,
      split_eins, split_band, split_zdrop, gap_penalty, recs, max_recs,
      strbuf, strbuf_cap, total_score_out, pre_has, pre_dist, pre_end,
      pre_moves, pre_off, pre_len, esc_has, esc_a, esc_b, esc_moves,
      esc_off);
  t_acc = nullptr;
  if (acc) {
    acc[NATIVE_NS] += now_ns() - t0;
    acc[WINDOWS] += 1;
    acc[OVERFLOW] += (r < 0);
  }
  return r;
}

}  // extern "C"
