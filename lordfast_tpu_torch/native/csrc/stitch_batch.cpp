// The host stitcher over a whole batch of windows in one call.
//
// lf_stitch_batch runs stitch_chain (stitch.cpp, through stitch_trace.cpp's
// accounting entry lf_stitch_chain_timed) over every window of a batch on
// n_threads threads.  The caller packs the batch once: the windows' chains,
// query codes and gap / escalation tables as flat arrays with per-window
// offsets, the index's 2-bit packed forward genome (pac) and its contigs.
// Each window takes its reference slice straight from pac and finds its
// contig as the Python stitcher does (align_chain_native:
// idx.get_ref_codes, idx.chr_boundaries), so stitch_chain sees the inputs
// it sees there.
//
// Threads take windows in batch order from one atomic counter (ordering
// them longest first, by target span plus read length or by the cells of
// their local DPs, did not shorten the call on long reads).  A thread's
// records and CIGAR / MD strings go to scratch it reuses, then compactly
// into its own output; the caller reads the sizes, allocates, and
// lf_stitch_batch_collect copies every thread's output into its arrays and
// frees the batch.  A window whose records or strings overflow the scratch
// (stitch_chain returns -1) gets nrec -1 and no output, for the caller's
// Python stitcher.
//
// With acc non-null, each window's row of acc (lf_trace_fields() + 2
// entries) receives stitch_trace.cpp's fields for its stitch_chain call,
// then the window's wall ns in its thread and the thread's CPU ns outside
// stitch_chain (the slice and the copy-out).

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <system_error>
#include <thread>
#include <vector>

extern "C" {

// stitch.cpp's StitchRecord (align/chain_align.py _StitchRecordC; its
// offsets are held to that one's by lf_stitch_record_layout)
typedef struct {
  int32_t flag;
  int64_t pos, pos_end;
  int64_t q_start, q_end;
  int64_t nm_count;
  int64_t aln_score;
  int64_t cigar_off, cigar_len, md_off, md_len;
} BatchRecord;

// the configuration's scalars (native/__init__.py StitchParams)
typedef struct {
  int32_t clip_len, split_len, slack;
  int32_t clip_gapo, clip_gape, clip_band, clip_zdrop;
  int32_t split_odel, split_edel, split_oins, split_eins, split_band,
      split_zdrop;
  double clip_sim, split_sim, reverse_sim;
  double gap_penalty_fwd, gap_penalty_rev;
} StitchParams;

// the packed batch (native/__init__.py StitchInputs); window w's chain is
// [chain_off[w], chain_off[w + 1]) of cq / ct / cl, its query
// [query_off[w], query_off[w] + read_len[w]) of query.  gap_base[w] is the
// first slot of its gap table in g_* (-1: none), esc_base[w] the first
// sub-slot of its escalation table in e_* (-1: none); g_off / e_off index
// the whole g_moves / e_moves.
typedef struct {
  int64_t n;
  const int64_t *chain_off, *cq, *ct, *cl;
  const int64_t* query_off;
  const uint8_t* query;
  const int64_t* read_len;
  const uint8_t* is_rev;
  const int64_t* gap_base;
  const uint8_t* g_has;
  const int64_t *g_dist, *g_end;
  const uint8_t* g_moves;
  const int64_t *g_off, *g_len;
  const int64_t* esc_base;
  const uint8_t* e_has;
  const int64_t *e_a, *e_b;
  const uint8_t* e_moves;
  const int64_t* e_off;
  const uint8_t* pac;
  int64_t l_pac;
  const int64_t *contig_off, *contig_len;
  int64_t n_contigs;
} StitchInputs;

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
    const uint8_t* esc_moves, const int64_t* esc_off);
int lf_trace_fields();
void lf_trace_begin(int64_t* acc);
void lf_trace_end();

}  // extern "C"

namespace {

inline int64_t clock_ns(clockid_t id) {
  timespec ts;
  clock_gettime(id, &ts);
  return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

// Forward-genome codes [beg, beg + len) from pac (bwa's layout: code i in
// bits 7-6 of byte i / 4 for i % 4 == 0, down to bits 1-0), 0 outside
// [0, l_pac): FMIndex.get_ref_codes.
void ref_slice(const uint8_t* pac, int64_t l_pac, int64_t beg, int64_t len,
               uint8_t* out) {
  for (int64_t k = 0; k < len; k++) {
    const int64_t i = beg + k;
    out[k] = (i < 0 || i >= l_pac)
                 ? 0
                 : (uint8_t)((pac[i >> 2] >> (((~i) & 3) << 1)) & 3);
  }
}

// One thread's output and reused scratch.
struct Worker {
  std::vector<uint8_t> ref;
  std::vector<BatchRecord> scratch_recs;
  std::vector<char> scratch_str;
  std::vector<BatchRecord> recs;  // compact, offsets into str
  std::vector<char> str;
};

struct Batch {
  std::vector<Worker> workers;
  std::vector<int32_t> worker_of;  // window -> its thread
  std::vector<int64_t> first_rec;  // window -> first record in its thread
};

void stitch_window(const StitchInputs& in, const StitchParams& p,
                   const int8_t* mat_clip, int32_t max_recs, int64_t str_cap,
                   int64_t w, int32_t tid, Worker& wk, Batch& b,
                   int32_t* nrec_out, int64_t* total_out, int64_t* row,
                   int n_fields) {
  int64_t wall0 = 0, cpu0 = 0, cpu_in = 0;
  if (row) {
    lf_trace_begin(row);
    wall0 = clock_ns(CLOCK_MONOTONIC);
    cpu0 = clock_ns(CLOCK_THREAD_CPUTIME_ID);
  }
  const int64_t c0 = in.chain_off[w];
  const int32_t n = (int32_t)(in.chain_off[w + 1] - c0);
  const int64_t *cq = in.cq + c0, *ct = in.ct + c0, *cl = in.cl + c0;
  const int64_t read_len = in.read_len[w];
  const int32_t is_rev = in.is_rev[w];

  // chains may cross contig boundaries (the reference reads concatenated
  // pac there), so the slice is bounded by the genome, not the contig
  const int64_t lo = std::max<int64_t>(0, ct[0] - read_len - p.slack - 8);
  const int64_t hi = ct[n - 1] + cl[n - 1] + read_len + p.slack + 8;
  if ((int64_t)wk.ref.size() < hi - lo) wk.ref.resize(hi - lo);
  ref_slice(in.pac, in.l_pac, lo, hi - lo, wk.ref.data());

  // the contig holding the chain's midpoint (FMIndex.chr_boundaries; a
  // midpoint before the first contig wraps to the last, as its index -1)
  const int64_t mid = (ct[0] + ct[n - 1]) >> 1;
  int64_t rid = std::upper_bound(in.contig_off, in.contig_off + in.n_contigs,
                                 mid) - in.contig_off - 1;
  if (rid < 0) rid = in.n_contigs - 1;
  const int64_t chr_beg = in.contig_off[rid];
  const int64_t chr_end = chr_beg + in.contig_len[rid] - 1;

  const int64_t cap = str_cap > 0 ? str_cap : 16 * (read_len + 1024);
  if ((int64_t)wk.scratch_str.size() < cap) wk.scratch_str.resize(cap);
  if ((int32_t)wk.scratch_recs.size() < max_recs)
    wk.scratch_recs.resize(max_recs);

  const int64_t gb = in.gap_base[w], eb = in.esc_base[w];
  int64_t total = 0;
  const int64_t cpu_a = row ? clock_ns(CLOCK_THREAD_CPUTIME_ID) : 0;
  const int32_t nrec = lf_stitch_chain_timed(
      cq, ct, cl, n, in.query + in.query_off[w], read_len, is_rev,
      wk.ref.data(), lo, hi - lo, chr_beg, chr_end, p.clip_len, p.clip_sim,
      p.split_len, p.split_sim, p.reverse_sim, p.slack, mat_clip,
      p.clip_gapo, p.clip_gape, p.clip_band, p.clip_zdrop, p.split_odel,
      p.split_edel, p.split_oins, p.split_eins, p.split_band, p.split_zdrop,
      is_rev ? p.gap_penalty_rev : p.gap_penalty_fwd,
      wk.scratch_recs.data(), max_recs, wk.scratch_str.data(), cap, &total,
      gb < 0 ? nullptr : in.g_has + gb, gb < 0 ? nullptr : in.g_dist + gb,
      gb < 0 ? nullptr : in.g_end + gb, gb < 0 ? nullptr : in.g_moves,
      gb < 0 ? nullptr : in.g_off + gb, gb < 0 ? nullptr : in.g_len + gb,
      eb < 0 ? nullptr : in.e_has + eb, eb < 0 ? nullptr : in.e_a + eb,
      eb < 0 ? nullptr : in.e_b + eb, eb < 0 ? nullptr : in.e_moves,
      eb < 0 ? nullptr : in.e_off + eb);
  if (row) cpu_in = clock_ns(CLOCK_THREAD_CPUTIME_ID) - cpu_a;

  nrec_out[w] = nrec;
  total_out[w] = total;
  b.worker_of[w] = tid;
  b.first_rec[w] = (int64_t)wk.recs.size();
  if (nrec > 0) {
    int64_t used = 0;
    for (int32_t i = 0; i < nrec; i++) {
      const BatchRecord& r = wk.scratch_recs[i];
      used = std::max(used, std::max(r.cigar_off + r.cigar_len,
                                     r.md_off + r.md_len));
    }
    const int64_t base = (int64_t)wk.str.size();
    wk.str.insert(wk.str.end(), wk.scratch_str.data(),
                  wk.scratch_str.data() + used);
    for (int32_t i = 0; i < nrec; i++) {
      BatchRecord r = wk.scratch_recs[i];
      r.cigar_off += base;
      r.md_off += base;
      wk.recs.push_back(r);
    }
  }
  if (row) {
    lf_trace_end();
    row[n_fields] = clock_ns(CLOCK_MONOTONIC) - wall0;
    row[n_fields + 1] = clock_ns(CLOCK_THREAD_CPUTIME_ID) - cpu0 - cpu_in;
  }
}

}  // namespace

extern "C" {

// The record's fields, by name (layout check).
#define LF_RECORD_FIELDS(X)                                                \
  X(flag) X(pos) X(pos_end) X(q_start) X(q_end) X(nm_count) X(aln_score) \
  X(cigar_off) X(cigar_len) X(md_off) X(md_len)
#define LF_FIELD_NAME(f) #f ","
#define LF_FIELD_OFFSET(f) (int64_t) offsetof(BatchRecord, f),

// The record's size, then each field's offset, into out (room for cap
// entries), and its field names, comma-separated in the same order, into
// *names; returns the number of entries.  The caller holds them to its
// copy of the layout by name (pipeline/stitch_batch.py check_record).
int64_t lf_stitch_record_layout(int64_t* out, int64_t cap,
                                const char** names) {
  static const int64_t v[] = {(int64_t)sizeof(BatchRecord),
                              LF_RECORD_FIELDS(LF_FIELD_OFFSET)};
  *names = LF_RECORD_FIELDS(LF_FIELD_NAME);
  const int64_t n = (int64_t)(sizeof(v) / sizeof(v[0]));
  for (int64_t i = 0; i < n && i < cap; i++) out[i] = v[i];
  return n;
}

// Stitches every window of `in` on n_threads threads (the calling thread
// among them).  Fills nrec_out / total_out (n entries each) and the
// output's sizes; returns the batch to pass to lf_stitch_batch_collect,
// or null if a thread failed (out of memory), with nothing to free.
void* lf_stitch_batch(const StitchInputs* in, const StitchParams* p,
                      const int8_t* mat_clip, int32_t n_threads,
                      int32_t max_recs, int64_t str_cap, int64_t* acc,
                      int32_t* nrec_out, int64_t* total_out,
                      int64_t* n_recs_out, int64_t* n_str_out) {
  const int64_t n = in->n;
  const int n_fields = lf_trace_fields();
  const int32_t nt =
      (int32_t)std::max<int64_t>(1, std::min<int64_t>(n_threads, n));
  Batch* b = nullptr;
  try {
    b = new Batch();
    b->workers.resize(nt);
    b->worker_of.assign(n, 0);
    b->first_rec.assign(n, 0);
    std::atomic<int64_t> next{0};
    std::atomic<bool> failed{false};
    auto run = [&](int32_t tid) {
      try {
        for (int64_t w; (w = next.fetch_add(1)) < n && !failed;) {
          stitch_window(*in, *p, mat_clip, max_recs, str_cap, w, tid,
                        b->workers[tid], *b, nrec_out, total_out,
                        acc ? acc + w * (n_fields + 2) : nullptr, n_fields);
        }
      } catch (...) {
        lf_trace_end();
        failed = true;
      }
    };
    // a thread that cannot start leaves its windows to the others
    std::vector<std::thread> threads;
    for (int32_t t = 1; t < nt; t++) {
      try {
        threads.emplace_back(run, t);
      } catch (const std::system_error&) {
        break;
      }
    }
    run(0);
    for (auto& t : threads) t.join();
    if (failed) {
      delete b;
      return nullptr;
    }
    int64_t nr = 0, ns = 0;
    for (const Worker& wk : b->workers) {
      nr += (int64_t)wk.recs.size();
      ns += (int64_t)wk.str.size();
    }
    *n_recs_out = nr;
    *n_str_out = ns;
    return b;
  } catch (...) {
    delete b;
    return nullptr;
  }
}

// Copies the batch's records (n_recs) and strings (n_str bytes) into the
// caller's arrays, window w's records at first_rec[w] onward with their
// string offsets into `str`, and frees the batch.
void lf_stitch_batch_collect(void* batch, BatchRecord* recs, char* str,
                             int64_t* first_rec) {
  Batch* b = static_cast<Batch*>(batch);
  std::vector<int64_t> rec_base(b->workers.size());
  int64_t nr = 0, ns = 0;
  for (size_t t = 0; t < b->workers.size(); t++) {
    const Worker& wk = b->workers[t];
    rec_base[t] = nr;
    for (size_t i = 0; i < wk.recs.size(); i++) {
      BatchRecord r = wk.recs[i];
      r.cigar_off += ns;
      r.md_off += ns;
      recs[nr + i] = r;
    }
    if (!wk.str.empty()) std::memcpy(str + ns, wk.str.data(), wk.str.size());
    nr += (int64_t)wk.recs.size();
    ns += (int64_t)wk.str.size();
  }
  for (size_t w = 0; w < b->worker_of.size(); w++)
    first_rec[w] = rec_base[b->worker_of[w]] + b->first_rec[w];
  delete b;
}

// Frees a batch that is not collected.
void lf_stitch_batch_free(void* batch) { delete static_cast<Batch*>(batch); }

}  // extern "C"
