// The seeder's staged greedy backward extension with its occ == 1 finish,
// one thread per lane, and the locate walk of a sampled SA, one thread per
// row, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's device loops in lordfast_tpu/ops/fm_index.py
// _seed_anchors_impl (:387): ext_loop_flat (:485, lax.while_loop :492),
// _resolve_rounds (:497, lax.while_loop :568) and staged_ext (:602), for
// a replicated index.  The port's plain version is ops/fm_index.py
// _staged_ext (eager: ~40 launches an extension step, a bool(act.any())
// a resolve round and a nonzero compaction a stage); it stays the CPU path
// and the oracle.  A sharded index runs its lockstep extension and walk as
// one launch of seed_shard.cu's kernels a step, with the collectives
// between them; both sources count occ and step the walk through
// fm_rank.cuh.
//
// Semantics (must equal _staged_ext's per-lane (k, l, m, rpos, rflag)):
// a lane is one (read, sample position); the searched pattern is the
// reverse complement of the read from pos_f on, so each step consumes the
// complement of the next read char as one backward-extension step of the
// interval [k, l] (two occ queries, bwt_occ of lib/bwa/bwt.c:107-129 with
// the primary-row adjustment, on the fused rank rows fm_blocks = [cp(A..T)
// | 8 BWT words] or the occ_cp + bwt_blocks pair of l_pac >= 2^32).  A
// lane dies at a non-ACGT char, past the read's end, on an empty interval
// or at MAX_ANCHOR_LEN (the step that finds it is taken, its result
// dropped).  Steps run in blocks of phase1_steps; only at the end of a
// block does an alive lane whose interval is one row (k == l) leave the
// rank queries: its SA position p (sa_samp[k] with the full SA, else the
// inverse-Psi walk of bwt_sa, lib/bwa/bwt.c:86-96, to a sampled row) and
// then the comparison of the text left of p (pac_words, 2 bits a base)
// with the complemented read, stopping at the first mismatch, at the
// text's start, past the read, at a non-ACGT char or at MAX_ANCHOR_LEN:
// m grows by the run, rpos = p - run, rflag = 1, and k, l keep their
// one-row values.  That is the plain version's schedule: a lane that
// reaches one row in mid-block keeps extending by rank queries until the
// block ends, and rflag depends on it.
//
// Design: one thread per lane (B x sampling_count lanes, 128,000 at the
// defaults), the whole loop in registers, no compaction and no host sync.
// Each step asks for everything it needs before it uses any of it, so a
// step is one round trip to memory:
//   - an extension step loads the read word holding its char and both
//     queries' rank rows (k - 1 and l) as 16-byte read-only loads: the
//     four counts (two loads) and the BWT words up to the row's word (up
//     to four loads; a fused row is 96 bytes, six loads in all), then
//     counts from registers;
//   - a walk step (locate, below) is one load of one array: the rank row
//     of its row, whose own word holds the row's char;
//   - the comparison takes 16 chars a round trip: the text [p - 16, p)
//     from the two pac words that hold it (a funnel shift), spread to
//     3-bit groups in the order p - 1, p - 2, ..., beside the read's next
//     16 codes from two of its 3-bit words (_Reads.rw: 16 codes an
//     int64, the first in the highest bits); read ^ text ^ 3 in every
//     group is zero exactly where the read char is ACGT and its
//     complement is the text's char, so count-leading-zeros gives the
//     run, which is then cut at the read's end, the text's start and
//     MAX_ANCHOR_LEN - m.  The plain version compares 128-char chunks;
//     the run is the same.
// Lanes of a warp end at different steps and take different phases, and
// the warp issues until its last lane ends: that divergence is accepted.
// The diagnostics below are instantiations of their own (kDiag), so the
// kernel the pipeline launches carries none of their code.  With
// `stats` (kDiag 1), each lane also counts its extension steps, walk steps,
// matched chars and compare round trips, and reads the card's nanosecond
// timer when it starts, when it leaves the extension and when it ends,
// from which the smoke reports the warp efficiency (active lane-steps
// over issued ones) and which warp ends last, and why.  With `need` (kDiag
// 2), each lane instead marks, in one bitmap over the inputs, the pieces of
// them that its steps need (atomicOr): a rank row's 16-byte piece with the
// count of the step's char and its BWT word pairs up to the pair of the row's
// word, the SA entry it locates, and the pac and read words its compares and
// steps read; a piece many lanes or steps need is marked once, so the
// bitmap's count is the bytes of the inputs the run needs, each read once
// (the smoke's bound).
//
// What bounds it on the card: the latency of the dependent round trips
// of the warp's longest lane (each extension step's rank rows depend on
// the previous step's interval), not bytes: the rows the run's
// lane-steps read are a few MB.  Template instances: the two rank layouts,
// the index's position dtype (int32 or int64) of sa_samp and L2, and kDiag
// (none, stats, need).  tests/test_torch_seed_ext.py holds a numpy model of
// this kernel (names as here) against the plain version and the JAX package.
//
// The second kernel, sa_locate_kernel, is the locate of the seeder's
// multi-hit slots with a sampled SA: it replaces the JAX package's
// sa_lookup (lordfast_tpu/ops/fm_index.py:267, lax.while_loop :303); its
// plain version is ops/fm_index.py sa_lookup (eager: intv/2 lockstep
// steps, then one host-synced nonzero compaction a step).  The index
// samples by row, so a walk is geometric with mean ~sa_intv, and each of
// its steps is a dependent round trip to the rank rows: a warp whose
// lanes each walk one row ends with the longest of its 32 walks (~4x the
// mean; warp efficiency ~0.25), and a launch with the longest walk of
// all (one thread a row: 340 steps at 1.09 us on v2's 28 Mbp index, 459
// at 1.63 us on a 300 Mbp one, on an H100 80GB HBM3 at 700 W:
// chip_smoke.py).  So the design attacks both:
//   - the step: one load of one array (walk_step: the char from the word
//     of the row's own rank row, no second array for the BWT word), the
//     count for the one char in 32 bits, one masked popcount a word,
//     L2 in registers;
//   - the idle lanes: a lane queue.  The grid is persistent (as many
//     blocks as the card holds at once, or fewer for a small n); warp w
//     starts with rows [32 w, 32 w + 32) and then takes chunks of 32 rows
//     from a device counter (one atomicAdd a chunk by lane 0, zeroed on
//     the stream in the launch); a lane whose walk ends writes out[i] by
//     its row's own index, so no order of completion can change a bit,
//     and takes the chunk's next row at once.  The warp loops while any
//     lane has a row.  At v2's call (22,044 rows, every warp resident)
//     the queue changes nothing: the critical path is the longest walk's
//     chain of steps, and what bounds it is that chain's latency, which
//     chip_smoke.py holds against a pointer chase over a buffer of the
//     rank arrays' size; beyond residency (a Gbp genome's calls) it keeps
//     the lanes busy.
// kDiag 1 writes each row's walk steps and each warp's issued steps and
// its lanes' steps (the warp efficiency under the queue), kDiag 2 marks
// the need bitmap (rank pieces and SA entries).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "fm_rank.cuh"

namespace {

using namespace fm_rank;

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kThrees = 0x6DB6DB6DB6DBull;  // 3 in each 3-bit group
constexpr uint64_t kMask48 = 0xFFFFFFFFFFFFull;

// The index's arrays and scalars that a rank step and a locate read, and
// the need bitmap's sa_samp segment: both kernels' arguments begin with it.
struct Index {
  const int64_t* rank_a;   // fm_blocks (nb, 12), or occ_cp (nc, 4)
  const int64_t* rank_b;   // bwt_blocks (nb, 8) with occ_cp
  const void* sa_samp;     // Pos
  const void* l2;          // (5,) Pos
  uint32_t* need;          // the bitmap of needed input pieces, or null
  int64_t need_sa;         // its sa_samp segment's first bit
  int64_t seq_len, primary, n_sa;
  int sa_intv, log2_intv;
};

struct Args : Index {
  const uint8_t* alive0;   // (BS,) bool
  const int64_t* k0;       // (BS,)
  const int64_t* l0;
  const int64_t* m0;
  const int64_t* pos_f;
  const int64_t* b_lane;
  const int64_t* rw;       // (B, W16) 3-bit read words
  const int64_t* lens;     // (B,)
  const int64_t* pac_words;
  int64_t* k_out;
  int64_t* l_out;
  int64_t* m_out;
  int64_t* rpos_out;
  uint8_t* rflag_out;
  int32_t* stats;          // (BS, 7) or null
  int64_t need_pac, need_rw;  // the need bitmap's other segments
  int64_t n_lanes, n_pac;
  int L, W16, phase1_steps;
};

struct LocArgs : Index {
  const int64_t* rows;     // (n,)
  const uint8_t* valid;    // (n,) bool
  int64_t* out;            // (n,)
  int32_t* stats;          // (n,) walk steps, or null
  int32_t* wstats;         // (warps, 2) issued and lane steps, with stats
  unsigned long long* counter;  // the queue's next chunk, zeroed in launch
  int64_t n;
};

__device__ __forceinline__ uint32_t word32(const int64_t* p) {
  return static_cast<uint32_t>(ld(p));
}

// the low 32 bits of the card's nanosecond timer (the same on every SM)
__device__ __forceinline__ uint32_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<uint32_t>(t);
}

// The rank row of the $-removed BWT position kp, for the query of row k,
// all its loads issued together (16 bytes each): one round trip.
template <bool kFused>
__device__ __forceinline__ void load_at(const Index& a, int64_t kp,
                                        int64_t k, Row& row) {
  const int64_t blk = kp >> 7;
  row.k = k;
  row.off = static_cast<int>(kp & 127);
  const int f = row.off >> 4;
  const longlong2* cp;
  const longlong2* wp;
  if (kFused) {
    cp = reinterpret_cast<const longlong2*>(a.rank_a + blk * 12);
    wp = cp + 2;
  } else {
    cp = reinterpret_cast<const longlong2*>(a.rank_a + blk * 4);
    wp = reinterpret_cast<const longlong2*>(a.rank_b + blk * 8);
  }
  const longlong2 z = make_longlong2(0, 0);
  row.cnt01 = __ldg(cp);
  row.cnt23 = __ldg(cp + 1);
  row.w01 = __ldg(wp);
  row.w23 = f >= 2 ? __ldg(wp + 1) : z;
  row.w45 = f >= 4 ? __ldg(wp + 2) : z;
  row.w67 = f >= 6 ? __ldg(wp + 3) : z;
}

// The rank row of an occ query of row k (k clamped into [0, seq_len - 1]
// and shifted past primary, bwt_occ's adjustment).
template <bool kFused>
__device__ __forceinline__ void load_row(const Index& a, int64_t k,
                                         Row& row) {
  const int64_t kk = k < 0 ? 0 : (k < a.seq_len - 1 ? k : a.seq_len - 1);
  load_at<kFused>(a, kk - (kk >= a.primary ? 1 : 0), k, row);
}

// Marks bit i of the need bitmap.
__device__ __forceinline__ void mark(uint32_t* need, int64_t i) {
  atomicOr(need + (i >> 5), 1u << (i & 31));
}

// Marks the pieces of rank row x that occ(x, c) needs: its 16-byte piece
// with the count of c (two counts a piece) and its BWT word pairs up to
// the pair of x's word; bits 6 blk + 0..1 (counts) and 6 blk + 2..5 (word
// pairs) of the row's block blk.  x < 0 and x == seq_len need no row.
__device__ __forceinline__ void mark_row(const Index& a, int64_t x, int c) {
  if (x < 0 || x >= a.seq_len) return;
  const int64_t kp = x - (x >= a.primary ? 1 : 0);
  const int64_t bit = 6 * (kp >> 7);
  mark(a.need, bit + (c >> 1));
  const int f = static_cast<int>(kp & 127) >> 4;
  for (int pc = 0; pc <= (f >> 1); ++pc) mark(a.need, bit + 2 + pc);
}

// occ(k, c) from a loaded row (fm_rank.cuh occ_of_row)
__device__ __forceinline__ int64_t occ(const Index& a, const L2& l2,
                                       const Row& row, int c) {
  return occ_of_row(a.seq_len, l2, row, c);
}

// Marks the pieces of x's rank row that a walk step from row k (x = k -
// (k > primary)) needs: as mark_row for k < seq_len; row seq_len counts
// its char's total and needs only the word pair of x's char.
__device__ __forceinline__ void mark_walk(const Index& a, int64_t k,
                                          int64_t x, int c) {
  if (k != a.seq_len) {
    mark_row(a, k, c);
    return;
  }
  mark(a.need, 6 * (x >> 7) + 2 + (static_cast<int>(x & 127) >> 5));
}

// One inverse-Psi step from row k != primary (bwt_invPsi,
// lib/bwa/bwt.c:53-59; the plain _walk_step): L2[c] + occ(k, c), c the
// char at x = k - (k > primary) of the $-removed BWT.  For k < seq_len
// the rank row of x is k's own, and its word holds c: the counts and the
// char are one round trip to one array.  Row seq_len, past the last rank
// row, counts c's total and takes c from the row of x = seq_len - 1.
template <bool kFused, bool kNeed>
__device__ __forceinline__ int64_t walk_step(const Index& a, const L2& l2,
                                             int64_t k) {
  const int64_t x = k - (k > a.primary ? 1 : 0);
  Row row;
  load_at<kFused>(a, x, k, row);
  const int c = row_char(row);
  if (kNeed) mark_walk(a, k, x, c);
  return l2[c] + occ(a, l2, row, c);
}

// The SA position of row k (bwt_sa, lib/bwa/bwt.c:86-96): with the full
// SA (sa_intv 1) its entry, k clamped into the array as the plain gather
// clamps it; else the inverse-Psi walk to a sampled row (walk_step, one
// round trip a step; the primary row steps to 0), then the sampled entry
// plus the steps.  The occ == 1 finish walks through it, and
// sa_locate_kernel through walk_step, so their walks cannot drift;
// n_walk counts the steps.  With kNeed it marks the rank-row pieces and
// the SA entry it needs.
template <bool kFused, typename Pos, bool kNeed>
__device__ __forceinline__ int64_t locate(const Index& a, const L2& l2,
                                          int64_t k, int32_t& n_walk) {
  if (a.sa_intv == 1) {
    const int64_t r = k < 0 ? 0 : (k < a.n_sa - 1 ? k : a.n_sa - 1);
    if (kNeed) mark(a.need, a.need_sa + r);
    return pos_at<Pos>(a.sa_samp, r);
  }
  const int64_t mask = a.sa_intv - 1;
  int64_t rows = k;
  int64_t steps = 0;
  while ((rows & mask) != 0) {
    rows = rows == a.primary ? 0 : walk_step<kFused, kNeed>(a, l2, rows);
    ++steps;
    ++n_walk;
  }
  if (kNeed) mark(a.need, a.need_sa + (rows >> a.log2_intv));
  return steps + pos_at<Pos>(a.sa_samp, rows >> a.log2_intv);
}

// the 16 text chars p - 1, p - 2, ..., p - 16 as 3-bit groups, p - 1 in
// bits 47..45: the chars [p - 16, p) of the pac words hi (the word of p -
// 16) and lo (the next), joined by a funnel shift with p - 1 in the low
// bits, then spread
__device__ __forceinline__ uint64_t text16(uint32_t hi, uint32_t lo,
                                           int64_t a0) {
  const uint32_t tw =
      __funnelshift_l(lo, hi, static_cast<unsigned>((a0 & 15) << 1));
  uint64_t t3 = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    t3 |= static_cast<uint64_t>((tw >> (2 * j)) & 3u) << (45 - 3 * j);
  }
  return t3;
}

template <bool kFused, typename Pos, int kDiag>
__global__ void __launch_bounds__(kThreads) seed_ext_kernel(const Args a) {
  const int64_t lane =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= a.n_lanes) return;
  constexpr bool timed = kDiag == 1;  // step counts and timers
  constexpr bool needs = kDiag == 2;  // the need bitmap
  int32_t* srow = timed ? a.stats + 7 * lane : nullptr;
  if (timed) {  // the timers go to stats as they are read
    const int32_t t0 = static_cast<int32_t>(now_ns());
    srow[4] = t0;
    srow[5] = t0;
  }
  bool alive = a.alive0[lane] != 0;
  int64_t k = a.k0[lane];
  int64_t l = a.l0[lane];
  int64_t m = a.m0[lane];
  int64_t rpos = 0;
  bool rflag = false;
  int32_t n_ext = 0, n_walk = 0, n_cmp = 0, n_trip = 0;
  if (alive) {
    const L2 l2{pos_at<Pos>(a.l2, 0), pos_at<Pos>(a.l2, 1),
                pos_at<Pos>(a.l2, 2), pos_at<Pos>(a.l2, 3),
                pos_at<Pos>(a.l2, 4)};
    const int64_t posf = a.pos_f[lane];
    const int64_t b = a.b_lane[lane];
    const int64_t* rwb = a.rw + b * a.W16;
    const int64_t len = a.lens[b];
    for (;;) {
      // phase1_steps greedy steps (_ext_steps)
      for (int s = 0; s < a.phase1_steps && alive; ++s) {
        const int64_t q = posf + m;  // next read position to consume
        const int64_t qc = q < a.L ? q : a.L - 1;
        const int64_t word = ld(rwb + (qc >> 4));
        Row rk, rl;
        load_row<kFused>(a, k - 1, rk);
        load_row<kFused>(a, l, rl);
        const int c = static_cast<int>((word >> (3 * (15 - (qc & 15)))) & 7);
        const bool ok_char = q < len && c < 4;
        const int cc = ok_char ? 3 - c : 0;  // complemented
        if (needs) {  // the char when in the read; the rows
          if (q < len) mark(a.need, a.need_rw + b * a.W16 + (q >> 4));
          if (ok_char && m < kMaxAnchor) {
            mark_row(a, k - 1, cc);
            mark_row(a, l, cc);
          }
        }
        const int64_t nk = l2[cc] + occ(a, l2, rk, cc) + 1;
        const int64_t nl = l2[cc] + occ(a, l2, rl, cc);
        alive = ok_char && nk <= nl && m < kMaxAnchor;
        if (alive) {
          k = nk;
          l = nl;
          ++m;
        }
        ++n_ext;
      }
      if (timed) srow[5] = static_cast<int32_t>(now_ns());
      if (!alive) break;
      if (k != l) continue;
      // one row at the block's end: locate it (_resolve_rounds' sa_lookup)
      int64_t p = locate<kFused, Pos, needs>(a, l2, k, n_walk);
      // the text left of p against the complemented read, 16 chars a
      // round trip
      for (;;) {
        const int64_t q = posf + m;
        int64_t lim = len - q;
        lim = lim < p ? lim : p;
        lim = lim < kMaxAnchor - m ? lim : kMaxAnchor - m;
        if (lim <= 0) break;
        const int64_t a0 = p - 16;
        const int64_t wa = a0 >> 4;  // arithmetic: -1 for p < 16
        const int64_t q0 = q >> 4;
        const uint32_t thi = word32(a.pac_words + (wa < 0 ? 0 : wa));
        const uint32_t tlo =
            word32(a.pac_words + (wa + 1 < a.n_pac ? wa + 1 : a.n_pac - 1));
        const uint64_t r0 = static_cast<uint64_t>(ld(rwb + q0));
        const uint64_t r1 =
            static_cast<uint64_t>(ld(rwb + (q0 + 1 < a.W16 ? q0 + 1
                                                           : a.W16 - 1)));
        const int sh = static_cast<int>(3 * (q & 15));
        const uint64_t rd = ((r0 << sh) | (r1 >> (48 - sh))) & kMask48;
        const uint64_t d = rd ^ text16(thi, tlo, a0) ^ kThrees;
        const int64_t n = (__clzll(static_cast<long long>(d)) - 16) / 3;
        const int64_t run = n < lim ? n : lim;
        if (needs) {  // the chars compared, the mismatch too
          const int64_t cnt = run < lim && run < 16 ? run + 1 : run;
          mark(a.need, a.need_pac + ((p - cnt) >> 4));
          mark(a.need, a.need_pac + ((p - 1) >> 4));
          mark(a.need, a.need_rw + b * a.W16 + (q >> 4));
          mark(a.need, a.need_rw + b * a.W16 + ((q + cnt - 1) >> 4));
        }
        m += run;
        p -= run;
        n_cmp += static_cast<int32_t>(run);
        ++n_trip;
        if (run < 16) break;
      }
      rpos = p;
      rflag = true;
      break;
    }
  }
  a.k_out[lane] = k;
  a.l_out[lane] = l;
  a.m_out[lane] = m;
  a.rpos_out[lane] = rpos;
  a.rflag_out[lane] = rflag;
  if (timed) {
    srow[0] = n_ext;
    srow[1] = n_walk;
    srow[2] = n_cmp;
    srow[3] = n_trip;
    srow[6] = static_cast<int32_t>(now_ns());
  }
}

// The locate of the seeder's multi-hit slots (_seed_anchors_impl's
// sa_lookup) through a lane queue: a persistent grid, warp w starting with
// the chunk of rows [32 w, 32 w + 32) and then taking chunk n_warps +
// atomicAdd(counter, 1) when an idle lane finds its chunk handed out (it
// gets a row in the next iteration); each idle lane
// takes the chunk's next row (its row and flag, loaded with the chunk,
// come by shuffle), a lane with a row takes one walk step (walk_step; the
// primary row steps to 0) or, at a sampled row, loads its entry and
// writes out[i] = steps + entry by the row's own index and goes idle.  An
// invalid row writes 0.  kDiag 1 writes each row's walk steps and each
// warp's issued steps (iterations in which a lane stepped) and its lanes'
// steps; kDiag 2 marks the need bitmap.
template <bool kFused, typename Pos, int kDiag>
__global__ void __launch_bounds__(kThreads) sa_locate_kernel(
    const LocArgs a) {
  constexpr bool timed = kDiag == 1;  // step counts
  constexpr bool needs = kDiag == 2;  // the need bitmap
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const L2 l2{pos_at<Pos>(a.l2, 0), pos_at<Pos>(a.l2, 1),
              pos_at<Pos>(a.l2, 2), pos_at<Pos>(a.l2, 3),
              pos_at<Pos>(a.l2, 4)};
  const int64_t mask = a.sa_intv - 1;
  // the warp's chunk of the queue: rows [cb, cb + 32), lane x's entry in
  // (crow, cval), the first `taken` of them handed out
  int64_t cb = warp * 32;
  int64_t crow = 0;
  int cval = 0;
  if (cb + lane < a.n) {
    crow = a.rows[cb + lane];
    cval = a.valid[cb + lane];
  }
  int taken = 0;
  int64_t i = -1;    // the lane's row index, -1 while it has none
  int64_t rows = 0;  // its walk's current row
  int32_t steps = 0;
  int32_t issued = 0, active = 0;
  for (;;) {
    const unsigned idle = __ballot_sync(kFull, i < 0);
    if (idle != 0 && cb < a.n) {  // hand out the chunk's next rows
      const int left =
          static_cast<int>(a.n - cb < 32 ? a.n - cb : 32) - taken;
      const int want = __popc(idle);
      const int src = taken + __popc(idle & ((1u << lane) - 1u));
      const int64_t r = __shfl_sync(kFull, crow, src & 31);
      const int v = __shfl_sync(kFull, cval, src & 31);
      if (i < 0 && src < taken + left) {
        i = cb + src;
        rows = r;
        steps = 0;
        if (v == 0) {
          a.out[i] = 0;
          if (timed) a.stats[i] = 0;
          i = -1;
        }
      }
      taken += want < left ? want : left;
      if (want > left) {  // an idle lane left over: the queue's next chunk
        unsigned long long c = 0;
        if (lane == 0) c = atomicAdd(a.counter, 1ull);
        c = __shfl_sync(kFull, c, 0);
        cb = (n_warps + static_cast<int64_t>(c)) * 32;
        taken = 0;
        crow = 0;
        cval = 0;
        if (cb + lane < a.n) {
          crow = a.rows[cb + lane];
          cval = a.valid[cb + lane];
        }
      }
    }
    bool stepped = false;
    if (i >= 0) {
      if ((rows & mask) == 0) {  // a sampled row: the walk's end
        const int64_t e = rows >> a.log2_intv;
        if (needs) mark(a.need, a.need_sa + e);
        a.out[i] = steps + pos_at<Pos>(a.sa_samp, e);
        if (timed) a.stats[i] = steps;
        i = -1;
      } else {
        rows = rows == a.primary ? 0 : walk_step<kFused, needs>(a, l2, rows);
        ++steps;
        stepped = true;
      }
    }
    if (timed) {
      const unsigned st = __ballot_sync(kFull, stepped);
      issued += st != 0u;
      active += __popc(st);
    }
    if (__ballot_sync(kFull, i >= 0) == 0u && cb >= a.n) break;
  }
  if (timed && lane == 0) {
    a.wstats[2 * warp] = issued;
    a.wstats[2 * warp + 1] = active;
  }
}

// The latency floor of a walk step: one thread follows next = buf[next]
// (a seeded random cyclic permutation the caller writes) for warm hops,
// then times hops more on the card's nanosecond timer, each load through
// the read-only path as walk_step's are.  out[0] = the last index (so no
// load is dead), out[1] = the timed hops' nanoseconds.
__global__ void chase_kernel(const int64_t* buf, int64_t start, int warm,
                             int hops, int64_t* out) {
  int64_t x = start;
  for (int h = 0; h < warm; ++h) x = ld(buf + x);
  uint64_t t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0) : "l"(x));
  for (int h = 0; h < hops; ++h) x = ld(buf + x);
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1) : "l"(x));
  out[0] = x;
  out[1] = static_cast<int64_t>(t1 - t0);
}

// The blocks of a launch over n lanes: one for each kThreads lanes
// (seed_ext), or for sa_locate's persistent grid as many as the card
// holds at once (its SMs times the blocks of this instantiation an SM
// holds) and no more than n needs.  0 on an error of the queries.
template <typename K>
unsigned blocks_of(K kern, bool persistent, int64_t n) {
  const int64_t need = (n + kThreads - 1) / kThreads;
  if (!persistent) return static_cast<unsigned>(need);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    0) != cudaSuccess) {
    return 0;
  }
  const int64_t held = static_cast<int64_t>(sms) * per_sm;
  return static_cast<unsigned>(need < held ? need : held);
}

// One launch of kern over n lanes (blocks_of; sa_locate's queue counter
// zeroed on the stream first).  Returns a cudaError_t.
template <typename A, typename K>
int run(K kern, const A& a, int64_t n, cudaStream_t stream) {
  constexpr bool kLocate = std::is_same<A, LocArgs>::value;
  const unsigned grid = blocks_of(kern, kLocate, n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kLocate) {
    const cudaError_t e =
        cudaMemsetAsync(a.counter, 0, sizeof(unsigned long long), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// seed_ext_kernel (kLocate false) or sa_locate_kernel, the instantiation
// picked by the layout, the position dtype and the diagnostics asked for
// (stats: 1, need: 2, else 0).
template <bool kLocate, bool kFused, int kDiag, typename Pos, typename A>
int launch_one(const A& a, int64_t n, cudaStream_t stream) {
  if constexpr (kLocate) {
    return run(sa_locate_kernel<kFused, Pos, kDiag>, a, n, stream);
  } else {
    return run(seed_ext_kernel<kFused, Pos, kDiag>, a, n, stream);
  }
}

template <bool kLocate, bool kFused, int kDiag, typename A>
int launch_pos(const A& a, int64_t n, int pos_bytes, cudaStream_t stream) {
  return pos_bytes == 4
             ? launch_one<kLocate, kFused, kDiag, int32_t>(a, n, stream)
             : launch_one<kLocate, kFused, kDiag, int64_t>(a, n, stream);
}

template <bool kLocate, typename A>
int launch(const A& a, int64_t n, bool fused, int pos_bytes,
           cudaStream_t stream) {
  const int diag = a.stats != nullptr ? 1 : a.need != nullptr ? 2 : 0;
  if (fused) {
    return diag == 1 ? launch_pos<kLocate, true, 1>(a, n, pos_bytes, stream)
         : diag == 2 ? launch_pos<kLocate, true, 2>(a, n, pos_bytes, stream)
                     : launch_pos<kLocate, true, 0>(a, n, pos_bytes, stream);
  }
  return diag == 1 ? launch_pos<kLocate, false, 1>(a, n, pos_bytes, stream)
       : diag == 2 ? launch_pos<kLocate, false, 2>(a, n, pos_bytes, stream)
                   : launch_pos<kLocate, false, 0>(a, n, pos_bytes, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The index part of both entries' arguments, or false if it is not one
// the kernels take.
bool make_index(Index& ix, const void* rank_a, const void* rank_b,
                const void* sa_samp, const void* l2,
                void* need, long long need_sa, long long seq_len,
                long long primary, long long n_sa, int sa_intv,
                int pos_bytes, int fused) {
  if (sa_intv <= 0 || (sa_intv & (sa_intv - 1)) != 0 ||
      (pos_bytes != 4 && pos_bytes != 8) || (!fused && rank_b == nullptr) ||
      !aligned16(rank_a) || (!fused && !aligned16(rank_b))) {
    return false;
  }
  int log2_intv = 0;
  while ((1 << log2_intv) < sa_intv) ++log2_intv;
  ix = Index{static_cast<const int64_t*>(rank_a),
             static_cast<const int64_t*>(rank_b), sa_samp, l2,
             static_cast<uint32_t*>(need), need_sa, seq_len, primary, n_sa,
             sa_intv, log2_intv};
  return true;
}

}  // namespace

// Per lane (BS lanes): alive0 bool, k0, l0, m0, pos_f, b_lane int64; the
// reads as 3-bit words rw (B, W16) int64 (16 codes a word, 4 = N / pad,
// the first in the highest bits; _Reads.rw) of L chars and their lens
// (B,) int64; the index: fused = 1 with rank_a = fm_blocks (nb, 12)
// int64, or fused = 0 with rank_a = occ_cp (nc, 4) and rank_b =
// bwt_blocks (nb, 8) int64, each 16-byte aligned; pac_words (n_pac,)
// int64 (uint32 words); sa_samp (n_sa,) and l2 (5,)
// int32 (pos_bytes 4) or int64 (8); sa_intv a power of two.  Outputs k,
// l, m, rpos int64 and rflag bool per lane; stats (BS, 7) int32 or null:
// extension steps, walk steps, matched chars, compare round trips, and
// the low 32 bits of the nanosecond timer at the lane's start, when it
// left the extension, and at its end; need (bits) int32 zeros or null
// (not with stats):
// the bitmap of the input pieces the lanes' steps need, segments at bits
// 0 (rank rows: 6 a block of 128 rows), need_sa (sa_samp entries),
// need_pac (pac words) and need_rw (the read words, W16 a read).
// Returns a cudaError_t (0 on a clean launch).
extern "C" int lf_seed_ext(
    const void* alive0, const void* k0, const void* l0, const void* m0,
    const void* pos_f, const void* b_lane, const void* rw, const void* lens,
    const void* rank_a, const void* rank_b, const void* sa_samp,
    const void* l2, const void* pac_words, void* k_out,
    void* l_out, void* m_out, void* rpos_out, void* rflag_out, void* stats,
    void* need, long long need_sa, long long need_pac, long long need_rw,
    long long n_lanes, int L, int W16, int phase1_steps, long long seq_len,
    long long primary, long long n_sa, long long n_pac, int sa_intv,
    int pos_bytes, int fused, void* stream) {
  Index ix;
  if (!make_index(ix, rank_a, rank_b, sa_samp, l2, need, need_sa, seq_len,
                  primary, n_sa, sa_intv, pos_bytes, fused) ||
      L <= 0 || W16 * 16 < L || phase1_steps <= 0 || n_pac <= 0 ||
      (stats != nullptr && need != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_lanes <= 0) return 0;
  auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  auto o64 = [](void* p) { return static_cast<int64_t*>(p); };
  const Args a{ix, static_cast<const uint8_t*>(alive0), i64(k0), i64(l0),
               i64(m0), i64(pos_f), i64(b_lane), i64(rw), i64(lens),
               i64(pac_words), o64(k_out), o64(l_out), o64(m_out),
               o64(rpos_out), static_cast<uint8_t*>(rflag_out),
               static_cast<int32_t*>(stats), need_pac, need_rw, n_lanes,
               n_pac, L, W16, phase1_steps};
  return launch<false>(a, n_lanes, fused != 0, pos_bytes,
                       static_cast<cudaStream_t>(stream));
}

// The locate of n rows (int64) where valid (bool) is set, over the index
// as lf_seed_ext takes it, with sa_intv a power of two above 1: out (n,)
// int64, each valid row's SA position and 0 for the rest; counter one
// uint64 of scratch (the lane queue's, zeroed on the stream here); stats
// (n,) int32 or null: each row's walk steps, with wstats (4 ceil(n /
// 128), 2) int32 zeros: each warp's issued walk steps and its lanes' walk
// steps (the persistent grid's warps write the first rows); need
// (bits) int32 zeros or null (not with stats):
// the bitmap of the input pieces the walks need, segments at bits 0
// (rank rows, as lf_seed_ext's) and need_sa (sa_samp entries).  Returns a
// cudaError_t (0 on a clean launch).
extern "C" int lf_sa_locate(
    const void* rows, const void* valid, const void* rank_a,
    const void* rank_b, const void* sa_samp, const void* l2, void* out,
    void* counter, void* stats, void* wstats, void* need, long long need_sa,
    long long n, long long seq_len, long long primary, long long n_sa,
    int sa_intv, int pos_bytes, int fused, void* stream) {
  Index ix;
  if (!make_index(ix, rank_a, rank_b, sa_samp, l2, need, need_sa, seq_len,
                  primary, n_sa, sa_intv, pos_bytes, fused) ||
      sa_intv < 2 || counter == nullptr ||
      (stats != nullptr && need != nullptr) ||
      ((stats == nullptr) != (wstats == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const LocArgs a{ix, static_cast<const int64_t*>(rows),
                  static_cast<const uint8_t*>(valid),
                  static_cast<int64_t*>(out), static_cast<int32_t*>(stats),
                  static_cast<int32_t*>(wstats),
                  static_cast<unsigned long long*>(counter), n};
  return launch<true>(a, n, fused != 0, pos_bytes,
                      static_cast<cudaStream_t>(stream));
}

// One thread's pointer chase over buf (int64 indexes into itself): warm
// hops, then hops timed; out (2,) int64: the last index and the timed
// hops' nanoseconds.  Returns a cudaError_t (0 on a clean launch).
extern "C" int lf_chase(const void* buf, long long start, int warm,
                        int hops, void* out, void* stream) {
  if (buf == nullptr || out == nullptr || warm < 0 || hops <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(buf), start, warm, hops,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
