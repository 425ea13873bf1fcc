// The chaining DP (dp-n2 or clasp) and its backtrack, one warp per
// window, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's device loops lordfast_tpu/ops/chain.py
// chain_dpn2 (:312, lax.scan :350), chain_clasp_sop (:355, lax.scan :409)
// and _finish_chains (:188, lax.while_loop :213), behind _chain_bucketed
// (:265).  The port's plain version is ops/chain.py chain_dpn2 /
// chain_clasp_sop / _finish_chains (eager loops, one op sequence a seed
// and a host sync every 32 links); it stays the CPU path and the oracle.
//
// Semantics (must equal the plain version bit for bit: the float bits of
// dp, prev and every ChainBatch field).  Per window of N slots whose
// valid seeds fill the first `count` slots (select_window_seeds sorts
// invalid ones last), for i < count in order:
//   dp-n2 (chain_seeds_n2, src/Chain.cpp:232-310):
//     dr = q_i - (q_j + len_j - 1)              int32, wrapping
//     dt = int32(t_i - (t_j + len_j - 1))       int64 difference, cut
//     link j -> i when ok_j, j < i, dr > 0, dt > 0;
//     d = |dr - dt|; pen = d <= 1 ? 0 : 0.1 d + penalty log(max(d, 2));
//     val = (dp_j + reward) - pen;
//     best = max val, pj = the largest j among ties;
//     dp_i = best > len_i ? best : len_i, prev_i = best > len_i ? pj : -1
//   clasp (bl_slChainSop, lib/clasp/slchain.c:568-828):
//     dy = q_i - (q_j + len_j - 1) - 1          int32, wrapping
//     dx = int32(t_i - (t_j + len_j - 1) - 1)   int64 difference, cut
//     link when ok_j, j < i, dy >= 0, dx >= 0;
//     pen = gsop = lam max(dx, dy) + (eps - lam) min(dx, dy);
//     val = dp_j - gsop;
//     dp_i = len_i + max(best, 0), prev_i = best >= 0 ? pj : -1
// Slots at or past count keep dp = -inf and prev = -1.  Then the best end
// (the smallest i among the top dp), the walk back through prev, and the
// chain in ascending qPos: q/t/len of the chain's slots, 0 past its
// length; chain_len; score = float32(best dp), -1 for a window with no
// seed.  The float type F is double (chain_dp_dtype "auto" / "f64") or
// float ("f32").
//
// Exactness.  The plain version runs one eager op per product and sum,
// each rounded on its own, so every product and sum here is written with
// the round-to-nearest intrinsics (__dmul_rn, __dadd_rn, __dsub_rn; the
// f suffixed ones for float): nvcc would otherwise contract a*b + c into
// one fused multiply-add, which rounds once: the reference computes the
// penalty in C doubles with no FMA, each product and sum rounded on its
// own too.  No fast-math.  The integer differences wrap as the plain version's int32 tensors do,
// in unsigned arithmetic (signed overflow is undefined in C++).  reward,
// penalty, lam and eps arrive as doubles, as the cfg holds them, and are
// cast to F here as torch.tensor(x, dtype=F) casts them; eps - lam is
// one F subtraction, as the 0-d tensors make it.  dp-n2's log(max(d, 2))
// comes from the plain version's own table (ops/chain.py log_table: the C
// library's log, made on the host in float64, copied to the card; torch's
// CPU log in float32 for the f32 DP) of log_len entries, which covers
// every d a window of the pipeline can link (d < 3 seq_max_length): a
// load, through L1 for the small d of near pairs, and no log on the card.
// A linked pair whose d lies past the table traps (the launch fails), as
// the plain version's table index raises; only a window whose q or t
// span reaches the table's length can link one (d < the larger span), so
// only such a window tests its pairs.  An unlinked pair's d, whose
// penalty no dp reads, reads entry 0 (no cache line of the table for a d
// that does not link).
//
// Design: one warp per window, several windows a block (wpb, chosen from
// N at launch so that a block's windows fit ~80 KB of shared memory: 4 at
// N = 512, 1 at N = MAX_N = 4096), and no block barrier anywhere.  Each
// window runs to its own count, so both routes of _chain_bucketed (the
// narrow DP and the wide one) are one launch.  The window's valid flags
// are counted 16 a load (__reduce_add_sync over the warp), and q, t, len
// of its first count slots only go to shared memory (33 bytes a slot
// with dp, prev, the chain buffer and the flags).  The seeds run in
// tiles of 32; lane x owns seed i = base + x of the tile at base and
// keeps its running best (bv, bj) in registers:
//   1. the pairs (j, i) for every j < base, whose dp are settled: each
//      lane its own seed's, eight at a time (their integers, then their
//      penalties, then the fold: eight pairs in flight), folded in
//      ascending j (>= keeps the largest j among ties), every lane busy
//      and nothing on the chain of seeds;
//   2. the tile's own penalties pen[s] = pen(base + s, i) for s < x, and
//      their link bits, all 31 at once, before any of their dp exist
//      (the log of every pair is off the chain);
//   3. 32 steps, one broadcast a seed: at step s __shfl_sync hands the
//      owner's (lane s) running best and length to every lane, each lane
//      settles dp of seed base + s from them (the owner keeps dp and
//      prev) and folds val = (dp + reward) - pen[s] into its running
//      best with >=.
// Ascending j in 1 and ascending s in 3 fold the pairs of each seed in
// ascending j, so (bv, bj) ends at the pull form's maximum, tie for tie
// (larger val, then larger j, is a total order).  Only the broadcast,
// the settle, one add, one subtract and one compare wait on the previous
// seed.  Then the best end (a butterfly of (dp, i) pairs: larger dp,
// then smaller i), one walk of prev by lane 0 that writes the chain from
// the back of a length-N buffer, and the whole warp writes the (W, N)
// outputs, 16-byte stores when N % 4 == 0 and the outputs are aligned.
// The grid is ceil(K / wpb) blocks for the batch's K windows (1024 at the
// default batch_reads x compact_windows_per_read).
//
// What bounds it on the card: on windows with few seeds (v2's), the
// launch, the chain of a deep window's steps (~the shuffle's latency
// plus an FP add, subtract and compare each) and the (W, N) output
// bytes; on full windows, the pairs' operations (the integer link test
// of every pair, the float penalty and fold of a linked one, the log
// a table load; chip_smoke.chain_work counts them) and their
// instructions, which steps 1 and 2 issue with every lane busy.  tests/test_torch_chain_kernel.py holds a numpy
// model of this kernel (names as here) against the plain version and the
// JAX package.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWarps = 4;             // windows a block, at most
constexpr size_t kBlockSmem = 80 * 1024;  // shared memory a block aims at
constexpr size_t kMaxSmem = 227 * 1024;   // the most a block can have
constexpr int kDpn2 = 0;
constexpr int kClasp = 1;

template <typename F>
struct Ar;

template <>
struct Ar<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double neg_inf() {
    return __longlong_as_double(0xFFF0000000000000ULL);
  }
};

template <>
struct Ar<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float neg_inf() {
    return __int_as_float(0xFF800000);
  }
};

struct Args {
  const int32_t* q;      // (W, N)
  const void* t;         // (W, N) Pos
  const int32_t* len;    // (W, N)
  const uint8_t* ok;     // (W, N) bool
  int32_t* out_q;        // (W, N)
  void* out_t;           // (W, N) Pos
  int32_t* out_len;      // (W, N)
  int32_t* chain_len;    // (W,)
  float* score;          // (W,)
  void* dp_out;          // (W, N) F, or null
  int64_t* prev_out;     // (W, N), or null
  const void* log_table; // (log_len,) F for dp-n2
  int log_len;
  int W, N;
  double reward, penalty, lam, eps;
  int win_bytes;         // shared memory of one window
  bool vec_ok;           // the flags' rows 16-byte aligned (N % 16 == 0)
  bool vec_out;          // the outputs' rows 16-byte aligned (N % 4 == 0)
};

__device__ __forceinline__ int32_t wrap32(uint64_t x) {
  return static_cast<int32_t>(static_cast<uint32_t>(x));
}

// nonzero bytes of a word
__device__ __forceinline__ int nz_bytes(uint32_t x) {
  return __popc(((((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u));
}

// (dp, i) order of the best end: larger dp, then smaller i
template <typename F>
__device__ __forceinline__ bool beats_end(F v, int i, F bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The integers of the pair (j, i) and whether j links to i: seed i at
// (qi, ti), seed j at (qj, tj) of length lj; dp-n2: ea = d; clasp: ea =
// dx, eb = dy.
template <int kCost>
__device__ __forceinline__ bool pair_ints(uint32_t qi, uint64_t ti,
                                          int32_t qj, int64_t tj, int32_t lj,
                                          int32_t& ea, int32_t& eb) {
  const uint32_t qe = static_cast<uint32_t>(qj) + static_cast<uint32_t>(lj) -
                      1u;
  const uint64_t te = static_cast<uint64_t>(tj) +
                      static_cast<uint64_t>(static_cast<int64_t>(lj)) - 1u;
  if (kCost == kDpn2) {
    const int32_t dr = static_cast<int32_t>(qi - qe);
    const int32_t dt = wrap32(ti - te);
    const int32_t dd = static_cast<int32_t>(static_cast<uint32_t>(dr) -
                                            static_cast<uint32_t>(dt));
    ea = dd < 0 ? static_cast<int32_t>(0u - static_cast<uint32_t>(dd)) : dd;
    eb = 0;
    return dr > 0 && dt > 0;
  } else {
    eb = static_cast<int32_t>(qi - qe - 1u);
    ea = wrap32(ti - te - 1u);
    return eb >= 0 && ea >= 0;
  }
}

// The window's seeds in shared memory, the log table, and the costs'
// constants.
template <typename F>
struct Win {
  const int32_t* q;
  const int64_t* t;
  const int32_t* len;
  const uint8_t* ok;
  const F* lg;
  int n_lg;
  F tenth, penalty, lam, eml;
};

// The penalties pen[u] of the K pairs (j0 + u, i), j clamped to jmax,
// and their link bits (ok_j included) within keep, the pairs the caller
// folds.  All K pairs' integers first, then (dp-n2) all their table loads
// and the products and sums: K independent pairs in flight; with kCheck
// (a window that spans the table), a linked d past the table traps.
template <typename F, int kCost, bool kCheck, int K>
__device__ __forceinline__ uint32_t pens(const Win<F>& w, uint32_t qi,
                                         uint64_t ti, int j0, int jmax,
                                         uint32_t keep, F (&pen)[K]) {
  using A = Ar<F>;
  int32_t ea[K], eb[K];
  uint32_t link = 0;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int j = j0 + u < jmax ? j0 + u : jmax;
    if (pair_ints<kCost>(qi, ti, w.q[j], w.t[j], w.len[j], ea[u], eb[u]) &&
        w.ok[j] != 0) {
      link |= 1u << u;
    }
  }
  link &= keep;
  if (kCost == kDpn2) {
    // the table entries of the linked pairs' d (an unlinked pair's
    // penalty is never read: entry 0, so its d costs no cache line)
    bool far = false;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const bool lk = ((link >> u) & 1u) != 0;
      int e = lk ? ea[u] : 0;
      if (kCheck) {  // a window wide enough to link a d past the table
        far |= e >= w.n_lg;
        e = e < w.n_lg ? e : 0;
      }
      pen[u] = __ldg(w.lg + e);
    }
    if (kCheck && far) __trap();
#pragma unroll
    for (int u = 0; u < K; ++u) {  // pen = 0.1 d + penalty log(max(d, 2))
      pen[u] = ea[u] > 1 ? A::add(A::mul(w.tenth, static_cast<F>(ea[u])),
                                  A::mul(w.penalty, pen[u]))
                         : static_cast<F>(0);
    }
  } else {
#pragma unroll
    for (int u = 0; u < K; ++u) {  // gsop
      const F fx = static_cast<F>(ea[u]);
      const F fy = static_cast<F>(eb[u]);
      const F hi = fx > fy ? fx : fy;
      const F lo = fx < fy ? fx : fy;
      pen[u] = A::add(A::mul(w.lam, hi), A::mul(w.eml, lo));
    }
  }
  return link;
}

// val of a linked pair from its predecessor's dp and its penalty
template <typename F, int kCost>
__device__ __forceinline__ F val_of(F dpj, F pen, F reward) {
  using A = Ar<F>;
  return kCost == kDpn2 ? A::sub(A::add(dpj, reward), pen) : A::sub(dpj, pen);
}

// four values to 16-byte aligned p as one or two 16-byte stores
__device__ __forceinline__ void st4(int32_t* p, int32_t a, int32_t b,
                                    int32_t c, int32_t d) {
  *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(int64_t* p, int64_t a, int64_t b,
                                    int64_t c, int64_t d) {
  reinterpret_cast<longlong2*>(p)[0] = make_longlong2(a, b);
  reinterpret_cast<longlong2*>(p)[1] = make_longlong2(c, d);
}
__device__ __forceinline__ void st4(double* p, double a, double b, double c,
                                    double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}

// Steps 1-3 over a window's count seeds in tiles of 32 (lane x owns seed
// base + x): dp and prev to sdp and sprev.  kCheck: the window spans the
// log table, so its pairs' d are tested against it (pens).
template <typename F, int kCost, bool kCheck>
__device__ __forceinline__ void window_dp(const Win<F>& win, int count,
                                          int lane, F reward, F* sdp,
                                          int32_t* sprev) {
  using A = Ar<F>;
  const F neg_inf = A::neg_inf();
  for (int base = 0; base < count; base += 32) {
    const int i = base + lane;
    const bool own = i < count;
    const int ic = own ? i : count - 1;
    const uint32_t qi = static_cast<uint32_t>(win.q[ic]);
    const uint64_t ti = static_cast<uint64_t>(win.t[ic]);
    const F li = static_cast<F>(win.len[ic]);
    const bool oki = own && win.ok[ic] != 0;
    // 1. the pairs of the settled tiles, 8 at a time, ascending j
    F bv = neg_inf;
    int bj = -1;
    for (int j0 = 0; j0 < base; j0 += 8) {
      F p8[8];
      const uint32_t lk = pens<F, kCost, kCheck, 8>(win, qi, ti, j0,
                                                    base - 1, 0xFFu, p8);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const F val = val_of<F, kCost>(sdp[j0 + u], p8[u], reward);
        if (((lk >> u) & 1u) && val >= bv) {  // the larger j wins a tie
          bv = val;
          bj = j0 + u;
        }
      }
    }
    // 2. the tile's own penalties, before their dp exist
    F pen[31];
    const uint32_t link = pens<F, kCost, kCheck, 31>(
        win, qi, ti, base, count - 1, own ? (1u << lane) - 1u : 0u, pen);
    // 3. one broadcast a seed
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      if (base + s >= count) break;
      // the owner's (lane s) running best and length to every lane, which
      // settles seed base + s; the owner keeps its dp and prev
      const F bvs = __shfl_sync(kFull, bv, s);
      const int bjs = __shfl_sync(kFull, bj, s);
      const F lis = __shfl_sync(kFull, li, s);
      bool take;
      F dps;
      if (kCost == kDpn2) {
        take = bvs > lis;  // strict, like dp[j]+a-b > dp[i] (Chain.cpp:275)
        dps = take ? bvs : lis;
      } else {
        take = bvs >= static_cast<F>(0);  // slchain.c:717-721
        dps = A::add(lis, bvs > static_cast<F>(0) ? bvs : static_cast<F>(0));
      }
      if (lane == s && oki) {
        sdp[i] = dps;
        sprev[i] = take ? bjs : -1;
      }
      if (s < 31 && ((link >> s) & 1u)) {
        const F val = val_of<F, kCost>(dps, pen[s < 31 ? s : 0], reward);
        if (val >= bv) {  // ascending s: the larger j wins a tie
          bv = val;
          bj = base + s;
        }
      }
    }
    __syncwarp();
  }

}

template <typename Pos, typename F, int kCost>
__global__ void __launch_bounds__(kMaxWarps * 32)
chain_dp_kernel(const Args a) {
  using A = Ar<F>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * (blockDim.x >> 5) + warp;  // the window
  if (w >= a.W) return;
  const int N = a.N;
  unsigned char* mine = smem + static_cast<size_t>(warp) * a.win_bytes;
  int64_t* st = reinterpret_cast<int64_t*>(mine);      // t
  F* sdp = reinterpret_cast<F*>(st + N);               // dp
  int32_t* sq = reinterpret_cast<int32_t*>(sdp + N);   // q
  int32_t* slen = sq + N;                              // len
  int32_t* sprev = slen + N;                           // prev
  int32_t* schain = sprev + N;                         // chain, from the back
  uint8_t* sok = reinterpret_cast<uint8_t*>(schain + N);
  const size_t row = static_cast<size_t>(w) * N;
  const F neg_inf = A::neg_inf();

  // the valid flags, counted; q, t, len of the first count slots
  const uint8_t* okr = a.ok + row;
  int count = 0;
  if (a.vec_ok) {
    for (int s = 16 * lane; s < N; s += 16 * 32) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(okr + s));
      *reinterpret_cast<uint4*>(sok + s) = v;
      count += nz_bytes(v.x) + nz_bytes(v.y) + nz_bytes(v.z) + nz_bytes(v.w);
    }
  } else {
    for (int s = lane; s < N; s += 32) {
      const uint8_t v = okr[s];
      sok[s] = v;
      count += v != 0;
    }
  }
  count = static_cast<int>(__reduce_add_sync(kFull,
                                             static_cast<unsigned>(count)));
  const Pos* tin = static_cast<const Pos*>(a.t) + row;
  // dp-n2: the spans of the window's q and t, seeds' starts and ends
  // together; a linked pair's d is below the larger (no difference wraps
  // within a span under 2^31), so a window narrower than the log table
  // needs no check of its pairs' d against it
  int64_t qlo = INT64_MAX, qhi = INT64_MIN, tlo = INT64_MAX, thi = INT64_MIN;
  for (int s = lane; s < count; s += 32) {
    const int32_t qs = a.q[row + s];
    const int64_t ts = static_cast<int64_t>(tin[s]);
    const int32_t ls = a.len[row + s];
    sq[s] = qs;
    st[s] = ts;
    slen[s] = ls;
    sdp[s] = neg_inf;
    sprev[s] = -1;
    if (kCost == kDpn2) {
      const int64_t qe = static_cast<int64_t>(qs) + ls - 1;
      const int64_t te = ts + ls - 1;
      qlo = min(qlo, min(static_cast<int64_t>(qs), qe));
      qhi = max(qhi, max(static_cast<int64_t>(qs), qe));
      tlo = min(tlo, min(ts, te));
      thi = max(thi, max(ts, te));
    }
  }
  bool check = false;
  if (kCost == kDpn2 && count > 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      qlo = min(qlo, __shfl_xor_sync(kFull, qlo, off));
      qhi = max(qhi, __shfl_xor_sync(kFull, qhi, off));
      tlo = min(tlo, __shfl_xor_sync(kFull, tlo, off));
      thi = max(thi, __shfl_xor_sync(kFull, thi, off));
    }
    const uint64_t qspan = static_cast<uint64_t>(qhi) -
                           static_cast<uint64_t>(qlo);
    const uint64_t tspan = static_cast<uint64_t>(thi) -
                           static_cast<uint64_t>(tlo);
    const uint64_t n_lg = static_cast<uint64_t>(a.log_len);
    check = qspan >= n_lg || tspan >= n_lg;
  }
  __syncwarp();

  const F reward = static_cast<F>(a.reward);
  const F lam = static_cast<F>(a.lam);
  const Win<F> win{sq, st, slen, sok, static_cast<const F*>(a.log_table),
                   a.log_len, static_cast<F>(0.1),
                   static_cast<F>(a.penalty), lam,
                   A::sub(static_cast<F>(a.eps), lam)};

  if constexpr (kCost == kDpn2) {
    if (check) {
      window_dp<F, kCost, true>(win, count, lane, reward, sdp, sprev);
    } else {
      window_dp<F, kCost, false>(win, count, lane, reward, sdp, sprev);
    }
  } else {
    window_dp<F, kCost, false>(win, count, lane, reward, sdp, sprev);
  }

  // best end: the smallest i among the top dp
  F ev = neg_inf;
  int ei = N;
  for (int s = lane; s < count; s += 32) {
    if (sdp[s] > ev) {  // ascending s: strict keeps the smaller s
      ev = sdp[s];
      ei = s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const F ov = __shfl_xor_sync(kFull, ev, off);
    const int oi = __shfl_xor_sync(kFull, ei, off);
    if (beats_end(ov, oi, ev, ei)) {
      ev = ov;
      ei = oi;
    }
  }
  int clen = 0;
  if (lane == 0 && ei < count) {  // one walk, the chain from the back
    int k = N;
    for (int cur = ei; cur >= 0; cur = sprev[cur]) schain[--k] = cur;
    clen = N - k;
  }
  clen = __shfl_sync(kFull, clen, 0);
  __syncwarp();
  if (lane == 0) {
    a.chain_len[w] = clen;
    a.score[w] = count > 0 ? static_cast<float>(ev) : -1.0f;
  }

  const int c0 = N - clen;  // schain[c0 + s] is the chain's slot s
  Pos* tout = static_cast<Pos*>(a.out_t) + row;
  F* dp_out = static_cast<F*>(a.dp_out);
  const bool want_dp = dp_out != nullptr;
  if (a.vec_out) {
    for (int s = 4 * lane; s < N; s += 4 * 32) {
      int32_t q4[4], l4[4];
      Pos t4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = s + u < clen ? schain[c0 + s + u] : -1;
        q4[u] = c >= 0 ? sq[c] : 0;
        t4[u] = c >= 0 ? static_cast<Pos>(st[c]) : static_cast<Pos>(0);
        l4[u] = c >= 0 ? slen[c] : 0;
      }
      st4(a.out_q + row + s, q4[0], q4[1], q4[2], q4[3]);
      st4(tout + s, t4[0], t4[1], t4[2], t4[3]);
      st4(a.out_len + row + s, l4[0], l4[1], l4[2], l4[3]);
      if (want_dp) {
        F d4[4];
        int64_t p4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          d4[u] = s + u < count ? sdp[s + u] : neg_inf;
          p4[u] = s + u < count ? sprev[s + u] : -1;
        }
        st4(dp_out + row + s, d4[0], d4[1], d4[2], d4[3]);
        st4(a.prev_out + row + s, p4[0], p4[1], p4[2], p4[3]);
      }
    }
  } else {
    for (int s = lane; s < N; s += 32) {
      const int c = s < clen ? schain[c0 + s] : -1;
      a.out_q[row + s] = c >= 0 ? sq[c] : 0;
      tout[s] = c >= 0 ? static_cast<Pos>(st[c]) : static_cast<Pos>(0);
      a.out_len[row + s] = c >= 0 ? slen[c] : 0;
      if (want_dp) {
        dp_out[row + s] = s < count ? sdp[s] : neg_inf;
        a.prev_out[row + s] = s < count ? sprev[s] : -1;
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename Pos, typename F, int kCost>
int launch(Args a, cudaStream_t stream) {
  const size_t per = (static_cast<size_t>(a.N) *
                          (sizeof(int64_t) + sizeof(F) + 4 * sizeof(int32_t) +
                           1) +
                      15) &
                     ~static_cast<size_t>(15);
  size_t wpb = kBlockSmem / per;
  wpb = wpb < 1 ? 1 : (wpb > kMaxWarps ? kMaxWarps : wpb);
  const size_t smem = wpb * per;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  a.win_bytes = static_cast<int>(per);
  a.vec_ok = a.N % 16 == 0 && aligned16(a.ok);
  a.vec_out = a.N % 4 == 0 && aligned16(a.out_q) && aligned16(a.out_t) &&
              aligned16(a.out_len) &&
              (a.dp_out == nullptr ||
               (aligned16(a.dp_out) && aligned16(a.prev_out)));
  auto kern = chain_dp_kernel<Pos, F, kCost>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((a.W + wpb - 1) / wpb);
  kern<<<grid, static_cast<unsigned>(wpb * 32), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Pos, typename F>
int dispatch_cost(const Args& a, int cost, cudaStream_t stream) {
  return cost == kClasp ? launch<Pos, F, kClasp>(a, stream)
                        : launch<Pos, F, kDpn2>(a, stream);
}

template <typename Pos>
int dispatch_float(const Args& a, int f64, int cost, cudaStream_t stream) {
  return f64 ? dispatch_cost<Pos, double>(a, cost, stream)
             : dispatch_cost<Pos, float>(a, cost, stream);
}

}  // namespace

// q, len (W, N) int32; t (W, N) int32 (pos_bytes 4) or int64 (8); ok (W,
// N) bool; outputs out_q, out_len (W, N) int32, out_t (W, N) like t,
// chain_len (W,) int32, score (W,) float32; dp (W, N) double (f64 = 1) or
// float (0) and prev (W, N) int64, or both null; log_table (log_len,) of
// the DP's float type, log(max(d, 2)) for d = 0..log_len - 1, 16-byte
// aligned, log_len >= 2 (dp-n2; clasp takes null).  cost 0 = dp-n2,
// 1 = clasp.  Returns a cudaError_t (0 on a clean launch).
extern "C" int lf_chain_dp(const void* q, const void* t, const void* len,
                           const void* ok, void* out_q, void* out_t,
                           void* out_len, void* chain_len, void* score,
                           void* dp, void* prev, const void* log_table,
                           int log_len, int W, int N, int pos_bytes, int f64,
                           int cost, double reward, double penalty,
                           double lam, double eps, void* stream) {
  if (N <= 0 || (pos_bytes != 4 && pos_bytes != 8) ||
      (cost != kDpn2 && cost != kClasp) ||
      ((dp == nullptr) != (prev == nullptr)) ||
      (cost == kDpn2 && (log_table == nullptr || !aligned16(log_table) ||
                         log_len < 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (W <= 0) return 0;
  const Args a{static_cast<const int32_t*>(q), t,
               static_cast<const int32_t*>(len),
               static_cast<const uint8_t*>(ok), static_cast<int32_t*>(out_q),
               out_t, static_cast<int32_t*>(out_len),
               static_cast<int32_t*>(chain_len), static_cast<float*>(score),
               dp, static_cast<int64_t*>(prev), log_table, log_len, W, N,
               reward, penalty, lam, eps, 0, false, false};
  auto st = static_cast<cudaStream_t>(stream);
  return pos_bytes == 4 ? dispatch_float<int32_t>(a, f64, cost, st)
                        : dispatch_float<int64_t>(a, f64, cost, st);
}
