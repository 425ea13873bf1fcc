// The chaining DP (dp-n2 or clasp) and its backtrack, one block per
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
//     gsop = lam max(dx, dy) + (eps - lam) min(dx, dy); val = dp_j - gsop;
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
// one fused multiply-add, which rounds once.  log is the CUDA math
// library's (torch's cuda log kernel calls the same ::log); no fast-math.
// The integer differences wrap as the plain version's int32 tensors do,
// in unsigned arithmetic (signed overflow is undefined in C++).  reward,
// penalty, lam and eps arrive as doubles, as the cfg holds them, and are
// cast to F here as torch.tensor(x, dtype=F) casts them; eps - lam is
// one F subtraction, as the 0-d tensors make it.
//
// Design, simple and right first: one block of 128 threads per window,
// looping over i up to the window's own count (no padding to the widest
// window of the batch, so both routes of _chain_bucketed, the narrow DP
// and the wide one, are one launch).  The window's q, t, len, ok and its
// dp and prev live in shared memory (33 bytes a slot for double, 17 KB at
// N = 512).  Thread x owns the slots j = x mod 128: for seed i it takes
// the best (val, j) over its slots j < i (ascending j, so >= keeps the
// largest j among ties), then a 5-step __shfl_down_sync reduction per
// warp and the four warps' pairs through shared memory: larger val wins,
// on equal val the larger j.  The pairs of seed i go to one of two
// buffers (i & 1), so one __syncthreads a seed suffices: a warp that
// writes seed i + 1's pair has passed seed i's barrier, which every warp
// reached after reading seed i - 1's.  Every thread finishes the
// reduction; the owner of slot i writes dp_i and prev_i, which only it
// reads in the loop.  After the loop, a block reduction picks the best end
// (larger dp, on equal dp the smaller i), thread 0 walks prev twice (the
// length, then the slots into shared memory), and the block writes the
// chain.  The grid is the batch's K windows (1024 at the default
// batch_reads x compact_windows_per_read), several blocks an SM.
//
// What bounds it on the card: the chain of seeds within a window.  Seed
// i waits on the barrier of seed i - 1; the work per seed is ceil(i /
// 128) pairs a thread (a log each for dp-n2).  The operations of the
// whole batch (pairs x ~26 FP64 operations, log included) and its bytes
// are microseconds of the card's rates; a window of count n takes ~n
// barrier rounds.  tests/test_torch_chain_kernel.py holds a numpy model
// of this kernel (names as here) against the plain version and the JAX
// package.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
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
  static __device__ __forceinline__ double lg(double a) { return log(a); }
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
  static __device__ __forceinline__ float lg(float a) { return logf(a); }
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
  int W, N;
  double reward, penalty, lam, eps;
};

__device__ __forceinline__ int32_t wrap32(uint64_t x) {
  return static_cast<int32_t>(static_cast<uint32_t>(x));
}

// (val, j) pair order of the predecessor: larger val, then larger j
template <typename F>
__device__ __forceinline__ bool beats_pred(F v, int j, F bv, int bj) {
  return v > bv || (v == bv && j > bj);
}

// (dp, i) order of the best end: larger dp, then smaller i
template <typename F>
__device__ __forceinline__ bool beats_end(F v, int i, F bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename Pos, typename F, int kCost>
__global__ void __launch_bounds__(kThreads)
chain_dp_kernel(const Args a) {
  using A = Ar<F>;
  extern __shared__ __align__(8) unsigned char smem[];
  const int N = a.N;
  int64_t* st = reinterpret_cast<int64_t*>(smem);     // t
  F* sdp = reinterpret_cast<F*>(st + N);               // dp
  int32_t* sq = reinterpret_cast<int32_t*>(sdp + N);   // q
  int32_t* slen = sq + N;                              // len
  int32_t* sprev = slen + N;                           // prev
  int32_t* schain = sprev + N;                         // chain slots
  uint8_t* sok = reinterpret_cast<uint8_t*>(schain + N);
  __shared__ F red_v[2][kWarps];
  __shared__ int red_j[2][kWarps];
  __shared__ int s_clen;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = static_cast<size_t>(blockIdx.x) * N;
  const Pos* tin = static_cast<const Pos*>(a.t) + row;
  const F neg_inf = A::neg_inf();

  int count = 0;
  for (int base = 0; base < N; base += kThreads) {
    const int s = base + tid;
    bool v = false;
    if (s < N) {
      v = a.ok[row + s] != 0;
      sok[s] = v;
      sq[s] = a.q[row + s];
      st[s] = static_cast<int64_t>(tin[s]);
      slen[s] = a.len[row + s];
      sdp[s] = neg_inf;
      sprev[s] = -1;
    }
    count += __syncthreads_count(v);
  }

  const F reward = static_cast<F>(a.reward);
  const F penalty = static_cast<F>(a.penalty);
  const F tenth = static_cast<F>(0.1);
  const F lam = static_cast<F>(a.lam);
  const F eml = A::sub(static_cast<F>(a.eps), lam);

  for (int i = 0; i < count; ++i) {
    const uint32_t qi = static_cast<uint32_t>(sq[i]);
    const uint64_t ti = static_cast<uint64_t>(st[i]);
    F bv = neg_inf;
    int bj = -1;
    for (int j = tid; j < i; j += kThreads) {
      if (!sok[j]) continue;
      const uint32_t qe = static_cast<uint32_t>(sq[j]) +
                          static_cast<uint32_t>(slen[j]) - 1u;
      const uint64_t te = static_cast<uint64_t>(st[j]) +
                          static_cast<uint64_t>(static_cast<int64_t>(slen[j])) -
                          1u;
      F val;
      if (kCost == kDpn2) {
        const int32_t dr = static_cast<int32_t>(qi - qe);
        const int32_t dt = wrap32(ti - te);
        if (dr <= 0 || dt <= 0) continue;
        const int32_t dd = static_cast<int32_t>(
            static_cast<uint32_t>(dr) - static_cast<uint32_t>(dt));
        const int32_t d = dd < 0 ? static_cast<int32_t>(
                                       0u - static_cast<uint32_t>(dd))
                                 : dd;
        F pen = static_cast<F>(0);
        if (d > 1) {
          pen = A::add(A::mul(tenth, static_cast<F>(d)),
                       A::mul(penalty, A::lg(static_cast<F>(d))));
        }
        val = A::sub(A::add(sdp[j], reward), pen);
      } else {
        const int32_t dy = static_cast<int32_t>(qi - qe - 1u);
        const int32_t dx = wrap32(ti - te - 1u);
        if (dy < 0 || dx < 0) continue;
        const F fx = static_cast<F>(dx);
        const F fy = static_cast<F>(dy);
        const F hi = fx > fy ? fx : fy;
        const F lo = fx < fy ? fx : fy;
        const F gsop = A::add(A::mul(lam, hi), A::mul(eml, lo));
        val = A::sub(sdp[j], gsop);
      }
      if (val >= bv) {  // ascending j: the larger j wins a tie
        bv = val;
        bj = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const F ov = __shfl_down_sync(kFull, bv, off);
      const int oj = __shfl_down_sync(kFull, bj, off);
      if (beats_pred(ov, oj, bv, bj)) {
        bv = ov;
        bj = oj;
      }
    }
    const int buf = i & 1;
    if (lane == 0) {
      red_v[buf][warp] = bv;
      red_j[buf][warp] = bj;
    }
    __syncthreads();
    if (tid == (i & (kThreads - 1))) {
      F best = red_v[buf][0];
      int pj = red_j[buf][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        if (beats_pred(red_v[buf][w], red_j[buf][w], best, pj)) {
          best = red_v[buf][w];
          pj = red_j[buf][w];
        }
      }
      const F li = static_cast<F>(slen[i]);
      F dpi;
      bool take;
      if (kCost == kDpn2) {
        take = best > li;  // strict, like dp[j]+a-b > dp[i] (Chain.cpp:275)
        dpi = take ? best : li;
      } else {
        take = best >= static_cast<F>(0);  // slchain.c:717-721
        dpi = A::add(li, best > static_cast<F>(0) ? best
                                                  : static_cast<F>(0));
      }
      if (sok[i]) {
        sdp[i] = dpi;
        sprev[i] = take ? pj : -1;
      }
    }
  }
  __syncthreads();

  // best end: the smallest i among the top dp
  F bv = neg_inf;
  int bi = N;
  for (int s = tid; s < count; s += kThreads) {
    if (sdp[s] > bv) {  // ascending s: strict keeps the smaller s
      bv = sdp[s];
      bi = s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const F ov = __shfl_down_sync(kFull, bv, off);
    const int oi = __shfl_down_sync(kFull, bi, off);
    if (beats_end(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_v[0][warp] = bv;
    red_j[0][warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    F best = red_v[0][0];
    int best_i = red_j[0][0];
    for (int w = 1; w < kWarps; ++w) {
      if (beats_end(red_v[0][w], red_j[0][w], best, best_i)) {
        best = red_v[0][w];
        best_i = red_j[0][w];
      }
    }
    int clen = 0;
    if (count > 0) {
      for (int cur = best_i; cur >= 0; cur = sprev[cur]) ++clen;
      int k = clen;
      for (int cur = best_i; cur >= 0; cur = sprev[cur]) schain[--k] = cur;
    }
    s_clen = clen;
    a.chain_len[blockIdx.x] = clen;
    a.score[blockIdx.x] = count > 0 ? static_cast<float>(best) : -1.0f;
  }
  __syncthreads();

  const int clen = s_clen;
  Pos* tout = static_cast<Pos*>(a.out_t) + row;
  F* dp_out = static_cast<F*>(a.dp_out);
  for (int s = tid; s < N; s += kThreads) {
    if (s < clen) {
      const int c = schain[s];
      a.out_q[row + s] = sq[c];
      tout[s] = static_cast<Pos>(st[c]);
      a.out_len[row + s] = slen[c];
    } else {
      a.out_q[row + s] = 0;
      tout[s] = 0;
      a.out_len[row + s] = 0;
    }
    if (dp_out != nullptr) {
      dp_out[row + s] = sdp[s];
      a.prev_out[row + s] = sprev[s];
    }
  }
}

template <typename Pos, typename F, int kCost>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.N) *
                      (sizeof(int64_t) + sizeof(F) + 4 * sizeof(int32_t) + 1);
  auto kern = chain_dp_kernel<Pos, F, kCost>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<a.W, kThreads, smem, stream>>>(a);
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
// float (0) and prev (W, N) int64, or both null.  cost 0 = dp-n2, 1 =
// clasp.  Returns a cudaError_t (0 on a clean launch).
extern "C" int lf_chain_dp(const void* q, const void* t, const void* len,
                           const void* ok, void* out_q, void* out_t,
                           void* out_len, void* chain_len, void* score,
                           void* dp, void* prev, int W, int N, int pos_bytes,
                           int f64, int cost, double reward, double penalty,
                           double lam, double eps, void* stream) {
  if (N <= 0 || (pos_bytes != 4 && pos_bytes != 8) ||
      (cost != kDpn2 && cost != kClasp) ||
      ((dp == nullptr) != (prev == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (W <= 0) return 0;
  const Args a{static_cast<const int32_t*>(q), t,
               static_cast<const int32_t*>(len),
               static_cast<const uint8_t*>(ok), static_cast<int32_t*>(out_q),
               out_t, static_cast<int32_t*>(out_len),
               static_cast<int32_t*>(chain_len), static_cast<float*>(score),
               dp, static_cast<int64_t*>(prev), W, N, reward, penalty, lam,
               eps};
  auto st = static_cast<cudaStream_t>(stream);
  return pos_bytes == 4 ? dispatch_float<int32_t>(a, f64, cost, st)
                        : dispatch_float<int64_t>(a, f64, cost, st);
}
