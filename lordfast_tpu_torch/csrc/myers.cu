// Batched Myers bit-parallel edit distance, for NVIDIA Hopper (sm_90a):
// one fill, in two modes.
//
// Replaces the two Pallas TPU kernels of lordfast_tpu/ops/gap_dp_pallas.py,
// _make_kernel (:84) and _make_kernel_tiled (:290), reached through
// gap_align_pl (:513):
//   - lf_myers_dist (kPath = false): dist and end only, the engine's main
//     path (the host stitcher rebuilds each path with the banded edlib
//     traceback); optionally the Pv/Mv words of the last column, from
//     which the escalation offload reads a middle column's scores for
//     edlib's Hirschberg split;
//   - lf_myers_moves (kPath = true): dist, end, lead and the per-column
//     move codes of the escalation offload's secondary NW segments
//     (colcode (T, G) uint16, (run << 2) | move per column c <= end, zero
//     past end; forward path = [INSERT]*lead + concat_c([move_c] +
//     [INSERT]*run_c)).
//
// Semantics (must equal myers_dist_plain / myers_moves_plain in
// ops/gap_dp.py bit for bit): for gap g, the Myers column recurrence of
// edlib's calculateBlock with 32-bit words chained through hin/hout, top
// boundary hin = +1, initial score ql, the score following bit (ql-1)&31
// of word bw = (ql-1)>>5.  NW returns the score at column tl-1; SHW the
// smallest score over columns < tl (smallest column among ties), against
// edlib's negative-end artifact: with W64 = (64 - ql % 64) % 64, position
// -1 scores min(ql, min_{1<=j<=min(W64,tl)} d_j + j) and wins ties
// (end = -1).  The traceback keeps two decision planes, "up" = the Pv word
// after column c and "left" = the pre-shift Ph word of column c; it starts
// at row ql-1 and walks columns end..0: in column c the run of
// consume-query moves ends at the highest clear "up" bit p <= r; at p the
// move is DELETE when p < 0 or the "left" bit is set, else MATCH or
// MISMATCH by q[p] == t[c] (N equals N, as Peq row 4 does); then r = p
// (DELETE) or p - 1.  lead = r + 1 after column 0.
//
// What bounds it on the card: a serial dependency chain, not bytes.  Each
// column's words are chained through the hin/hout carry (~20 integer
// operations a word-step, most of them on the chain), and each column
// needs the one before, so a gap's latency is about columns x words x
// chain length; the inputs are a few bytes a column.  The path adds 8
// bytes stored a word-step and a walk back of one dependent step a column.
// The design per W = Q/32 is chosen once, in launch():
//
// - W <= 4 (buckets of G = 512-8192 gaps): one thread per gap
//   (myers_thread_kernel).  Many gaps keep enough chains in flight; the
//   word loops are unrolled, so Peq/Pv/Mv stay in registers.  Planes
//   (c * W + w) * G + g, so a warp's stores for one (column, word) are
//   contiguous.  Blocks of 128 threads (32 in path mode): 32-thread
//   blocks in distance mode were within 4% on an H100 80GB HBM3, inside
//   the spread of two rounds of one build.
// - W >= 8 (buckets (256, 320, 2048), (512, 576, 1024), (2048, 2176,
//   64), (4096, 4352, 32)): one warp per gap (myers_warp_kernel; at W = 8
//   it took 0.074 ms against the thread kernel's 0.135 ms on an H100
//   80GB HBM3), the word chain split across lanes as
//   a diagonal wavefront.  Lane l owns words [l K, l K +
//   K), K = ceil(W / 32) (1, 2 or 4), and keeps their Peq, Pv and Mv in
//   registers (no stack frame).  At step s it runs column c = s - l,
//   taking the carry into its first word from lane l - 1's carry out of
//   step s - 1 (__shfl_up_sync; lane 0 takes the top boundary +1).  Only
//   lanes up to lb = bw / K work; the pipeline runs tl + lb steps and
//   lane lb keeps the score.  All 32 lanes stay in the loop, with
//   predicated work, because the shuffles take the full mask; a step's
//   carry leaves by shuffle before its stores and score.  The gap's
//   target (and, for the walk, its query) is staged in shared memory with
//   16-byte loads.  With the path, word w of column c is stored at plane
//   row c + w / K of the gap's ((T + 32) x W)-word scratch, so one step's
//   stores from the lanes are contiguous (K words each, one vector
//   store).  The walk back stays serial per gap but the warp helps: the
//   lanes load row r's "up" and "left" words of the next 32 columns at
//   once and the walk reads them by shuffle, reloading only when r's word
//   changes or the 32 columns are used; lane i keeps column cb - i's
//   result of a 32-column window, and the query/target reads of the
//   moves and the code stores run once a window, off the chain.  One
//   warp a block, so that G = 32 gaps spread over 32 SMs.
//
// tests/test_torch_myers_wavefront.py holds a numpy model of the warp
// schedule (names as here) against the plain versions and the JAX kernel.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOpMatch = 0, kOpDelete = 2, kOpMismatch = 3;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kLanes = 32;

// threads per block of the thread kernel
template <bool kPath>
constexpr int kBlock = kPath ? 32 : 128;

// The match mask of target code tc from the five Peq words.
__device__ __forceinline__ uint32_t peq_of(uint32_t tc, uint32_t p0,
                                           uint32_t p1, uint32_t p2,
                                           uint32_t p3, uint32_t p4) {
  uint32_t e = p0;
  e = tc == 1 ? p1 : e;
  e = tc == 2 ? p2 : e;
  e = tc == 3 ? p3 : e;
  e = tc == 4 ? p4 : e;
  return e;
}

// Peq words of the 32 query codes in `codes` (8 codes per uint2 half).
__device__ __forceinline__ void build_peq(const uint32_t (&codes)[8],
                                          uint32_t& m0, uint32_t& m1,
                                          uint32_t& m2, uint32_t& m3,
                                          uint32_t& m4) {
  m0 = m1 = m2 = m3 = m4 = 0u;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const uint32_t ch = (codes[r >> 2] >> (8 * (r & 3))) & 0xFFu;
    const uint32_t bit = 1u << r;
    m0 |= ch == 0 ? bit : 0u;
    m1 |= ch == 1 ? bit : 0u;
    m2 |= ch == 2 ? bit : 0u;
    m3 |= ch == 3 ? bit : 0u;
    m4 |= ch == 4 ? bit : 0u;
  }
}

// One word of edlib's calculateBlock, with the carry folded into e | hm:
// updates pv/mv for match mask e and carry-in (hp, hm), leaves the
// carry-out in (hp, hm), and returns the pre-shift Ph and Mh words.
struct PhMh {
  uint32_t ph, mh;
};
__device__ __forceinline__ PhMh word_step(uint32_t e, uint32_t& pv,
                                          uint32_t& mv, uint32_t& hp,
                                          uint32_t& hm) {
  const uint32_t p = pv;
  const uint32_t m = mv;
  const uint32_t xv = e | m;
  const uint32_t e2 = e | hm;
  const uint32_t xh = (((e2 & p) + p) ^ p) | e2;
  const uint32_t ph = m | ~(xh | p);
  const uint32_t mh = p & xh;
  const uint32_t ph_s = (ph << 1) | hp;
  const uint32_t mh_s = (mh << 1) | hm;
  pv = mh_s | ~(xv | ph_s);
  mv = ph_s & xv;
  hp = ph >> 31;
  hm = mh >> 31;
  return {ph, mh};
}

// The bottom row's score over the columns, and the NW / SHW result.
struct Score {
  int qlen, tlen, bb, w64, neg1_cap;
  int score, nw_dist = INT_MAX, best = INT_MAX, best_end = -2, neg1;

  __device__ Score(int ql, int tl)
      : qlen(ql), tlen(tl), bb((ql - 1) & 31),
        w64((64 - ql % 64) % 64),  // edlib WORD_SIZE=64 padding
        neg1_cap(min(w64, tl)),
        score(ql),                  // D(ql-1, -1) = ql
        neg1(w64 >= 1 ? ql : INT_MAX) {}  // j = 0 term: d_0 + 0 = ql

  // column c's pre-shift Ph / Mh words of the bottom row's word
  __device__ void add(int c, uint32_t ph_b, uint32_t mh_b) {
    score += static_cast<int>((ph_b >> bb) & 1u) -
             static_cast<int>((mh_b >> bb) & 1u);
    if (c == tlen - 1) nw_dist = score;
    if (score < best) {
      best = score;
      best_end = c;
    }
    if (c + 1 <= neg1_cap) neg1 = min(neg1, score + c + 1);
  }

  __device__ void result(bool shw, int& d, int& e) const {
    if (!shw) {
      d = nw_dist;
      e = tlen - 1;
    } else if (w64 >= 1 && neg1 <= best) {
      d = neg1;
      e = -1;
    } else if (best_end == -2) {
      d = qlen;
      e = -1;
    } else {
      d = best;
      e = best_end;
    }
  }
};

// The last column's word w (of bottom word bw, bit bb) for col: rows
// >= ql cleared.
__device__ __forceinline__ uint32_t col_keep(int w, int bw, int bb) {
  const uint32_t low = bb == 31 ? 0xFFFFFFFFu : ((1u << (bb + 1)) - 1u);
  return w < bw ? 0xFFFFFFFFu : (w == bw ? low : 0u);
}

struct Args {
  const uint8_t* qs;
  const int32_t* ql;
  const uint8_t* ts;
  const int32_t* tl;
  const uint8_t* is_shw;
  int32_t* dist;
  int32_t* end;
  uint32_t* col;      // !kPath, may be null: (2 * W, G)
  int32_t* lead;      // kPath
  uint16_t* colcode;  // kPath: (T, G)
  uint32_t* up;       // kPath: (T + 32) * W * G words each
  uint32_t* left;
  int G, Q, T;
};

// ---------------------------------------------------------------------
// One thread per gap (W <= 4: the word loops unroll).
template <int W, bool kPath>
__global__ void __launch_bounds__(kBlock<kPath>)
myers_thread_kernel(const Args a) {
  static_assert(W <= 4, "unrolled word loops");
  const int g = blockIdx.x * kBlock<kPath> + threadIdx.x;
  const int G = a.G;
  if (g >= G) return;
  // callers guarantee 1 <= ql <= Q and 1 <= tl <= T; the clamps only
  // keep a bad descriptor from reading outside its rows
  const int qlen = min(max(a.ql[g], 1), a.Q);
  const int tlen = min(max(a.tl[g], 1), a.T);
  const int bw = (qlen - 1) >> 5;
  // plane word (c, w) of this gap
  auto at = [&](int c, int w) {
    return (static_cast<size_t>(c) * W + w) * G + g;
  };

  uint32_t peq0[W], peq1[W], peq2[W], peq3[W], peq4[W];
  uint32_t pv[W], mv[W];
  const uint8_t* q = a.qs + static_cast<size_t>(g) * a.Q;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (w > bw) break;
    const uint4* src = reinterpret_cast<const uint4*>(q + w * 32);
    const uint4 lo = src[0], hi = src[1];
    const uint32_t codes[8] = {lo.x, lo.y, lo.z, lo.w,
                               hi.x, hi.y, hi.z, hi.w};
    build_peq(codes, peq0[w], peq1[w], peq2[w], peq3[w], peq4[w]);
    pv[w] = 0xFFFFFFFFu;
    mv[w] = 0u;
  }

  Score sc(qlen, tlen);
  const uint8_t* t = a.ts + static_cast<size_t>(g) * a.T;
  for (int c = 0; c < tlen; ++c) {
    const uint32_t tc = t[c];
    uint32_t hp = 1u;  // top boundary: hin = +1
    uint32_t hm = 0u;
    uint32_t ph_b = 0u, mh_b = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (w > bw) break;
      const uint32_t e =
          peq_of(tc, peq0[w], peq1[w], peq2[w], peq3[w], peq4[w]);
      const PhMh h = word_step(e, pv[w], mv[w], hp, hm);
      if constexpr (kPath) {
        a.up[at(c, w)] = pv[w];
        a.left[at(c, w)] = h.ph;
      }
      if (w == bw) {
        ph_b = h.ph;
        mh_b = h.mh;
      }
    }
    sc.add(c, ph_b, mh_b);
  }

  int d, e;
  sc.result(a.is_shw[g], d, e);
  a.dist[g] = d;
  a.end[g] = e;

  if constexpr (!kPath) {
    if (a.col == nullptr) return;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t keep = col_keep(w, bw, sc.bb);
      a.col[static_cast<size_t>(w) * G + g] = w <= bw ? pv[w] & keep : 0u;
      a.col[static_cast<size_t>(W + w) * G + g] =
          w <= bw ? mv[w] & keep : 0u;
    }
  } else {
    // ---- traceback: columns past end get code 0, then end..0 ----
    for (int c = a.T - 1; c > e; --c) {
      a.colcode[static_cast<size_t>(c) * G + g] = 0;
    }
    int r = qlen - 1;
    for (int c = e; c >= 0; --c) {
      // the highest clear "up" bit at or below row r
      int p = -1;
      if (r >= 0) {
        const int rb = r & 31;
        uint32_t mask = rb == 31 ? 0xFFFFFFFFu : ((1u << (rb + 1)) - 1u);
        for (int w = r >> 5; w >= 0; --w) {
          const uint32_t z = ~a.up[at(c, w)] & mask;
          if (z != 0u) {
            p = 32 * w + 31 - __clz(z);
            break;
          }
          mask = 0xFFFFFFFFu;
        }
      }
      const int run = r - p;
      bool is_del = p < 0;
      if (!is_del) is_del = (a.left[at(c, p >> 5)] >> (p & 31)) & 1u;
      const int move = is_del ? kOpDelete
                              : (q[p] == t[c] ? kOpMatch : kOpMismatch);
      a.colcode[static_cast<size_t>(c) * G + g] =
          static_cast<uint16_t>(move | (run << 2));
      r = is_del ? p : p - 1;
    }
    a.lead[g] = r + 1;
  }
}

// ---------------------------------------------------------------------
// One warp per gap: the diagonal wavefront described above.

// K consecutive words, stored as one vector.
template <int K>
__device__ __forceinline__ void store_words(uint32_t* dst,
                                            const uint32_t (&v)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

template <int W, bool kPath>
__global__ void __launch_bounds__(kLanes) myers_warp_kernel(const Args a) {
  constexpr int K = (W + kLanes - 1) / kLanes;
  static_assert(W % K == 0, "lanes own whole words");
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int G = a.G, T = a.T;
  const int qlen = min(max(a.ql[g], 1), a.Q);
  const int tlen = min(max(a.tl[g], 1), T);
  const int bw = (qlen - 1) >> 5;
  const int lb = bw / K;       // the bottom word's lane
  const int jb = bw - lb * K;  // and its place there

  // the gap's target bytes, then (kPath) its query bytes; T % 16 == 0
  extern __shared__ uint4 smem[];
  uint8_t* t_sh = reinterpret_cast<uint8_t*>(smem);
  uint8_t* q_sh = t_sh + T;
  const uint8_t* q = a.qs + static_cast<size_t>(g) * a.Q;
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        a.ts + static_cast<size_t>(g) * T);
    for (int i = lane; i < (tlen + 15) >> 4; i += kLanes) smem[i] = src[i];
    if constexpr (kPath) {
      const uint4* qsrc = reinterpret_cast<const uint4*>(q);
      uint4* qdst = reinterpret_cast<uint4*>(q_sh);
      for (int i = lane; i < (qlen + 15) >> 4; i += kLanes) {
        qdst[i] = qsrc[i];
      }
    }
  }

  uint32_t peq0[K], peq1[K], peq2[K], peq3[K], peq4[K], pv[K], mv[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    peq0[j] = peq1[j] = peq2[j] = peq3[j] = peq4[j] = 0u;
    pv[j] = 0xFFFFFFFFu;
    mv[j] = 0u;
    if (lane <= lb) {  // lb * K + K <= W: the words lie in the row
      const uint4* src =
          reinterpret_cast<const uint4*>(q + (lane * K + j) * 32);
      const uint4 lo = src[0], hi = src[1];
      const uint32_t codes[8] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
      build_peq(codes, peq0[j], peq1[j], peq2[j], peq3[j], peq4[j]);
    }
  }
  __syncwarp();

  // plane row s of the gap: word w of column c sits at row c + w / K
  const size_t plane0 = static_cast<size_t>(g) * (T + 32) * W;
  Score sc(qlen, tlen);
  // carry into this lane's first word (bit 0 hp, bit 1 hm): lane l - 1's
  // carry out of the step before; lane 0 always takes the top boundary
  uint32_t hin = 1u;
  const int steps = tlen + lb;
  for (int s = 0; s < steps; ++s) {
    // every lane runs the step's arithmetic and commits it only where
    // active, so the step stays one branch-free block
    const int c = s - lane;
    const bool act = lane <= lb && c >= 0 && c < tlen;
    const uint32_t tc = t_sh[min(max(c, 0), tlen - 1)];
    uint32_t hp = hin & 1u, hm = hin >> 1;
    uint32_t ph_b = 0u, mh_b = 0u, up_w[K], left_w[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint32_t e =
          peq_of(tc, peq0[j], peq1[j], peq2[j], peq3[j], peq4[j]);
      uint32_t p = pv[j], m = mv[j];
      const PhMh h = word_step(e, p, m, hp, hm);
      pv[j] = act ? p : pv[j];
      mv[j] = act ? m : mv[j];
      up_w[j] = p;
      left_w[j] = h.ph;
      ph_b = j == jb ? h.ph : ph_b;
      mh_b = j == jb ? h.mh : mh_b;
    }
    // the carry out leaves for lane l + 1 before the stores and the
    // score, which the next step does not wait for
    hin = __shfl_up_sync(kFull, hp | (hm << 1), 1);
    hin = lane == 0 ? 1u : hin;
    if constexpr (kPath) {
      if (act) {
        const size_t at = plane0 + static_cast<size_t>(s) * W + lane * K;
        store_words<K>(a.up + at, up_w);
        store_words<K>(a.left + at, left_w);
      }
    }
    if (act && lane == lb) sc.add(c, ph_b, mh_b);
  }

  int d, e;
  sc.result(a.is_shw[g], d, e);
  if (lane == lb) {
    a.dist[g] = d;
    a.end[g] = e;
  }

  if constexpr (!kPath) {
    if (a.col == nullptr) return;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int w = lane * K + j;
      if (w < W) {
        const uint32_t keep = col_keep(w, bw, sc.bb);
        a.col[static_cast<size_t>(w) * G + g] = pv[j] & keep;
        a.col[static_cast<size_t>(W + w) * G + g] = mv[j] & keep;
      }
    }
  } else {
    // ---- traceback, one walk for the whole warp ----
    e = __shfl_sync(kFull, e, lb);
    for (int c = e + 1 + lane; c < T; c += kLanes) {
      a.colcode[static_cast<size_t>(c) * G + g] = 0;
    }
    __syncwarp();  // the lanes' plane stores before any lane reads them
    auto plane = [&](int c, int w) {
      return plane0 + static_cast<size_t>(c + w / K) * W + w;
    };
    // The walk is one chain of dependent steps; the lanes run it
    // together (every value below is warp-uniform) and keep the
    // per-column results of a window of 32 columns, lane i column
    // cb - i, so that the query/target loads of the moves and the code
    // stores leave the chain and run once a window, in parallel.
    int r = qlen - 1;
    int cw = 0, wr = -1;  // lane i holds row word wr of column cw - i
    uint32_t up_i = 0u, left_i = 0u;
    for (int cb = e; cb >= 0; cb -= kLanes) {
      int my_p = 0, my_run = 0;
      bool my_del = true;
      const int n = min(kLanes, cb + 1);
      for (int i = 0; i < n; ++i) {
        const int c = cb - i;
        int p = -1;
        uint32_t lword = 0u;  // "left" word of p's word
        if (r >= 0) {
          const int rw = r >> 5;
          // read ahead of the test, which rarely fails
          uint32_t u = __shfl_sync(kFull, up_i, (cw - c) & 31);
          uint32_t lf = __shfl_sync(kFull, left_i, (cw - c) & 31);
          if (rw != wr || cw - c >= kLanes) {
            cw = c;
            wr = rw;
            const int cc = c - lane;
            up_i = cc >= 0 ? a.up[plane(cc, rw)] : 0u;
            left_i = cc >= 0 ? a.left[plane(cc, rw)] : 0u;
            u = __shfl_sync(kFull, up_i, 0);
            lf = __shfl_sync(kFull, left_i, 0);
          }
          const int rb = r & 31;
          uint32_t z =
              ~u & (rb == 31 ? 0xFFFFFFFFu : ((1u << (rb + 1)) - 1u));
          if (z != 0u) {
            p = 32 * rw + 31 - __clz(z);
            lword = lf;
          } else {
            for (int w = rw - 1; w >= 0; --w) {
              z = ~a.up[plane(c, w)];
              if (z != 0u) {
                p = 32 * w + 31 - __clz(z);
                lword = a.left[plane(c, w)];
                break;
              }
            }
          }
        }
        const bool is_del = p < 0 || ((lword >> (p & 31)) & 1u);
        my_p = lane == i ? p : my_p;
        my_run = lane == i ? r - p : my_run;
        my_del = lane == i ? is_del : my_del;
        r = is_del ? p : p - 1;
      }
      if (lane < n) {
        const int c = cb - lane;
        const int move =
            my_del ? kOpDelete
                   : (q_sh[max(my_p, 0)] == t_sh[c] ? kOpMatch
                                                   : kOpMismatch);
        a.colcode[static_cast<size_t>(c) * G + g] =
            static_cast<uint16_t>(move | (my_run << 2));
      }
    }
    if (lane == 0) a.lead[g] = r + 1;
  }
}

template <int W, bool kPath>
void launch(const Args& a, cudaStream_t stream) {
  if constexpr (W >= 8) {
    const size_t smem = a.T + (kPath ? a.Q : 0);
    myers_warp_kernel<W, kPath><<<a.G, kLanes, smem, stream>>>(a);
  } else {
    constexpr int block = kBlock<kPath>;
    myers_thread_kernel<W, kPath><<<(a.G + block - 1) / block, block, 0,
                                    stream>>>(a);
  }
}

template <bool kPath>
int dispatch(const Args& a, void* stream) {
  if (a.G <= 0) return 0;
  // 16-byte loads of the rows: Q % 32 == 0 by the bucket, T % 16 here
  if (a.T % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (a.Q / 32) {
    case 1: launch<1, kPath>(a, st); break;
    case 2: launch<2, kPath>(a, st); break;
    case 4: launch<4, kPath>(a, st); break;
    case 8: launch<8, kPath>(a, st); break;
    case 16: launch<16, kPath>(a, st); break;
    case 64: launch<64, kPath>(a, st); break;
    case 128: launch<128, kPath>(a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`
// without synchronising and returns cudaGetLastError() (0 = launched).
// qs and ts rows must start on 16-byte boundaries.

// dist / end; col: null, or (2 * Q/32, G) uint32 for the last column's
// Pv and Mv words.
extern "C" int lf_myers_dist(const void* qs, const void* ql, const void* ts,
                             const void* tl, const void* is_shw, void* dist,
                             void* end, void* col, int G, int Q, int T,
                             void* stream) {
  Args a{static_cast<const uint8_t*>(qs), static_cast<const int32_t*>(ql),
         static_cast<const uint8_t*>(ts), static_cast<const int32_t*>(tl),
         static_cast<const uint8_t*>(is_shw), static_cast<int32_t*>(dist),
         static_cast<int32_t*>(end), static_cast<uint32_t*>(col),
         nullptr, nullptr, nullptr, nullptr, G, Q, T};
  return dispatch<false>(a, stream);
}

// dist / end / lead / colcode; up / left: scratch of (T + 32) * Q/32 * G
// uint32 each.
extern "C" int lf_myers_moves(const void* qs, const void* ql, const void* ts,
                              const void* tl, const void* is_shw, void* dist,
                              void* end, void* lead, void* colcode, void* up,
                              void* left, int G, int Q, int T, void* stream) {
  Args a{static_cast<const uint8_t*>(qs), static_cast<const int32_t*>(ql),
         static_cast<const uint8_t*>(ts), static_cast<const int32_t*>(tl),
         static_cast<const uint8_t*>(is_shw), static_cast<int32_t*>(dist),
         static_cast<int32_t*>(end), nullptr, static_cast<int32_t*>(lead),
         static_cast<uint16_t*>(colcode), static_cast<uint32_t*>(up),
         static_cast<uint32_t*>(left), G, Q, T};
  return dispatch<true>(a, stream);
}
