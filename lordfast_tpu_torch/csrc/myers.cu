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
// of word (ql-1)>>5.  NW returns the score at column tl-1; SHW the
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
// Design: one thread per gap.  A thread loops over its own columns
// c < tl[g] and its own words w <= (ql[g]-1)>>5 only.  Both bounds are
// exact: columns at or beyond tl feed none of the outputs, and carries
// run from low rows to high rows, so words above the bottom row's word
// cannot change it.  W (words of the bucket's padded query) is a template
// parameter: up to W = 16 the word loops are unrolled and Peq/Pv/Mv stay
// in registers; W = 64 and 128 keep them in local memory.  Peq is built
// per thread from the query codes.  With the path, the thread stores the
// two planes to a global scratch that the wrapper allocates, laid out
// (T*W, G) as on the TPU so that a warp's stores for one (column, word)
// are contiguous, then walks back from its end reading one or a few plane
// words per column; no tiling or checkpointing is needed, since the
// planes of the largest bucket at full G (4352 x 128 words x 32 gaps x 2
// planes x 4 B = 143 MB) fit device memory.  Path blocks hold 32 threads,
// so that the small-G buckets spread over several SMs.
//
// What bounds it on the card: integer ALU issue, with a serial dependency
// chain of ~20 operations per word-step and W words per column (the
// hin/hout carry), so a thread's latency is ~columns x words x chain
// length; without the path, memory traffic is one target byte per column.
// The path adds the plane traffic, 8 bytes stored per word-step and a few
// words read back per column — of the order of the bytes any traceback of
// the full DP must move, far above the bytes of the inputs and outputs.
// One gap per thread keeps enough independent chains in flight only when
// a bucket holds thousands of gaps; the big buckets (G = 64 and 32) run
// few threads for many cycles.  Later work: a warp per gap with the word
// chain split across lanes, TMA-staged targets, and planes kept in shared
// memory per column tile.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOpMatch = 0, kOpDelete = 2, kOpMismatch = 3;

// threads per block
template <bool kPath>
constexpr int kBlock = kPath ? 32 : 128;

// col (!kPath, may be null): (2 * W, G) — the Pv words then the Mv words
// after column tl-1, bits of rows >= ql cleared.  lead / colcode / up /
// left: kPath only.
template <int W, bool kPath>
__global__ void __launch_bounds__(kBlock<kPath>)
myers_kernel(const uint8_t* __restrict__ qs,
             const int32_t* __restrict__ ql,
             const uint8_t* __restrict__ ts,
             const int32_t* __restrict__ tl,
             const uint8_t* __restrict__ is_shw,
             int32_t* __restrict__ dist_out,
             int32_t* __restrict__ end_out,
             uint32_t* __restrict__ col,
             int32_t* __restrict__ lead_out,
             uint16_t* __restrict__ colcode,
             uint32_t* __restrict__ up,
             uint32_t* __restrict__ left,
             int G, int Q, int T) {
  const int g = blockIdx.x * kBlock<kPath> + threadIdx.x;
  if (g >= G) return;
  // callers guarantee 1 <= ql <= Q and 1 <= tl <= T; the clamps only
  // keep a bad descriptor from reading outside its rows
  const int qlen = min(max(ql[g], 1), Q);
  const int tlen = min(max(tl[g], 1), T);
  const int bw = (qlen - 1) >> 5;
  const int bb = (qlen - 1) & 31;
  constexpr bool kUnroll = W <= 16;
  // plane word (c, w) of this gap
  auto at = [&](int c, int w) {
    return (static_cast<size_t>(c) * W + w) * G + g;
  };

  uint32_t peq0[W], peq1[W], peq2[W], peq3[W], peq4[W];
  uint32_t pv[W], mv[W];

  const uint8_t* q = qs + static_cast<size_t>(g) * Q;
  auto build_word = [&](int w) {
    uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0, m4 = 0;
    const uint8_t* qw = q + w * 32;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const uint32_t ch = qw[r];
      const uint32_t bit = 1u << r;
      m0 |= ch == 0 ? bit : 0u;
      m1 |= ch == 1 ? bit : 0u;
      m2 |= ch == 2 ? bit : 0u;
      m3 |= ch == 3 ? bit : 0u;
      m4 |= ch == 4 ? bit : 0u;
    }
    peq0[w] = m0;
    peq1[w] = m1;
    peq2[w] = m2;
    peq3[w] = m3;
    peq4[w] = m4;
    pv[w] = 0xFFFFFFFFu;
    mv[w] = 0u;
  };
  if constexpr (kUnroll) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (w > bw) break;
      build_word(w);
    }
  } else {
#pragma unroll 1
    for (int w = 0; w <= bw; ++w) build_word(w);
  }

  int score = qlen;  // D(ql-1, -1) = ql
  int nw_dist = INT_MAX;
  int best = INT_MAX;
  int best_end = -2;
  const int w64 = (64 - qlen % 64) % 64;  // edlib WORD_SIZE=64 padding
  const int neg1_cap = min(w64, tlen);
  int neg1 = w64 >= 1 ? qlen : INT_MAX;  // j = 0 term: d_0 + 0 = ql

  const uint8_t* t = ts + static_cast<size_t>(g) * T;
  for (int c = 0; c < tlen; ++c) {
    const uint32_t tc = t[c];
    uint32_t hp = 1u;  // hin > 0 (top boundary: hin = +1)
    uint32_t hm = 0u;  // hin < 0
    uint32_t ph_b = 0u, mh_b = 0u;
    auto word_step = [&](int w) {
      uint32_t e = peq0[w];
      e = tc == 1 ? peq1[w] : e;
      e = tc == 2 ? peq2[w] : e;
      e = tc == 3 ? peq3[w] : e;
      e = tc == 4 ? peq4[w] : e;
      const uint32_t p = pv[w];
      const uint32_t m = mv[w];
      const uint32_t xv = e | m;
      const uint32_t e2 = e | hm;
      const uint32_t xh = (((e2 & p) + p) ^ p) | e2;
      const uint32_t ph = m | ~(xh | p);
      const uint32_t mh = p & xh;
      const uint32_t ph_s = (ph << 1) | hp;
      const uint32_t mh_s = (mh << 1) | hm;
      const uint32_t pv_o = mh_s | ~(xv | ph_s);
      pv[w] = pv_o;
      mv[w] = ph_s & xv;
      if constexpr (kPath) {
        up[at(c, w)] = pv_o;
        left[at(c, w)] = ph;
      }
      if (w == bw) {
        ph_b = ph;
        mh_b = mh;
      }
      hp = ph >> 31;
      hm = mh >> 31;
    };
    if constexpr (kUnroll) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (w > bw) break;
        word_step(w);
      }
    } else {
#pragma unroll 1
      for (int w = 0; w <= bw; ++w) word_step(w);
    }
    score += static_cast<int>((ph_b >> bb) & 1u) -
             static_cast<int>((mh_b >> bb) & 1u);
    if (c == tlen - 1) nw_dist = score;
    if (score < best) {
      best = score;
      best_end = c;
    }
    if (c + 1 <= neg1_cap) neg1 = min(neg1, score + c + 1);
  }

  int d, e;
  if (is_shw[g]) {
    if (w64 >= 1 && neg1 <= best) {
      d = neg1;
      e = -1;
    } else if (best_end == -2) {
      d = qlen;
      e = -1;
    } else {
      d = best;
      e = best_end;
    }
  } else {
    d = nw_dist;
    e = tlen - 1;
  }
  dist_out[g] = d;
  end_out[g] = e;

  if constexpr (!kPath) {
    if (col == nullptr) return;
    const uint32_t low = bb == 31 ? 0xFFFFFFFFu : ((1u << (bb + 1)) - 1u);
    auto put_word = [&](int w) {
      const uint32_t keep = w < bw ? 0xFFFFFFFFu : (w == bw ? low : 0u);
      col[static_cast<size_t>(w) * G + g] = w <= bw ? pv[w] & keep : 0u;
      col[static_cast<size_t>(W + w) * G + g] = w <= bw ? mv[w] & keep : 0u;
    };
    if constexpr (kUnroll) {
#pragma unroll
      for (int w = 0; w < W; ++w) put_word(w);
    } else {
#pragma unroll 1
      for (int w = 0; w < W; ++w) put_word(w);
    }
  } else {
    // ---- traceback: columns past end get code 0, then end..0 ----
    for (int c = T - 1; c > e; --c) {
      colcode[static_cast<size_t>(c) * G + g] = 0;
    }
    int r = qlen - 1;
    for (int c = e; c >= 0; --c) {
      // the highest clear "up" bit at or below row r
      int p = -1;
      if (r >= 0) {
        const int rb = r & 31;
        uint32_t mask = rb == 31 ? 0xFFFFFFFFu : ((1u << (rb + 1)) - 1u);
        for (int w = r >> 5; w >= 0; --w) {
          const uint32_t z = ~up[at(c, w)] & mask;
          if (z != 0u) {
            p = 32 * w + 31 - __clz(z);
            break;
          }
          mask = 0xFFFFFFFFu;
        }
      }
      const int run = r - p;
      bool is_del = p < 0;
      if (!is_del) is_del = (left[at(c, p >> 5)] >> (p & 31)) & 1u;
      const int move = is_del ? kOpDelete
                              : (q[p] == t[c] ? kOpMatch : kOpMismatch);
      colcode[static_cast<size_t>(c) * G + g] =
          static_cast<uint16_t>(move | (run << 2));
      r = is_del ? p : p - 1;
    }
    lead_out[g] = r + 1;
  }
}

struct Args {
  const uint8_t* qs;
  const int32_t* ql;
  const uint8_t* ts;
  const int32_t* tl;
  const uint8_t* is_shw;
  int32_t* dist;
  int32_t* end;
  uint32_t* col;
  int32_t* lead;
  uint16_t* colcode;
  uint32_t* up;
  uint32_t* left;
  int G, Q, T;
};

template <int W, bool kPath>
void launch(const Args& a, cudaStream_t stream) {
  constexpr int block = kBlock<kPath>;
  const int grid = (a.G + block - 1) / block;
  myers_kernel<W, kPath><<<grid, block, 0, stream>>>(
      a.qs, a.ql, a.ts, a.tl, a.is_shw, a.dist, a.end, a.col, a.lead,
      a.colcode, a.up, a.left, a.G, a.Q, a.T);
}

template <bool kPath>
int dispatch(const Args& a, void* stream) {
  if (a.G <= 0) return 0;
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

// dist / end / lead / colcode; up / left: (T * Q/32, G) uint32 scratch.
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
