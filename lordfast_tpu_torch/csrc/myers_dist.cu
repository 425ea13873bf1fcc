// Batched Myers bit-parallel edit distance (distance and end only), for
// NVIDIA Hopper (sm_90a).
//
// Replaces, in distance-only mode, the two Pallas TPU kernels of
// lordfast_tpu/ops/gap_dp_pallas.py: _make_kernel (:84) and
// _make_kernel_tiled (:290), reached through gap_align_pl (:513).  The
// engine's main path reads only their dist and end outputs; the host
// stitcher rebuilds each path with the banded edlib traceback.  Their
// traceback outputs (lead, colcode) are not produced here.
//
// Semantics (must equal myers_dist_plain in ops/gap_dp.py bit for bit):
// for gap g, the Myers column recurrence of edlib's calculateBlock with
// 32-bit words chained through hin/hout, top boundary hin = +1, initial
// score ql, the score following bit (ql-1)&31 of word (ql-1)>>5.  NW
// returns the score at column tl-1; SHW the smallest score over columns
// < tl (smallest column among ties), against edlib's negative-end
// artifact: with W64 = (64 - ql % 64) % 64, position -1 scores
// min(ql, min_{1<=j<=min(W64,tl)} d_j + j) and wins ties (end = -1).
//
// Design: one thread per gap.  A thread loops over its own columns
// c < tl[g] and its own words w <= (ql[g]-1)>>5 only.  Both bounds are
// exact: columns at or beyond tl feed none of the outputs, and carries
// run from low rows to high rows, so words above the bottom row's word
// cannot change it.  W (words of the bucket's padded query) is a template
// parameter: up to W = 16 the word loops are unrolled and Peq/Pv/Mv stay
// in registers; W = 64 and 128 keep them in local memory.  Peq is built
// per thread from the query codes.
//
// What bounds it on the card: integer ALU issue, with a serial
// dependency chain of ~12 operations per word and W words per column
// (the hin/hout carry), so a thread's latency is ~columns x words x
// chain length; memory traffic is one target byte per column.  One gap
// per thread keeps enough independent chains in flight only when a
// bucket holds thousands of gaps; the big buckets (G = 64 and 32) run
// few threads for many cycles.  Later work: a warp per gap with the
// word chain split across lanes, TMA-staged targets, and the traceback
// outputs the escalation offload needs.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

template <int W>
__global__ void __launch_bounds__(kBlock)
myers_dist_kernel(const uint8_t* __restrict__ qs,
                  const int32_t* __restrict__ ql,
                  const uint8_t* __restrict__ ts,
                  const int32_t* __restrict__ tl,
                  const uint8_t* __restrict__ is_shw,
                  int32_t* __restrict__ dist_out,
                  int32_t* __restrict__ end_out,
                  int G, int Q, int T) {
  const int g = blockIdx.x * kBlock + threadIdx.x;
  if (g >= G) return;
  // callers guarantee 1 <= ql <= Q and 1 <= tl <= T; the clamps only
  // keep a bad descriptor from reading outside its rows
  const int qlen = min(max(ql[g], 1), Q);
  const int tlen = min(max(tl[g], 1), T);
  const int bw = (qlen - 1) >> 5;
  const int bb = (qlen - 1) & 31;
  constexpr bool kUnroll = W <= 16;

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
      pv[w] = mh_s | ~(xv | ph_s);
      mv[w] = ph_s & xv;
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
}

template <int W>
void launch(const uint8_t* qs, const int32_t* ql, const uint8_t* ts,
            const int32_t* tl, const uint8_t* is_shw, int32_t* dist,
            int32_t* end, int G, int Q, int T, cudaStream_t stream) {
  const int grid = (G + kBlock - 1) / kBlock;
  myers_dist_kernel<W><<<grid, kBlock, 0, stream>>>(
      qs, ql, ts, tl, is_shw, dist, end, G, Q, T);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int lf_myers_dist(const void* qs, const void* ql, const void* ts,
                             const void* tl, const void* is_shw, void* dist,
                             void* end, int G, int Q, int T, void* stream) {
  if (G <= 0) return 0;
  auto* a = static_cast<const uint8_t*>(qs);
  auto* b = static_cast<const int32_t*>(ql);
  auto* c = static_cast<const uint8_t*>(ts);
  auto* d = static_cast<const int32_t*>(tl);
  auto* s = static_cast<const uint8_t*>(is_shw);
  auto* o1 = static_cast<int32_t*>(dist);
  auto* o2 = static_cast<int32_t*>(end);
  auto st = static_cast<cudaStream_t>(stream);
  switch (Q / 32) {
    case 1: launch<1>(a, b, c, d, s, o1, o2, G, Q, T, st); break;
    case 2: launch<2>(a, b, c, d, s, o1, o2, G, Q, T, st); break;
    case 4: launch<4>(a, b, c, d, s, o1, o2, G, Q, T, st); break;
    case 8: launch<8>(a, b, c, d, s, o1, o2, G, Q, T, st); break;
    case 16: launch<16>(a, b, c, d, s, o1, o2, G, Q, T, st); break;
    case 64: launch<64>(a, b, c, d, s, o1, o2, G, Q, T, st); break;
    case 128: launch<128>(a, b, c, d, s, o1, o2, G, Q, T, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
