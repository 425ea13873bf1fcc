// Batched banded affine-gap extension with ksw_extend2 semantics, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lordfast_tpu/ops/affine_pl.py
// _make_kernel (:85), reached through extend_batch (:317) and
// extend_from_desc (:291): the escalation offload's phase B (clip and
// split sites, src/LordFAST.cpp:1848,1971).
//
// Semantics (must equal extend_batch_plain in ops/affine.py, and the
// scalar oracle native/align_eq.cpp sw_extend, on all six outputs):
// lib/bwa/ksw.c:380-479 per problem — h0-decay first row, band [beg, end)
// clamped to i -/+ w_eff (w_eff already includes the max_ins/max_del
// clamp, affine.clamp_band), M = H ? H + s : 0 with s = 0 when either
// base is N, the E / F affine recurrences, row max at the LAST argmax,
// gscore on the latest row that reaches the query end, break on an
// all-zero row, z-drop, and the dead-cell shrink of [beg, end).
// Outputs score, qle = best_j + 1, tle = best_i + 1, gtle = best_ie + 1,
// gscore, max_off, each (G,) int32.
//
// Design: one thread per problem runs the scalar row loop of
// align_eq.cpp sw_extend statement for statement, the simple layout
// first.  Its H and E rows (j in [0, qlen]) live in a global scratch the
// wrapper allocates, laid out (Qe + 1, G) so that the threads of a warp,
// which walk their bands at nearby j, touch nearby addresses; the rows
// stay in L1/L2 for the small buckets.  Per-problem parameters (gap
// costs, band, z-drop, h0, match / mismatch) are read once per thread,
// so clip and split problems share a launch.  Blocks of 32 threads: a
// bucket holds at most 128 problems, and spreading them over four SMs
// beats packing them into one.
//
// What bounds it on the card: the serial cell chain of one thread (the
// F and h1 carries make each cell depend on the one before it in the
// row), ~16 integer operations per band cell plus two scratch loads and
// stores; with at most 128 problems per launch, 4 of 132 SMs are busy.
// The bytes of inputs and outputs are small.  Later work (ROADMAP): a
// block per problem with the band slots across threads, the F chain as
// a prefix max (the TPU kernel's layout), rows in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 32;

__global__ void __launch_bounds__(kBlock)
affine_extend_kernel(const uint8_t* __restrict__ qs,
                     const uint8_t* __restrict__ ts,
                     const int32_t* __restrict__ qlen_in,
                     const int32_t* __restrict__ tlen_in,
                     const int32_t* __restrict__ o_del_in,
                     const int32_t* __restrict__ e_del_in,
                     const int32_t* __restrict__ o_ins_in,
                     const int32_t* __restrict__ e_ins_in,
                     const int32_t* __restrict__ w_in,
                     const int32_t* __restrict__ zdrop_in,
                     const int32_t* __restrict__ h0_in,
                     const int32_t* __restrict__ match_in,
                     const int32_t* __restrict__ mismatch_in,
                     int32_t* __restrict__ score_out,
                     int32_t* __restrict__ qle_out,
                     int32_t* __restrict__ tle_out,
                     int32_t* __restrict__ gtle_out,
                     int32_t* __restrict__ gscore_out,
                     int32_t* __restrict__ max_off_out,
                     int32_t* __restrict__ Hs,
                     int32_t* __restrict__ Es,
                     int G, int Qe, int Te) {
  const int g = blockIdx.x * kBlock + threadIdx.x;
  if (g >= G) return;
  // callers guarantee 1 <= qlen <= Qe and 1 <= tlen <= Te; the clamps
  // only keep a bad descriptor inside its rows
  const int qlen = min(max(qlen_in[g], 1), Qe);
  const int tlen = min(max(tlen_in[g], 0), Te);
  const int o_del = o_del_in[g], e_del = e_del_in[g];
  const int o_ins = o_ins_in[g], e_ins = e_ins_in[g];
  const int w = w_in[g], zdrop = zdrop_in[g], h0 = h0_in[g];
  const int match = match_in[g], mismatch = mismatch_in[g];
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  const uint8_t* query = qs + static_cast<size_t>(g) * Qe;
  const uint8_t* target = ts + static_cast<size_t>(g) * Te;
  int32_t* H = Hs + g;  // H[j] at H[j * G]
  int32_t* E = Es + g;
  const size_t S = static_cast<size_t>(G);

  // first row: H(0, j) decays by the insertion cost from h0
  H[0] = h0;
  int hj = h0 > oe_ins ? h0 - oe_ins : 0;
  H[S] = hj;
  E[0] = 0;
  E[S] = 0;
  for (int j = 2; j <= qlen; ++j) {
    hj = hj > e_ins ? hj - e_ins : 0;
    H[j * S] = hj;
    E[j * S] = 0;
  }

  int best = h0, best_i = -1, best_j = -1, best_ie = -1, gscore = -1;
  int max_off = 0;
  int beg = 0, end = qlen;
  int j;
  for (int i = 0; i < tlen; ++i) {
    int f = 0, h1, row_max = 0, row_max_j = -1;
    const int tc = target[i];
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    if (beg == 0) {
      h1 = h0 - (o_del + e_del * (i + 1));
      if (h1 < 0) h1 = 0;
    } else {
      h1 = 0;
    }
    for (j = beg; j < end; ++j) {
      const int qc = query[j];
      const int s = (qc >= 4 || tc >= 4) ? 0 : (qc == tc ? match : -mismatch);
      const int diagH = H[j * S];
      int e = E[j * S];
      H[j * S] = h1;  // becomes H(i, j-1) for the next row
      const int M = diagH ? diagH + s : 0;
      int h = M > e ? M : e;
      h = h > f ? h : f;
      h1 = h;
      if (row_max <= h) {  // ksw.c:437: the LAST j achieving the max
        row_max = h;
        row_max_j = j;
      }
      int tmp = M - oe_del;
      tmp = tmp > 0 ? tmp : 0;
      e -= e_del;
      e = e > tmp ? e : tmp;
      E[j * S] = e;
      tmp = M - oe_ins;
      tmp = tmp > 0 ? tmp : 0;
      f -= e_ins;
      f = f > tmp ? f : tmp;
    }
    H[end * S] = h1;
    E[end * S] = 0;
    if (j == qlen) {  // reached the query end: ties take the latest row
      if (h1 >= gscore) {
        best_ie = i;
        gscore = h1;
      }
    }
    if (row_max == 0) break;
    if (row_max > best) {
      best = row_max;
      best_i = i;
      best_j = row_max_j;
      max_off = max(max_off, abs(row_max_j - i));
    } else if (zdrop > 0) {
      if (i - best_i > row_max_j - best_j) {
        if (best - row_max - ((i - best_i) - (row_max_j - best_j)) * e_del >
            zdrop)
          break;
      } else {
        if (best - row_max - ((row_max_j - best_j) - (i - best_i)) * e_ins >
            zdrop)
          break;
      }
    }
    // shrink the active interval to nonzero cells (ksw.c:466-469)
    for (j = beg; j < end && H[j * S] == 0 && E[j * S] == 0; ++j) {
    }
    beg = j;
    for (j = end; j >= beg && H[j * S] == 0 && E[j * S] == 0; --j) {
    }
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  score_out[g] = best;
  qle_out[g] = best_j + 1;
  tle_out[g] = best_i + 1;
  gtle_out[g] = best_ie + 1;
  gscore_out[g] = gscore;
  max_off_out[g] = max_off;
}

}  // namespace

// Plain C entry point (bound with ctypes).  params: 11 device pointers to
// (G,) int32 — qlen, tlen, o_del, e_del, o_ins, e_ins, w_eff, zdrop, h0,
// match, mismatch; outs: 6 device pointers to (G,) int32 — score, qle,
// tle, gtle, gscore, max_off; H/E: (Qe + 1, G) int32 scratch.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int lf_affine_extend(const void* qs, const void* ts,
                                const void* const* params,
                                void* const* outs, void* H, void* E, int G,
                                int Qe, int Te, void* stream) {
  if (G <= 0) return 0;
  auto p = [&](int k) { return static_cast<const int32_t*>(params[k]); };
  auto o = [&](int k) { return static_cast<int32_t*>(outs[k]); };
  const int grid = (G + kBlock - 1) / kBlock;
  affine_extend_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(ts), p(0),
      p(1), p(2), p(3), p(4), p(5), p(6), p(7), p(8), p(9), p(10), o(0), o(1),
      o(2), o(3), o(4), o(5), static_cast<int32_t*>(H),
      static_cast<int32_t*>(E), G, Qe, Te);
  return static_cast<int>(cudaGetLastError());
}
