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
// Design: one warp per problem, the band across the lanes, in registers
// (the layout of the TPU kernel and of extend_batch_plain, whose names
// the kernel follows).  BW = 32 K band slots, K = ceil((2 w_max + 2) /
// 32) (7 for the engine's w_max = 100; results do not depend on BW once
// BW >= 2 w_max + 2).  At target row i slot k holds query column j = i -
// w_max + k, so the diagonal predecessor sits in the same slot; lane l
// owns the K slots [l K, l K + K) as registers Hband, Eband and qband.
// Per row:
// - the F chain of ksw.c:441-447 in its closed form, the exclusive
//   prefix max of A_k = max(M_k - oe_ins, 0) + k e_ins: an in-lane scan
//   over the K slots, then a 5-step __shfl_up_sync scan of the lane
//   totals;
// - five warp reductions (__reduce_max_sync / __reduce_min_sync): the
//   row max rm, its LAST column rmj, the last cell's h_last, and the
//   shrink's first_nz and last_nz on the next row's slots; every scalar
//   (best, gscore, z-drop, beg, end) follows from them, warp-uniform, and
//   the warp leaves its row loop together;
// - H, E and the query band move up one slot: in registers, and one
//   __shfl_down_sync each across the lanes; lane 31's top slot takes the
//   entering column (init_decay fill, query code);
// - target bytes and entering query codes come in windows of 32 rows,
//   one byte a lane, loaded a window ahead and passed on by __shfl_sync,
//   so no row waits on a global load.
// Nothing is kept in device memory between rows: no scratch.  int32
// throughout: scores are bounded by h0 + match * Qe, the sentinels are
// -/+ 2^30.  Per-problem parameters ride in registers, so clip (w 40) and
// split (w 100) problems share a launch.
//
// What bounds it on the card: the serial row chain of the launch's
// deepest problem, not bytes or operations.  Each row waits on the row
// before through beg/end (the shrink's reductions) and its H band.  On an
// H100 80GB HBM3 (700 W) a row takes ~1300 cycles at K = 7 (5.38 ms for
// the 8214 rows of the deepest problem at (8192, 8224, 128), at 1980
// MHz) for ~480 instructions (the loop's SASS): a warp alone on its
// scheduler issues one every ~2.7 cycles, so the row is bound by the
// latency of its dependent chain — the scan's 6 shuffles, the 4
// reductions in series, and the in-lane chains between them (the rmj
// selects run through one predicate register).  A bucket holds at most
// 128 problems, so at most 128 warps are in flight, one a block over as
// many SMs: blocks of 4 warps took the same time, within 1% (7.29-7.34
// ms against 7.27-7.32 ms for the three buckets at full G, in turns in
// one call, both on the reordered variant that follows).  Computing the
// next row's state and shrink before the row's break decision, so that
// the two chains of reductions overlap, was 2% slower than this order
// (7.27-7.32 against 7.13-7.18 ms).
// A problem whose w_eff exceeds w_max has no slots for its band: the
// kernel traps (the fault shows at the next synchronise).
//
// tests/test_torch_affine_warp.py holds a numpy model of this layout
// (names as here) against the plain version and the Pallas kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kLanes = 32;
constexpr int kNegBig = -(1 << 30);
constexpr int kPosBig = 1 << 30;
// problems (warps) per block
constexpr int kWarps = 1;

struct Args {
  const uint8_t* qs;  // (G, Qe)
  const uint8_t* ts;  // (G, Te)
  const int32_t *qlen, *tlen, *o_del, *e_del, *o_ins, *e_ins, *w_eff, *zdrop,
      *h0, *match, *mismatch;
  int32_t *score, *qle, *tle, *gtle, *gscore, *max_off;
  int G, Qe, Te, w_max;
};

template <int K>
__global__ void __launch_bounds__(kWarps * kLanes)
affine_warp_kernel(const Args a) {
  constexpr int BW = kLanes * K;
  const int lane = threadIdx.x & (kLanes - 1);
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= a.G) return;  // the whole warp
  // callers guarantee 1 <= qlen <= Qe and 0 <= tlen <= Te; the clamps
  // only keep a bad descriptor inside its rows
  const int qlen = min(max(a.qlen[g], 1), a.Qe);
  const int tlen = min(max(a.tlen[g], 0), a.Te);
  const int o_del = a.o_del[g], e_del = a.e_del[g];
  const int o_ins = a.o_ins[g], e_ins = a.e_ins[g];
  const int w_eff = a.w_eff[g], zdrop = a.zdrop[g], h0 = a.h0[g];
  const int match = a.match[g], mismatch = a.mismatch[g];
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  const int w_max = a.w_max;
  if (w_eff < 0 || w_eff > w_max) __trap();  // the band has no such slots
  const uint8_t* query = a.qs + static_cast<size_t>(g) * a.Qe;
  const uint8_t* target = a.ts + static_cast<size_t>(g) * a.Te;

  // the scalar first row H[j] (shifted: the value of column j - 1)
  const int h1v = max(h0 - oe_ins, 0);
  auto init_decay = [&](int j) {
    return j <= 0 ? h0 : max(h1v - (j - 1) * e_ins, 0);
  };
  auto query_at = [&](int j) {
    return j >= 0 && j < qlen ? static_cast<int>(query[j]) : 4;
  };

  const int k0 = lane * K;  // this lane's first slot
  int Hband[K], Eband[K], qband[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int j = k0 + r - w_max;
    Hband[r] = j >= 0 && j <= qlen ? init_decay(j) : 0;
    Eband[r] = 0;
    qband[r] = query_at(j);
  }
  int beg = 0, end = qlen;
  int best = h0, best_i = -1, best_j = -1, best_ie = -1, gscore = -1;
  int moff = 0;
  // lane l holds row i0 + l's target byte and the query code entering at
  // that row (fill_col = row + BW - w_max); the next window one ahead
  int tw = 0, qw = 0;
  int tw_next = lane < tlen ? target[lane] : 4;
  int qw_next = query_at(lane + BW - w_max);

  for (int i = 0; i < tlen; ++i) {
    const int wi = i & (kLanes - 1);
    if (wi == 0) {
      tw = tw_next;
      qw = qw_next;
      const int row = i + kLanes + lane;
      tw_next = row < tlen ? target[row] : 4;
      qw_next = query_at(row + BW - w_max);
    }
    const int t_i = __shfl_sync(kFull, tw, wi);
    const int q_fill = __shfl_sync(kFull, qw, wi);
    const int j0 = i - w_max + k0;  // column of slot r: j0 + r
    // band clamp for this row (ksw.c:414-416)
    const int beg_r = max(beg, i - w_eff);
    const int end_r = min(min(end, i + w_eff + 1), qlen);
    const int h1_init =
        beg_r == 0 ? max(h0 - (o_del + e_del * (i + 1)), 0) : 0;

    // ---- cells; F: exclusive prefix max of A along the band ----
    bool in_band[K];
    int M[K], incl[K];
    int run = kNegBig;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int j = j0 + r;
      in_band[r] = j >= beg_r && j < end_r;
      const int qc = qband[r];
      const int s =
          (qc >= 4 || t_i >= 4) ? 0 : (qc == t_i ? match : -mismatch);
      M[r] = Hband[r] != 0 && in_band[r] ? Hband[r] + s : 0;
      const int A =
          in_band[r] ? max(M[r] - oe_ins, 0) + (k0 + r) * e_ins : kNegBig;
      run = max(run, A);
      incl[r] = run;
    }
    int tot = run;  // inclusive scan of the lane totals
#pragma unroll
    for (int d = 1; d < kLanes; d *= 2) {
      const int v = __shfl_up_sync(kFull, tot, d);
      tot = lane >= d ? max(tot, v) : tot;
    }
    int lane_excl = __shfl_up_sync(kFull, tot, 1);
    lane_excl = lane == 0 ? kNegBig : lane_excl;
    int h[K];
    int lm = 0, hl = kNegBig;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int p_excl = r == 0 ? lane_excl : max(lane_excl, incl[r - 1]);
      const int f = max(p_excl - (k0 + r - 1) * e_ins, 0);
      h[r] = in_band[r] ? max(max(M[r], Eband[r]), f) : 0;
      lm = max(lm, h[r]);
      hl = j0 + r == end_r - 1 ? h[r] : hl;
    }

    // ---- row statistics: the scalar row max moves to the LAST j
    // achieving it (ksw.c:437) ----
    const int rm = __reduce_max_sync(kFull, lm);
    int lj = -1;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      lj = in_band[r] && h[r] == rm && rm > 0 ? j0 + r : lj;
    }
    const int rmj = __reduce_max_sync(kFull, lj);
    const int h_last = __reduce_max_sync(kFull, hl);
    // gscore: the scalar code checks j == qlen after the row, where j =
    // end_r if the row ran else beg_r, with h1 = h(i, end_r - 1) resp.
    // h1_init (empty row)
    const bool loop_ran = beg_r < end_r;
    const int h_after = loop_ran ? h_last : h1_init;
    if ((loop_ran ? end_r : beg_r) == qlen && h_after >= gscore) {
      gscore = h_after;
      best_ie = i;
    }
    // break on a dead row, then best / z-drop (ksw.c:451-461)
    if (rm == 0) break;
    if (rm > best) {
      moff = max(moff, abs(rmj - i));
      best = rm;
      best_i = i;
      best_j = rmj;
    } else if (zdrop > 0) {
      const int di = i - best_i, dj = rmj - best_j;
      const int drop = di > dj ? best - rm - (di - dj) * e_del
                               : best - rm - (dj - di) * e_ins;
      if (drop > zdrop) break;
    }

    // ---- state for the next row: slot r now holds column j0 + r + 1 ----
    const int fill_col = i + BW - w_max;  // the slot entering at the top
    const int h_fill = fill_col <= qlen ? init_decay(fill_col) : 0;
    // E: updated in [beg_r, end_r), E[end_r] = 0, else unchanged
    int Enew[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int Erec = max(Eband[r] - e_del, max(M[r] - oe_del, 0));
      Enew[r] = in_band[r] ? Erec : (j0 + r == end_r ? 0 : Eband[r]);
    }
    const bool top = lane == kLanes - 1;
    const int h_up = __shfl_down_sync(kFull, Hband[0], 1);
    const int e_up = __shfl_down_sync(kFull, Enew[0], 1);
    const int q_up = __shfl_down_sync(kFull, qband[0], 1);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int j = j0 + r, j_next = j + 1;
      const int shifted = r + 1 < K ? Hband[r + 1] : (top ? h_fill : h_up);
      const int hrow_eff = j == beg_r - 1 ? h1_init : h[r];
      Hband[r] = j_next >= beg_r && j_next <= end_r ? hrow_eff : shifted;
      Eband[r] = r + 1 < K ? Enew[r + 1] : (top ? 0 : e_up);
      qband[r] = r + 1 < K ? qband[r + 1] : (top ? q_fill : q_up);
    }
    // dead-cell shrink (ksw.c:466-469) on the post-update rows
    int fz = kPosBig;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int j_next = j0 + r + 1;
      const bool nz = Hband[r] != 0 || Eband[r] != 0;
      fz = nz && j_next >= beg_r && j_next < end_r ? min(fz, j_next) : fz;
    }
    const int first_nz = __reduce_min_sync(kFull, fz);
    const int beg2 = first_nz == kPosBig ? end_r : first_nz;
    int lz = kNegBig;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int j_next = j0 + r + 1;
      const bool nz = Hband[r] != 0 || Eband[r] != 0;
      lz = nz && j_next >= beg2 && j_next <= end_r ? j_next : lz;
    }
    int last_nz = __reduce_max_sync(kFull, lz);
    last_nz = last_nz == kNegBig ? beg2 - 1 : last_nz;
    beg = beg2;
    end = min(last_nz + 2, qlen);
  }
  if (lane == 0) {
    a.score[g] = best;
    a.qle[g] = best_j + 1;
    a.tle[g] = best_i + 1;
    a.gtle[g] = best_ie + 1;
    a.gscore[g] = gscore;
    a.max_off[g] = moff;
  }
}

template <int K>
void launch(const Args& a, cudaStream_t stream) {
  affine_warp_kernel<K><<<(a.G + kWarps - 1) / kWarps, kWarps * kLanes, 0,
                          stream>>>(a);
}

}  // namespace

// Plain C entry point (bound with ctypes).  params: 11 device pointers to
// (G,) int32 — qlen, tlen, o_del, e_del, o_ins, e_ins, w_eff, zdrop, h0,
// match, mismatch, with w_eff <= w_max; outs: 6 device pointers to (G,)
// int32 — score, qle, tle, gtle, gscore, max_off.  w_max sets the band's
// slots (K = ceil((2 w_max + 2) / 32) <= 8, so 0 <= w_max <= 126).
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int lf_affine_extend(const void* qs, const void* ts,
                                const void* const* params,
                                void* const* outs, int G, int Qe, int Te,
                                int w_max, void* stream) {
  if (w_max < 0 || w_max > 126) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (G <= 0) return 0;
  auto p = [&](int k) { return static_cast<const int32_t*>(params[k]); };
  auto o = [&](int k) { return static_cast<int32_t*>(outs[k]); };
  const Args a{static_cast<const uint8_t*>(qs),
               static_cast<const uint8_t*>(ts),
               p(0), p(1), p(2), p(3), p(4), p(5), p(6), p(7), p(8), p(9),
               p(10), o(0), o(1), o(2), o(3), o(4), o(5), G, Qe, Te, w_max};
  auto st = static_cast<cudaStream_t>(stream);
  switch ((2 * w_max + 2 + kLanes - 1) / kLanes) {
    case 1: launch<1>(a, st); break;
    case 2: launch<2>(a, st); break;
    case 3: launch<3>(a, st); break;
    case 4: launch<4>(a, st); break;
    case 5: launch<5>(a, st); break;
    case 6: launch<6>(a, st); break;
    case 7: launch<7>(a, st); break;
    case 8: launch<8>(a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
