// The seeder's lockstep loops over an FM index striped over the ranks of a
// mesh, as launches between collectives, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's sharded branches of
// lordfast_tpu/ops/fm_index.py _seed_anchors_impl (:387): the lockstep
// extension ext_loop_flat (:485, lax.while_loop :492, taken at :674) and
// the locate walk of sa_lookup (:267, walk :281-303), whose rank-row
// lookups go through _row_gather_routed (:76: fixed (D, cap) buckets, an
// all_to_all there and back, a psum'd overflow flag and the all-gather
// route _row_gather_ag :56 behind a lax.cond).  The port's plain versions
// are ops/fm_index.py _shard_ext and _shard_walk over _route_gather; they
// stay the CPU path and the oracle.
//
// One step of either loop is four launches and two collectives
// (ops/fm_shard_cuda.py launches them inside ops/fm_index.py exchange,
// which makes the collectives, NCCL's or gloo's, outside any kernel):
//   shard_bucket_kernel    each live lane's rank-row queries to its owner's
//                          bucket of the (D, cap) send buffer, through a
//                          per-owner counter (one atomicAdd for the queries
//                          of a warp to one owner, __match_any_sync): each
//                          query records the slot it took, so no order of
//                          the atomics can change a value downstream; a
//                          query past its bucket's cap takes no slot and
//                          sets the overflow flag.  Dead lanes send
//                          nothing.  On the all-gather route a query's slot
//                          is its index.
//   (all_to_all_single of the row ids, equal splits)
//   shard_answer_kernel    every received row id answered from this rank's
//                          stripe (16-byte loads), zeros where this rank
//                          does not own the row (padding slots, the
//                          all-gather route's other ranks' rows)
// The locate's one gather of sampled SA entries a call (and a full SA's
// locate) takes the same two kernels: shard_bucket on the row ids
// themselves, shard_answer on the sa_samp stripe (width 1).
//   (all_to_all_single of the rows back; on the all-gather route an
//    all_gather of the queries before and a reduce_scatter (SUM) after:
//    exact, since every row has one owner)
//   shard_ext_step_kernel  reads both queries' rows (k - 1 and l, bwa's
//                          bwt_2occ pair) by slot, counts occ and advances
//                          (alive, k, l, m) as _ext_steps does
//   shard_walk_step_kernel reads the row of x = k - (k > primary) by slot
//                          and takes one inverse-Psi step (rows, steps,
//                          active) as the plain walk does; the row's own
//                          word holds its char, so a walk step routes one
//                          rank row (fm_blocks, or occ_cp + bwt_blocks
//                          answered into one 12-value row)
// The occ count and the walk step are fm_rank.cuh's, which seed_ext.cu's
// kernels use too.  The step kernels run in place; on the last step of a
// block of steps each adds its live lanes to a device count (one atomicAdd
// a warp), which the block's one all_reduce (MAX) carries beside the
// overflow flag: one host read a block.
//
// What bounds it on the card: not bytes.  A step moves a few MB at most
// (the live lanes' state and their 96-byte rows); its time is the
// launches' and the collectives' latency, a few microseconds each.  Lane
// state stays in device memory between steps, so nothing crosses to the
// host inside a block.  tests/test_torch_sharded_route.py holds a numpy
// model of these kernels (names as here) against the plain loops.

#include <cstdint>

#include <cuda_runtime.h>

#include "fm_rank.cuh"

namespace {

using namespace fm_rank;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct BucketArgs {
  const uint8_t* live;  // (n,) bool: the lane's alive / active flag
  const int64_t* k;     // (n,) the interval's k (extension), the row
                        // (walk) or the row id itself (ids)
  const int64_t* l;     // (n,) the interval's l, or null
  int64_t* send;        // (D cap,) row ids, -1 in the empty slots; or (Q,)
  int32_t* slot;        // (Q,) each query's slot, -1 for none
  int32_t* counts;      // (D,) zeroed in the launch
  int32_t* over;        // set to 1 when a query finds its bucket full
  int64_t n, seq_len, primary, rps, cap;
  int D, all_gather, ids;
};

// Query i of a step: on an extension the rows k - 1 (i < n) and l (i >= n)
// of lane i mod n, as backward_ext stacks them; on a walk row i's step.
// The query's rank row is the block of its occ position (occ_pos) or, on a
// walk, of x = k - (k > primary), whose row also holds x's char; the
// primary row steps to 0 and asks for nothing.  With ids, query i asks for
// row k[i] itself (a locate's sampled SA entries).
__global__ void __launch_bounds__(kThreads) shard_bucket_kernel(
    const BucketArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool ext = a.l != nullptr;
  const int64_t n_q = ext ? 2 * a.n : a.n;
  const bool in = i < n_q;  // no early return: the warp matches owners
  const int64_t lane = i < a.n ? i : i - a.n;
  bool ask = false;
  int64_t blk = -1;
  if (in && a.live[lane] != 0) {
    if (a.ids) {
      blk = a.k[lane];
      ask = true;
    } else if (ext) {
      const int64_t k = i < a.n ? a.k[lane] - 1 : a.l[lane];
      blk = occ_pos(a.seq_len, a.primary, k) >> 7;
      ask = true;
    } else {
      const int64_t k = a.k[lane];
      if (k != a.primary) {
        blk = (k - (k > a.primary ? 1 : 0)) >> 7;
        ask = true;
      }
    }
  }
  if (a.all_gather) {  // the same for the whole grid
    if (in) {
      a.send[i] = ask ? blk : -1;
      a.slot[i] = static_cast<int32_t>(i);
    }
    return;
  }
  // the warp's queries to one owner take their slots with one atomicAdd
  // by the first of them, in lane order after the count it returns
  int64_t owner = -1;
  if (ask) {
    owner = blk / a.rps;
    owner = owner < a.D - 1 ? owner : a.D - 1;
  }
  const unsigned peers =
      __match_any_sync(kFull, static_cast<long long>(owner));
  int32_t s = -1;
  if (ask) {
    const int me = static_cast<int>(threadIdx.x & 31);
    const int first = __ffs(peers) - 1;
    int base = 0;
    if (me == first) base = atomicAdd(a.counts + owner, __popc(peers));
    base = __shfl_sync(peers, base, first);
    const int64_t r = base + __popc(peers & ((1u << me) - 1u));
    if (r < a.cap) {
      s = static_cast<int32_t>(owner * a.cap + r);
      a.send[s] = blk;
    } else {
      *a.over = 1;
    }
  }
  if (in) a.slot[i] = s;
}

struct AnswerArgs {
  const int64_t* recv;    // (n,) row ids, -1 for none
  const void* rank_a;     // this rank's stripe: fm_blocks (rps, 12) or
  const int64_t* rank_b;  // occ_cp (rps, 4) with bwt_blocks (rps, 8); or
                          // sa_samp (rps,) int32 or int64 (width 1)
  void* out;              // (n, 12) int64 as 6 pieces a row, or (n,) int64
  int64_t n, rps, base;   // base: this rank's first global row
  int fused, width, elem_bytes;
};

__global__ void __launch_bounds__(kThreads) shard_answer_kernel(
    const AnswerArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int64_t loc = a.recv[i] - a.base;
  if (a.width == 1) {  // a sampled SA entry, as int64
    int64_t v = 0;
    if (loc >= 0 && loc < a.rps) {
      v = a.elem_bytes == 8
              ? ld(static_cast<const int64_t*>(a.rank_a) + loc)
              : static_cast<int64_t>(
                    __ldg(static_cast<const int32_t*>(a.rank_a) + loc));
    }
    static_cast<int64_t*>(a.out)[i] = v;
    return;
  }
  longlong2* o = static_cast<longlong2*>(a.out) + 6 * i;
  if (loc < 0 || loc >= a.rps) {
    const longlong2 z = make_longlong2(0, 0);
#pragma unroll
    for (int j = 0; j < 6; ++j) o[j] = z;
    return;
  }
  const longlong2* cp;
  const longlong2* wp;
  const int64_t* ra = static_cast<const int64_t*>(a.rank_a);
  if (a.fused) {
    cp = reinterpret_cast<const longlong2*>(ra + 12 * loc);
    wp = cp + 2;
  } else {
    cp = reinterpret_cast<const longlong2*>(ra + 4 * loc);
    wp = reinterpret_cast<const longlong2*>(a.rank_b + 8 * loc);
  }
  const longlong2 c0 = __ldg(cp), c1 = __ldg(cp + 1);
  const longlong2 w0 = __ldg(wp), w1 = __ldg(wp + 1), w2 = __ldg(wp + 2),
                  w3 = __ldg(wp + 3);
  o[0] = c0;
  o[1] = c1;
  o[2] = w0;
  o[3] = w1;
  o[4] = w2;
  o[5] = w3;
}

// The returned row of query slot s (12 int64 at back + 12 s) for the occ
// query of row k at position pos; slot -1 (a query that overflowed its
// bucket, whose block is run again) gives a zero row.
__device__ __forceinline__ void row_at(const int64_t* back, int32_t s,
                                       int64_t pos, int64_t k, Row& row) {
  if (s < 0) {
    const longlong2 z = make_longlong2(0, 0);
    row = Row{z, z, z, z, z, z, k, static_cast<int>(pos & 127)};
    return;
  }
  const longlong2* cp =
      reinterpret_cast<const longlong2*>(back + 12 * static_cast<int64_t>(s));
  load_rank_row(cp, cp + 2, pos, k, row);
}

// Adds the warp's live lanes to *live (every thread of the warp calls it).
__device__ __forceinline__ void count_live(int32_t* live, bool alive) {
  const unsigned b = __ballot_sync(kFull, alive);
  if ((threadIdx.x & 31) == 0 && b != 0u) {
    atomicAdd(live, static_cast<int32_t>(__popc(b)));
  }
}

struct ExtArgs {
  uint8_t* alive;          // (n,) in place
  int64_t* k;
  int64_t* l;
  int64_t* m;
  const int64_t* pos_f;    // (n,)
  const int64_t* b_lane;   // (n,)
  const int64_t* rw;       // (B, W16) 3-bit read words
  const int64_t* lens;     // (B,)
  const void* l2;          // (5,) Pos
  const int64_t* back;     // (slots, 12) the returned rows
  const int32_t* slot;     // (2 n,)
  int32_t* live;           // the live-lane count, or null
  int64_t n, seq_len, primary;
  int L, W16;
};

// One greedy extension step of every alive lane (_ext_steps' body): the
// complement of the next read char as one backward-extension step of [k,
// l]; a lane dies at a non-ACGT char, past the read's end, on an empty
// interval or at MAX_ANCHOR_LEN, and a dead lane is left as it is.
template <typename Pos>
__global__ void __launch_bounds__(kThreads) shard_ext_step_kernel(
    const ExtArgs a) {
  const int64_t lane =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  bool alive = lane < a.n && a.alive[lane] != 0;
  if (alive) {
    const L2 l2 = load_l2<Pos>(a.l2);
    const int64_t k = a.k[lane];
    const int64_t l = a.l[lane];
    const int64_t m = a.m[lane];
    const int64_t q = a.pos_f[lane] + m;  // next read position to consume
    const int64_t b = a.b_lane[lane];
    const int64_t qc = q < a.L ? q : a.L - 1;
    const int64_t word = ld(a.rw + b * a.W16 + (qc >> 4));
    Row rk, rl;
    row_at(a.back, a.slot[lane], occ_pos(a.seq_len, a.primary, k - 1), k - 1,
           rk);
    row_at(a.back, a.slot[a.n + lane], occ_pos(a.seq_len, a.primary, l), l,
           rl);
    const int c = static_cast<int>((word >> (3 * (15 - (qc & 15)))) & 7);
    const bool ok_char = q < ld(a.lens + b) && c < 4;
    const int cc = ok_char ? 3 - c : 0;  // complemented
    const int64_t nk = l2[cc] + occ_of_row(a.seq_len, l2, rk, cc) + 1;
    const int64_t nl = l2[cc] + occ_of_row(a.seq_len, l2, rl, cc);
    alive = ok_char && nk <= nl && m < kMaxAnchor;
    if (alive) {
      a.k[lane] = nk;
      a.l[lane] = nl;
      a.m[lane] = m + 1;
    } else {
      a.alive[lane] = 0;
    }
  }
  if (a.live != nullptr) count_live(a.live, alive);
}

struct WalkArgs {
  uint8_t* active;         // (n,) in place
  int64_t* rows;
  int64_t* steps;
  const void* l2;          // (5,) Pos
  const int64_t* back;     // (slots, 12) the returned rows
  const int32_t* slot;     // (n,)
  int32_t* live;           // the live-lane count, or null
  int64_t n, seq_len, primary, mask;
};

// One inverse-Psi step of every active row (the plain walk's body, bwt_sa
// of lib/bwa/bwt.c:86-96): the primary row steps to 0, any other row to
// walk_next of its returned row; a row stops at a sampled row (rows & mask
// == 0), and an inactive row is left as it is.
template <typename Pos>
__global__ void __launch_bounds__(kThreads) shard_walk_step_kernel(
    const WalkArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  bool active = i < a.n && a.active[i] != 0;
  if (active) {
    const int64_t k = a.rows[i];
    int64_t nxt = 0;
    if (k != a.primary) {
      const L2 l2 = load_l2<Pos>(a.l2);
      Row row;
      row_at(a.back, a.slot[i], k - (k > a.primary ? 1 : 0), k, row);
      nxt = walk_next(a.seq_len, l2, row);
    }
    a.rows[i] = nxt;
    a.steps[i] += 1;
    active = (nxt & a.mask) != 0;
    if (!active) a.active[i] = 0;
  }
  if (a.live != nullptr) count_live(a.live, active);
}

unsigned blocks_of(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// The bucket step: n lanes' live flags (bool) and k (int64), with l
// (int64) for an extension (2 n queries) or null for a walk (n queries)
// or, with ids, for n queries of the row ids k themselves;
// the rank stripes' rows a rank rps; D ranks; cap slots an owner.  Routed
// (all_gather 0): send (D cap,) int64 gets the row ids (-1 in the empty
// slots), slot (Q,) int32 each query's slot or -1, counts (D,) int32 is
// scratch (zeroed here), *over (int32) is set to 1 if a bucket overflowed
// (never cleared here).  All-gather (1): send (Q,) gets each query's row id
// or -1, slot (Q,) its index.  Returns a cudaError_t (0 on a clean launch).
extern "C" int lf_shard_bucket(const void* live, const void* k, const void* l,
                               void* send, void* slot, void* counts,
                               void* over, long long n, long long seq_len,
                               long long primary, long long rps, long long cap,
                               int D, int all_gather, int ids,
                               void* stream) {
  if (n < 0 || D <= 0 || rps <= 0 || (!all_gather && cap <= 0) ||
      (ids && l != nullptr) ||
      (!all_gather && (counts == nullptr || over == nullptr)) ||
      (!all_gather && static_cast<long long>(D) * cap >= (1ll << 31)) ||
      (l != nullptr ? 2 * n : n) >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!all_gather) {
    cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int32_t) * D, st);
    if (e == cudaSuccess) {
      e = cudaMemsetAsync(send, 0xFF, sizeof(int64_t) * D * cap, st);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t n_q = l != nullptr ? 2 * n : n;
  if (n_q == 0) return 0;
  const BucketArgs a{static_cast<const uint8_t*>(live),
                     static_cast<const int64_t*>(k),
                     static_cast<const int64_t*>(l),
                     static_cast<int64_t*>(send),
                     static_cast<int32_t*>(slot),
                     static_cast<int32_t*>(counts),
                     static_cast<int32_t*>(over),
                     n, seq_len, primary, rps, cap, D, all_gather, ids};
  shard_bucket_kernel<<<blocks_of(n_q), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The answer step: n received row ids (int64, -1 for none), this rank's
// first global row base and stripe of rps rows.  Width 12: fused = 1:
// rank_a = fm_blocks (rps, 12); 0: rank_a = occ_cp (rps, 4), rank_b =
// bwt_blocks (rps, 8); int64, 16-byte aligned; out (n, 12) int64, 16-byte
// aligned: each owned row's 12 values, zeros for the rest.  Width 1: rank_a
// = sa_samp (rps,) of elem_bytes 4 or 8; out (n,) int64: each owned entry,
// 0 for the rest.  Returns a cudaError_t.
extern "C" int lf_shard_answer(const void* recv, const void* rank_a,
                               const void* rank_b, void* out, long long n,
                               long long rps, long long base, int fused,
                               int width, int elem_bytes, void* stream) {
  const bool rows = width == 12;
  if (n < 0 || rps <= 0 || (!rows && width != 1) ||
      (rows && (!aligned16(rank_a) || !aligned16(out) ||
                (!fused && (rank_b == nullptr || !aligned16(rank_b))))) ||
      (!rows && elem_bytes != 4 && elem_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const AnswerArgs a{static_cast<const int64_t*>(recv), rank_a,
                     static_cast<const int64_t*>(rank_b), out, n, rps, base,
                     fused, width, elem_bytes};
  shard_answer_kernel<<<blocks_of(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The extension step over n lanes, in place: alive (bool), k, l, m (int64);
// pos_f, b_lane (n,) int64; the reads as 3-bit words rw (B, W16) int64 of
// L chars and lens (B,) int64; l2 (5,) int32 (pos_bytes 4) or int64 (8);
// back (slots, 12) int64, 16-byte aligned, and slot (2 n,) int32 from the
// bucket step; live (int32) or null: the live lanes after the step are
// added to it.  Returns a cudaError_t.
extern "C" int lf_shard_ext_step(void* alive, void* k, void* l, void* m,
                                 const void* pos_f, const void* b_lane,
                                 const void* rw, const void* lens,
                                 const void* l2, const void* back,
                                 const void* slot, void* live, long long n,
                                 long long seq_len, long long primary, int L,
                                 int W16, int pos_bytes, void* stream) {
  if (n < 0 || L <= 0 || W16 * 16 < L || !aligned16(back) ||
      (pos_bytes != 4 && pos_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const ExtArgs a{static_cast<uint8_t*>(alive), static_cast<int64_t*>(k),
                  static_cast<int64_t*>(l), static_cast<int64_t*>(m),
                  static_cast<const int64_t*>(pos_f),
                  static_cast<const int64_t*>(b_lane),
                  static_cast<const int64_t*>(rw),
                  static_cast<const int64_t*>(lens), l2,
                  static_cast<const int64_t*>(back),
                  static_cast<const int32_t*>(slot),
                  static_cast<int32_t*>(live), n, seq_len, primary, L, W16};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pos_bytes == 4) {
    shard_ext_step_kernel<int32_t><<<blocks_of(n), kThreads, 0, st>>>(a);
  } else {
    shard_ext_step_kernel<int64_t><<<blocks_of(n), kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The walk step over n rows, in place: active (bool), rows, steps (int64);
// l2 as lf_shard_ext_step's; back and slot (n,) int32 from the bucket
// step; sa_intv a power of two above 1; live as lf_shard_ext_step's.
// Returns a cudaError_t.
extern "C" int lf_shard_walk_step(void* active, void* rows, void* steps,
                                  const void* l2, const void* back,
                                  const void* slot, void* live, long long n,
                                  long long seq_len, long long primary,
                                  int sa_intv, int pos_bytes, void* stream) {
  if (n < 0 || sa_intv < 2 || (sa_intv & (sa_intv - 1)) != 0 ||
      !aligned16(back) || (pos_bytes != 4 && pos_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const WalkArgs a{static_cast<uint8_t*>(active), static_cast<int64_t*>(rows),
                   static_cast<int64_t*>(steps), l2,
                   static_cast<const int64_t*>(back),
                   static_cast<const int32_t*>(slot),
                   static_cast<int32_t*>(live), n, seq_len, primary,
                   static_cast<int64_t>(sa_intv - 1)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pos_bytes == 4) {
    shard_walk_step_kernel<int32_t><<<blocks_of(n), kThreads, 0, st>>>(a);
  } else {
    shard_walk_step_kernel<int64_t><<<blocks_of(n), kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
