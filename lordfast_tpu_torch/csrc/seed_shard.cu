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
//                          bucket of the (D, cap) send buffer, in query
//                          order (fm_index.bucket's slots, bit for bit):
//                          one scan over the queries with a decoupled
//                          look-back across blocks, and the -1 tail of
//                          every bucket, in one launch (see below); a
//                          query past its bucket's cap takes no slot and
//                          the overflow flag is raised.  Dead lanes send
//                          nothing.  On the all-gather route a query's slot
//                          is its index.
//   (all_to_all_single of the row ids, equal splits)
//   shard_answer_kernel    every received row id answered from this rank's
//                          stripe, a thread a 16-byte piece of a row, zeros
//                          where this rank does not own the row; on the
//                          routed route an empty slot (id -1) is left
//                          unwritten (see below)
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
// kernels use too.  The step kernels run in place over a compacted list
// of live lanes (see below); on the last step of a block of steps the
// list's count is the block's live lanes, which the block's one
// all_reduce (MAX) carries beside the overflow flag: one host read a
// block.
//
// What bounds it on the card: the host around the kernels, and within
// them bytes and latency.  A step's four launches and two collectives
// take rank 0's device timer 0.4-0.9 ms, its four kernels ~0.012 ms
// summed over a call (PERF.md, Sharded seeding loops).  The step
// kernels' dense first step (128,000 lanes) takes 0.017-0.019 ms against
// a bytes bound of 0.0067; a list step 0.005-0.008 ms back to back
// (~0.003 alone) against a latency floor of ~0.0025: an empty launch of
// its grid and two dependent loads.  At v2's first sharded call on one
// H100 the answer moves ~52 MB in ~0.021 ms (its bytes bound 0.0115
// ms); the bucket ~7 MB in ~0.010 ms (bound 0.0021 ms), most of it a
// floor that does not shrink with the queries: the launch, a ticket a
// block and the look-back's round trips through L2 (~6 us on 44,000
// queries).  Lane
// state stays in device memory between steps, so nothing crosses to the
// host inside a block.
//
// The bucket's design.  A bucket's slots go to its owner's queries in
// query order, so a query's slot is its owner's count of asked queries
// before it: an exclusive scan, a count an owner, over the queries.  A
// block takes a tile of kTile consecutive queries (a warp kItems rounds of
// 32 of them, in order): each round's queries to one owner count
// themselves with one __match_any_sync, their leader adding the round to
// the warp's running count of that owner in shared memory; the warps'
// counts are then scanned in warp order and the tile's own count of each
// owner published (flag clear); a warp an owner (D <= kMaxOwners) finds
// the tiles before this one through a decoupled look-back (Merrill and
// Garland, 2016): 32 earlier tiles' words a round, nearest first, their
// counts summed up to the nearest that holds an inclusive prefix (flag
// set); then the tile publishes its own inclusive prefix, and each query
// takes its slot: the earlier tiles' count of its owner, the earlier
// warps' and its place in its warp's rounds (its block read again, from
// L1, rather than kept across the look-back).  A block's tile is its ticket
// (one atomicAdd a block), not its blockIdx, so a block waits only on
// blocks that have started, which cannot deadlock.  The look-back words
// carry the call's epoch, a counter the wrapper passes, so words of an
// earlier call read as not yet published and nothing is zeroed between
// calls; the last block to take a ticket sets the ticket counter back to
// 0.  The block that closes the scan writes each owner's count and
// raises the overflow flag.  Blocks whose tickets follow every tile's
// are fill blocks: they wait for that inclusive prefix and write -1 into
// each bucket's slots past its count, which no scan block writes, so no
// memset is issued and no query races a fill.
//
// The answer's design.  Thread t copies piece t % 6 of slot t / 6: six
// adjacent lanes load one row's 96 contiguous bytes (fm_blocks; occ_cp's
// 2 pieces then bwt_blocks' 4), and a warp stores 512 contiguous bytes.
// On the routed route a slot whose id is -1 is not written: no consumer
// reads it.  The send buffer's slot s is -1 exactly when no query of its
// rank took s, and the all_to_all carries out's slot s of this rank back
// to that rank's back[s]; row_at reads back only at a slot a query took
// (s >= 0), and fm_index.by_slot reads back[0] for slot -1 but masks it
// to zeros.  On the all-gather route every slot this rank does not own
// is written as zeros, since the reduce_scatter sums every rank's
// answers.
//
// The steps' design.  A loop's lanes die step by step (an extension call
// runs ~565 steps, most lanes dead within two; a walk starts with ~5% of
// its rows active), so a step runs over a list of the live lanes, not
// over every lane's flag: the first step of a block (and of a block run
// again, from its saved state) reads every flag and writes a list; each
// later step runs a thread a list entry and writes the next list (two
// lists, in turns).  A block reserves its live lanes' slots in the list
// it writes with one atomicAdd as soon as it knows them, before their
// loads, and each lane fills its slot after its step: the index of a
// lane kept alive, -1 for one that died, which the next step skips; a
// block with no live lane leaves at its first barrier, which counts
// them (__syncthreads_count), with no atomic.  (A slot taken only once
// the survivors are known costs a dependent atomic round trip at every
// warp's end; one atomicAdd a warp, reserved early, contends on one
// address across the ~4,000-13,000 warps of a first step: on one H100
// each made the first steps 2-4 us slower than the parent's, PERF.md.)
// A step's grid covers the group's most live lanes at the block's start
// (the host holds that count from the block's read; lanes only die), a
// thread a list entry, and its threads past the list's count, which
// they read on the card, do nothing: no host read and no memset inside
// a block.  (A persistent grid of one block an SM, striding over the
// list, was no faster on the sparse steps: PERF.md.)  The counts are a
// ring of three: step g reserves on count g %
// 3, reads count (g - 1) % 3 and zeroes count (g + 1) % 3
// (ops/fm_shard_cuda.py's LaneList), so the count it reserves on was
// zeroed a step before and the one it zeroes was read a step before; a
// block's last step also counts its kept lanes into the block's live
// count.  The list's order follows the atomics; a lane's step reads and
// writes only its own state, so the results do not depend on it.  The
// lane's loads that need no returned row (its state, both slots) are
// issued together, then the read word and length with both queries' row
// pieces (load_rank_row: only the pieces up to the row's word); L2 is
// read from shared memory once they have arrived.
//
// tests/test_torch_sharded_route.py holds a numpy model of these kernels
// (tests/torch_shard_model.py, names as here) against the plain versions
// and the plain loops.

#include <cstdint>

#include <cuda_runtime.h>

#include "fm_rank.cuh"

namespace {

using namespace fm_rank;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
// shard_bucket_kernel's blocks, large so that few take tickets: a scan
// block's tile of queries, a warp kItems rounds of 32 consecutive ones
// (tests/torch_shard_model.py and ops/fm_shard_cuda.py BUCKET_TILE use
// the same sizes)
constexpr int kBucketThreads = 512;
constexpr int kWarps = kBucketThreads / 32;
constexpr int kItems = 4;
constexpr int64_t kTile = kBucketThreads * kItems;
// owners a launch routes to: one thread an owner scans the warps' counts
constexpr int kMaxOwners = 256;
static_assert(kMaxOwners <= kBucketThreads, "a thread an owner");
// send slots a fill block covers
constexpr int64_t kFillSlots = kBucketThreads * 16;
// a look-back word: the call's epoch in bits 63-32, the inclusive flag in
// bit 31, the count in bits 30-0
constexpr unsigned long long kIncl = 0x80000000ull;
constexpr unsigned long long kCount = 0x7FFFFFFFull;

struct BucketArgs {
  const uint8_t* live;  // (n,) bool: the lane's alive / active flag
  const int64_t* k;     // (n,) the interval's k (extension), the row
                        // (walk) or the row id itself (ids)
  const int64_t* l;     // (n,) the interval's l, or null
  int64_t* send;        // (D cap,) row ids, -1 in the empty slots; or (Q,)
  int32_t* slot;        // (Q,) each query's slot, -1 for none
  int32_t* counts;      // (D,) each owner's asked queries
  int32_t* over;        // set to 1 when a query finds its bucket full
  unsigned long long* status;  // (n_scan, D) look-back words
  unsigned* ticket;            // the tickets taken; 0 between calls
  int64_t n, seq_len, primary, rps, cap;
  int D, all_gather, ids, n_scan, n_fill;
  unsigned epoch;
  double inv_rps;  // 1 / rps
};

// Query i of a step: on an extension the rows k - 1 (i < n) and l (i >= n)
// of lane i mod n, as backward_ext stacks them; on a walk row i's step.
// The query's rank row is the block of its occ position (occ_pos) or, on a
// walk, of x = k - (k > primary), whose row also holds x's char; the
// primary row steps to 0 and asks for nothing.  With ids, query i asks for
// row k[i] itself (a locate's sampled SA entries).  Returns whether query
// i asks, and its block in blk.  A dead lane's k is not read: most lanes
// of a loop's later steps are dead (the read-only path, so a second pass
// finds a live lane's in L1).
__device__ __forceinline__ bool query_block(const BucketArgs& a, int64_t i,
                                            int64_t& blk) {
  const int64_t lane = i < a.n ? i : i - a.n;
  if (__ldg(a.live + lane) == 0) return false;
  const int64_t k = a.l != nullptr && i >= a.n ? ld(a.l + lane)
                                               : ld(a.k + lane);
  if (a.ids) {
    blk = k;
    return true;
  }
  if (a.l != nullptr) {
    blk = occ_pos(a.seq_len, a.primary, i < a.n ? k - 1 : k) >> 7;
    return true;
  }
  blk = (k - (k > a.primary ? 1 : 0)) >> 7;
  return k != a.primary;
}

// The owner of rank-row block blk: min(max(blk / rps, 0), D - 1), from a
// double estimate of the quotient corrected by one either way (exact for
// blk < 2^52), since a 64-bit division is a call whose saved registers
// go to a stack frame.
__device__ __forceinline__ int owner_of(const BucketArgs& a, int64_t blk) {
  if (blk < 0) return 0;
  int64_t o = static_cast<int64_t>(static_cast<double>(blk) * a.inv_rps);
  if (o * a.rps > blk) {
    --o;
  } else if ((o + 1) * a.rps <= blk) {
    ++o;
  }
  return o < a.D - 1 ? static_cast<int>(o) : a.D - 1;
}

__device__ __forceinline__ void lb_publish(unsigned long long* p,
                                           unsigned epoch, bool incl,
                                           unsigned count) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      (static_cast<unsigned long long>(epoch) << 32) | (incl ? kIncl : 0ull) |
      count;
}

// The word at p once this call has published it (with incl: once it
// holds an inclusive prefix).
__device__ __forceinline__ unsigned long long lb_wait(
    const unsigned long long* p, unsigned epoch, bool incl) {
  const volatile unsigned long long* v = p;
  unsigned long long w = *v;
  while (static_cast<unsigned>(w >> 32) != epoch ||
         (incl && (w & kIncl) == 0)) {
    if (incl) __nanosleep(100);  // a fill block: off the scan's path
    w = *v;
  }
  return w;
}

// The owner of query i (-1: it asks nothing, or i >= n_q), its block in
// blk.
__device__ __forceinline__ int query_owner(const BucketArgs& a, int64_t i,
                                           int64_t n_q, int64_t& blk) {
  blk = -1;
  return i < n_q && query_block(a, i, blk) ? owner_of(a, blk) : -1;
}

// One round of a warp's queries, a lane's to owner (-1: none): the
// round's queries to one owner take their places after the warp's count
// of that owner (wc, the warp's row of wcount), their leader adding them
// to it.  Returns the lane's place.
__device__ __forceinline__ int take_round(int owner, int* wc) {
  const int me = static_cast<int>(threadIdx.x & 31);
  const unsigned peers = __match_any_sync(kFull, owner);
  int r = 0;
  if (owner >= 0) {
    const int lead = __ffs(peers) - 1;
    int c = 0;
    if (me == lead) {
      c = wc[owner];
      wc[owner] = c + __popc(peers);
    }
    r = __shfl_sync(peers, c, lead) + __popc(peers & ((1u << me) - 1u));
  }
  __syncwarp();
  return r;
}

// Owner o's asked queries in the tiles before tile t (t > 0), found by
// the calling warp: a round of 32 earlier tiles, nearest first, a lane
// waiting for each one's word, until a round holds an inclusive prefix;
// the counts up to the nearest inclusive prefix are summed.
__device__ __forceinline__ unsigned look_back(const BucketArgs& a, int64_t t,
                                              int o) {
  const int me = static_cast<int>(threadIdx.x & 31);
  unsigned excl = 0;
  for (int64_t top = t - 1;; top -= 32) {
    const int64_t j = top - me;
    unsigned long long x = kIncl;  // before tile 0: an inclusive 0
    if (j >= 0) x = lb_wait(a.status + j * a.D + o, a.epoch, false);
    const unsigned incl = __ballot_sync(kFull, (x & kIncl) != 0);
    const int stop = incl != 0u ? __ffs(incl) - 1 : 31;
    unsigned v = me <= stop ? static_cast<unsigned>(x & kCount) : 0u;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    excl += v;
    if (incl != 0u) return excl;
  }
}

__global__ void __launch_bounds__(kBucketThreads) shard_bucket_kernel(
    const __grid_constant__ BucketArgs a) {
  const int64_t n_q = a.l != nullptr ? 2 * a.n : a.n;
  if (a.all_gather) {  // the same for the whole grid: query i in slot i
    const int64_t i =
        static_cast<int64_t>(blockIdx.x) * kBucketThreads + threadIdx.x;
    if (i < n_q) {
      int64_t blk = -1;
      a.send[i] = query_block(a, i, blk) ? blk : -1;
      a.slot[i] = static_cast<int32_t>(i);
    }
    return;
  }
  __shared__ int wcount[kWarps][kMaxOwners];  // a warp's count an owner
  __shared__ int run[kMaxOwners];             // the tile's own counts
  __shared__ int boff[kMaxOwners];            // the tiles before this one's
  __shared__ unsigned tk;
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(a.ticket, 1u);
    if (t == gridDim.x - 1) *a.ticket = 0;  // every block has its ticket
    tk = t;
  }
  __syncthreads();
  const int64_t t = tk;
  const int o = static_cast<int>(threadIdx.x);  // the owner a thread scans
  if (t >= a.n_scan) {  // a fill block: -1 past each bucket's count
    if (o < a.D) {
      const int64_t c = static_cast<int64_t>(
          lb_wait(a.status + (a.n_scan - 1) * a.D + o, a.epoch, true) &
          kCount);
      boff[o] = static_cast<int>(c < a.cap ? c : a.cap);
    }
    __syncthreads();
    const int64_t stride = static_cast<int64_t>(a.n_fill) * kBucketThreads;
    const int64_t first = (t - a.n_scan) * kBucketThreads + threadIdx.x;
    for (int ow = 0; ow < a.D; ++ow) {
      int64_t* bucket = a.send + ow * a.cap;
      for (int64_t r = boff[ow] + first; r < a.cap; r += stride) {
        bucket[r] = -1;
      }
    }
    return;
  }
  // tile t's queries, each warp's kItems rounds in order, counted, then
  // placed after the earlier tiles' and warps' queries of their owners
  const int w = static_cast<int>(threadIdx.x >> 5);
  const int me = static_cast<int>(threadIdx.x & 31);
  for (int ow = me; ow < a.D; ow += 32) wcount[w][ow] = 0;
  __syncwarp();
  const int64_t first = t * kTile + w * (32 * kItems);
  int own[kItems], place[kItems];
  {
    int64_t blk[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {  // every round's loads at once
      own[it] = query_owner(a, first + it * 32 + me, n_q, blk[it]);
    }
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    place[it] = take_round(own[it], wcount[w]);
  }
  __syncthreads();
  if (o < a.D) {  // the warps' counts scanned in warp order, published
    int c = 0;
    for (int ww = 0; ww < kWarps; ++ww) {
      const int x = wcount[ww][o];
      wcount[ww][o] = c;
      c += x;
    }
    run[o] = c;
    boff[o] = 0;
    lb_publish(a.status + t * a.D + o, a.epoch, t == 0,
               static_cast<unsigned>(c));
  }
  __syncthreads();
  for (int ow = w; ow < a.D; ow += kWarps) {  // a warp looks back an owner
    const unsigned excl = t > 0 ? look_back(a, t, ow) : 0u;
    if (me == 0) {
      const int64_t total = static_cast<int64_t>(excl) + run[ow];
      if (t > 0) {
        boff[ow] = static_cast<int>(excl);
        lb_publish(a.status + t * a.D + ow, a.epoch, true,
                   static_cast<unsigned>(total));
      }
      if (t == a.n_scan - 1) {  // the scan's last tile: the totals
        a.counts[ow] = static_cast<int32_t>(total);
        if (total > a.cap) *a.over = 1;
      }
    }
  }
  __syncthreads();
  // each query's slot: the earlier tiles', the earlier warps' and its
  // place in its warp's rounds (its block read again, from L1)
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = first + it * 32 + me;
    if (i < n_q) {
      int32_t s = -1;
      if (own[it] >= 0) {
        const int64_t r = static_cast<int64_t>(boff[own[it]]) +
                          wcount[w][own[it]] + place[it];
        if (r < a.cap) {
          int64_t blk = -1;
          query_block(a, i, blk);
          s = static_cast<int32_t>(own[it] * a.cap + r);
          a.send[s] = blk;
        }
      }
      a.slot[i] = s;
    }
  }
}

struct AnswerArgs {
  const int64_t* recv;    // (n,) row ids, -1 for none
  const void* rank_a;     // this rank's stripe: fm_blocks (rps, 12) or
  const int64_t* rank_b;  // occ_cp (rps, 4) with bwt_blocks (rps, 8); or
                          // sa_samp (rps,) int32 or int64 (width 1)
  void* out;              // (n, 12) int64 as 6 pieces a row, or (n,) int64
  int64_t n, rps, base;   // base: this rank's first global row
  int fused, width, elem_bytes, routed;
};

__global__ void __launch_bounds__(kThreads) shard_answer_kernel(
    const AnswerArgs a) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (a.width == 1) {  // a sampled SA entry, as int64: a thread a slot
    if (t >= a.n) return;
    const int64_t id = ld(a.recv + t);
    if (a.routed && id == -1) return;
    const int64_t loc = id - a.base;
    int64_t v = 0;
    if (loc >= 0 && loc < a.rps) {
      v = a.elem_bytes == 8
              ? ld(static_cast<const int64_t*>(a.rank_a) + loc)
              : static_cast<int64_t>(
                    __ldg(static_cast<const int32_t*>(a.rank_a) + loc));
    }
    static_cast<int64_t*>(a.out)[t] = v;
    return;
  }
  if (t >= 6 * a.n) return;
  const int64_t s = t / 6;  // piece j of slot s
  const int j = static_cast<int>(t - 6 * s);
  const int64_t id = ld(a.recv + s);
  if (a.routed && id == -1) return;
  const int64_t loc = id - a.base;
  longlong2 v = make_longlong2(0, 0);
  if (loc >= 0 && loc < a.rps) {
    const longlong2* ra = static_cast<const longlong2*>(a.rank_a);
    const longlong2* src =
        a.fused ? ra + 6 * loc + j
                : (j < 2 ? ra + 2 * loc + j
                         : reinterpret_cast<const longlong2*>(a.rank_b) +
                               4 * loc + (j - 2));
    v = __ldg(src);
  }
  static_cast<longlong2*>(a.out)[t] = v;
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

// A step's lanes and its compacted list of live lanes.  The first step of
// a block of steps runs over every lane's flag (list_in null: n lanes);
// each later one over the list_in[0 .. *n_in) entries the step before it
// wrote: a lane it kept alive, or -1 for a lane that died there (skipped;
// no flag is read).  The step writes list_out, its slots reserved on
// *n_out; *live (or null) counts the kept lanes (a block's last step: the
// block's live count); thread 0 of block 0 sets *zero to 0: the count the
// next step reserves on, which the step before this one read (the counter
// ring of lf_shard_ext_step).  The list's order follows the atomics; no
// lane's step depends on another's.
struct Lanes {
  const int32_t* list_in;
  const int32_t* n_in;
  int32_t* list_out;
  int32_t* n_out;
  int32_t* live;
  int32_t* zero;
  int64_t n;
};

// step(lane) -> whether the lane stays alive, for every item of the step
// (a flag, or a list entry), a thread an item: the wrapper's grid covers
// the step's items (every lane on a block's first step; on a list step
// the group's live lanes at the block's start, which no list of the block
// outnumbers: it traps if one does).  A list step's entry is loaded
// beside the list's count.  The block's first barrier counts its live
// lanes (a block with none returns there); thread 0 then reserves their
// list_out slots with one atomicAdd, issued before the lanes' loads and
// awaited only after their step, and each warp's live lanes fill the
// warp's run of them: its kept lanes first, then -1 for each that died.
// Items and lanes are 32-bit: n <= 2^30 (make_lanes).
template <typename Pos, typename Step>
__device__ __forceinline__ void for_lanes(const Lanes& s,
                                          const uint8_t* flags,
                                          const void* l2, int64_t* l2s,
                                          Step step) {
  __shared__ int woff[kThreads / 32];  // each warp's first slot in its block's
  __shared__ int base;                 // the block's first slot
  const int t = static_cast<int>(threadIdx.x);
  const int i = static_cast<int>(blockIdx.x) * kThreads + t;
  const int n = static_cast<int>(s.n);
  if (blockIdx.x == 0 && t == 0) *s.zero = 0;
  // L2 into shared memory, its load beside the item's (the first barrier
  // below waits for both)
  if (t < 5) l2s[t] = pos_at<Pos>(l2, t);
  int lane = i;
  bool alive = false;
  if (s.list_in != nullptr) {
    const int entry = i < n ? __ldg(s.list_in + i) : -1;
    const int items = __ldg(s.n_in);
    if (blockIdx.x == 0 && t == 0 &&
        items > static_cast<int>(gridDim.x) * kThreads) {
      __trap();  // a list longer than the grid: lanes would be skipped
    }
    lane = entry;
    alive = i < items && entry >= 0;
  } else {
    alive = i < n && flags[i] != 0;
  }
  const int me = t & 31;
  const int w = t >> 5;
  const unsigned b_alive = __ballot_sync(kFull, alive);
  if (me == 0) woff[w] = __popc(b_alive);
  if (__syncthreads_count(alive) == 0) return;  // uniform in the block
  int got = 0;  // thread 0: the block's first slot, still in flight
  if (t == 0) {
    int sum = 0;
    for (int k = 0; k < kThreads / 32; ++k) {
      const int c = woff[k];
      woff[k] = sum;
      sum += c;
    }
    got = atomicAdd(s.n_out, sum);
  }
  const bool keep = alive && step(lane);
  const unsigned b_keep = __ballot_sync(kFull, keep);
  if (t == 0) base = got;
  __syncthreads();
  if (alive) {
    const unsigned lt = (1u << me) - 1u;
    const int at = keep ? __popc(b_keep & lt)
                        : __popc(b_keep) + __popc(b_alive & ~b_keep & lt);
    s.list_out[base + woff[w] + at] = keep ? lane : -1;
  }
  if (s.live != nullptr && me == 0 && b_keep != 0u) {
    atomicAdd(s.live, __popc(b_keep));
  }
}

// L2 from the block's shared memory (for_lanes fills it)
__device__ __forceinline__ L2 shared_l2(const int64_t* l2s) {
  return L2{l2s[0], l2s[1], l2s[2], l2s[3], l2s[4]};
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
  int64_t n, seq_len, primary;
  int L, W16;
};

// occ_pos in the index's position type: with Pos = int32_t every row fits
// (seq_len < 2^31), so the clamp and the shift are 32-bit there.
template <typename Pos>
__device__ __forceinline__ Pos occ_pos_as(Pos seq_len, Pos primary, Pos k) {
  const Pos kk = k < 0 ? 0 : (k < seq_len - 1 ? k : seq_len - 1);
  return kk - (kk >= primary ? 1 : 0);
}

// One greedy extension step of an alive lane (_ext_steps' body): the
// complement of the next read char as one backward-extension step of [k,
// l]; the lane dies at a non-ACGT char, past the read's end, on an empty
// interval or at MAX_ANCHOR_LEN.  Returns whether it stays alive.  The
// loads that need no returned row are issued first, together (the lane's
// state and both slots), then the read's word and length with both
// queries' row pieces; L2 comes from shared memory (l2s) once they have
// arrived.  Rows are Pos arithmetic, read positions (below L) 32-bit.
template <typename Pos>
__device__ __forceinline__ bool ext_lane(const ExtArgs& a, const int64_t* l2s,
                                         int lane) {
  const Pos k = static_cast<Pos>(a.k[lane]);
  const Pos l = static_cast<Pos>(a.l[lane]);
  const int32_t m = static_cast<int32_t>(a.m[lane]);
  const int32_t pf = static_cast<int32_t>(ld(a.pos_f + lane));
  const int64_t b = ld(a.b_lane + lane);
  const int32_t sk = __ldg(a.slot + lane);
  const int32_t sl = __ldg(a.slot + a.n + lane);
  const Pos seq_len = static_cast<Pos>(a.seq_len);
  const Pos primary = static_cast<Pos>(a.primary);
  const int32_t q = pf + m;  // the next read position to consume
  const int32_t qc = q < a.L ? q : a.L - 1;
  const int64_t word = ld(a.rw + b * a.W16 + (qc >> 4));
  const int64_t len = ld(a.lens + b);
  Row rk, rl;
  row_at(a.back, sk, occ_pos_as<Pos>(seq_len, primary, k - 1), k - 1, rk);
  row_at(a.back, sl, occ_pos_as<Pos>(seq_len, primary, l), l, rl);
  const int c = static_cast<int>((word >> (3 * (15 - (qc & 15)))) & 7);
  const bool ok_char = q < len && c < 4;
  const int cc = ok_char ? 3 - c : 0;  // complemented
  const L2 l2 = shared_l2(l2s);
  const int64_t nk = l2[cc] + occ_of_row(a.seq_len, l2, rk, cc) + 1;
  const int64_t nl = l2[cc] + occ_of_row(a.seq_len, l2, rl, cc);
  const bool alive = ok_char && nk <= nl && m < kMaxAnchor;
  if (alive) {
    a.k[lane] = nk;
    a.l[lane] = nl;
    a.m[lane] = m + 1;
  } else {
    a.alive[lane] = 0;
  }
  return alive;
}

// One extension step of a block's lanes (Lanes): its first over the alive
// flags, a later one over the list; a dead lane is left as it is.
template <typename Pos>
__global__ void __launch_bounds__(kThreads) shard_ext_step_kernel(
    const ExtArgs a, const Lanes s) {
  __shared__ int64_t l2s[5];
  for_lanes<Pos>(s, a.alive, a.l2, l2s,
                 [&](int lane) { return ext_lane<Pos>(a, l2s, lane); });
}

struct WalkArgs {
  uint8_t* active;         // (n,) in place
  int64_t* rows;
  int64_t* steps;
  const void* l2;          // (5,) Pos
  const int64_t* back;     // (slots, 12) the returned rows
  const int32_t* slot;     // (n,)
  int64_t n, seq_len, primary, mask;
};

// One inverse-Psi step of an active row (the plain walk's body, bwt_sa of
// lib/bwa/bwt.c:86-96): the primary row steps to 0, any other row to
// walk_next of its returned row; the row stops at a sampled row (rows &
// mask == 0).  Returns whether it stays active.  Its row, steps and slot
// are loaded together, then the returned row's pieces (L2 from shared
// memory, l2s).
template <typename Pos>
__device__ __forceinline__ bool walk_lane(const WalkArgs& a,
                                          const int64_t* l2s, int i) {
  const Pos k = static_cast<Pos>(a.rows[i]);
  const int64_t steps = a.steps[i];
  const int32_t s = __ldg(a.slot + i);
  const Pos primary = static_cast<Pos>(a.primary);
  int64_t nxt = 0;
  if (k != primary) {
    Row row;
    row_at(a.back, s, k - (k > primary ? 1 : 0), k, row);
    nxt = walk_next(a.seq_len, shared_l2(l2s), row);
  }
  a.rows[i] = nxt;
  a.steps[i] = steps + 1;
  const bool active = (nxt & a.mask) != 0;
  if (!active) a.active[i] = 0;
  return active;
}

// One walk step of a block's rows (Lanes), as shard_ext_step_kernel's.
template <typename Pos>
__global__ void __launch_bounds__(kThreads) shard_walk_step_kernel(
    const WalkArgs a, const Lanes s) {
  __shared__ int64_t l2s[5];
  for_lanes<Pos>(s, a.active, a.l2, l2s,
                 [&](int i) { return walk_lane<Pos>(a, l2s, i); });
}

// An empty kernel: a step's latency floor starts from the back-to-back
// time of its grid's empty launch (chip_smoke.py step_floor).
__global__ void __launch_bounds__(kThreads) shard_noop_kernel() {}

unsigned blocks_of(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// A step's Lanes from the step kernels' arguments (see Lanes): the first
// step of a block over the flags (list_in and n_in null) or a later one
// over list_in[0 .. *n_in); list_out (n,) int32 and the count n_out
// (int32) its slots are reserved on; live (int32) or null; zero (int32).
// n_grid in [1, n]: the lanes the grid covers, a thread each (n on a
// first step; on a list step the block's live lanes at its start, which
// its lists never outnumber); n <= 2^30.  False on arguments the kernels
// do not take.
bool make_lanes(const void* list_in, const void* n_in, void* list_out,
                void* n_out, void* live, void* zero, long long n,
                long long n_grid, Lanes& s) {
  s = Lanes{static_cast<const int32_t*>(list_in),
            static_cast<const int32_t*>(n_in),
            static_cast<int32_t*>(list_out), static_cast<int32_t*>(n_out),
            static_cast<int32_t*>(live), static_cast<int32_t*>(zero), n};
  return n >= 0 && n <= (1ll << 30) &&
         (n == 0 || (n_grid >= 1 && n_grid <= n)) &&
         (list_in == nullptr) == (n_in == nullptr) &&
         (list_in != nullptr || n_grid == n) && list_out != nullptr &&
         n_out != nullptr && zero != nullptr;
}

}  // namespace

// The bucket step: n lanes' live flags (bool) and k (int64), with l
// (int64) for an extension (2 n queries) or null for a walk (n queries)
// or, with ids, for n queries of the row ids k themselves;
// the rank stripes' rows a rank rps; D ranks; cap slots an owner.  Routed
// (all_gather 0, D <= 256): send (D cap,) int64 gets the row ids (-1 in
// the empty slots), slot (Q,) int32 each query's slot or -1, counts (D,)
// int32 each owner's asked queries, *over (int32) is set to 1 if a bucket
// overflowed (never cleared here); status (status_words >= D ceil(Q /
// 2048), at least D) int64 and ticket (int32, 0 before the first call)
// are the look-back's scratch, kept by the caller between calls, and
// epoch (never 0) differs from the previous calls' that used status.
// All-gather (1): send (Q,) gets each query's row id or -1, slot (Q,) its
// index.  Issues one launch and no memset.  Returns a cudaError_t (0 on a
// clean launch).
extern "C" int lf_shard_bucket(const void* live, const void* k, const void* l,
                               void* send, void* slot, void* counts,
                               void* over, void* status, void* ticket,
                               long long status_words, long long n,
                               long long seq_len, long long primary,
                               long long rps, long long cap, int D,
                               int all_gather, int ids, unsigned epoch,
                               void* stream) {
  const int64_t n_q = l != nullptr ? 2 * n : n;
  const int64_t n_scan = n_q > 0 ? (n_q + kTile - 1) / kTile : 1;
  if (n < 0 || D <= 0 || rps <= 0 || (ids && l != nullptr) ||
      n_q >= (1ll << 31) ||
      (!all_gather &&
       (cap <= 0 || D > kMaxOwners || counts == nullptr || over == nullptr ||
        status == nullptr || ticket == nullptr || epoch == 0 ||
        static_cast<long long>(D) * cap >= (1ll << 31) ||
        status_words < n_scan * D))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (all_gather && n_q == 0) return 0;
  const int64_t n_fill = (static_cast<int64_t>(D) * cap + kFillSlots - 1) /
                         kFillSlots;
  const BucketArgs a{static_cast<const uint8_t*>(live),
                     static_cast<const int64_t*>(k),
                     static_cast<const int64_t*>(l),
                     static_cast<int64_t*>(send),
                     static_cast<int32_t*>(slot),
                     static_cast<int32_t*>(counts),
                     static_cast<int32_t*>(over),
                     static_cast<unsigned long long*>(status),
                     static_cast<unsigned*>(ticket),
                     n, seq_len, primary, rps, cap, D, all_gather, ids,
                     static_cast<int>(n_scan), static_cast<int>(n_fill),
                     epoch, 1.0 / static_cast<double>(rps)};
  const unsigned grid =
      all_gather ? static_cast<unsigned>((n_q + kBucketThreads - 1) /
                                         kBucketThreads)
                 : static_cast<unsigned>(n_scan + n_fill);
  shard_bucket_kernel<<<grid, kBucketThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The answer step: n received row ids (int64, -1 for none), this rank's
// first global row base and stripe of rps rows.  Width 12: fused = 1:
// rank_a = fm_blocks (rps, 12); 0: rank_a = occ_cp (rps, 4), rank_b =
// bwt_blocks (rps, 8); int64, 16-byte aligned; out (n, 12) int64, 16-byte
// aligned: each owned row's 12 values, zeros for the rest.  Width 1: rank_a
// = sa_samp (rps,) of elem_bytes 4 or 8; out (n,) int64: each owned entry,
// 0 for the rest.  routed: a slot whose id is -1 is left as it is (the
// routed route; on the all-gather route, 0, it gets zeros).  Returns a
// cudaError_t.
extern "C" int lf_shard_answer(const void* recv, const void* rank_a,
                               const void* rank_b, void* out, long long n,
                               long long rps, long long base, int fused,
                               int width, int elem_bytes, int routed,
                               void* stream) {
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
                     fused, width, elem_bytes, routed};
  shard_answer_kernel<<<blocks_of(rows ? 6 * n : n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}


// The extension step over n lanes, in place: alive (bool), k, l, m (int64);
// pos_f, b_lane (n,) int64; the reads as 3-bit words rw (B, W16) int64 of
// L chars and lens (B,) int64; l2 (5,) int32 (pos_bytes 4) or int64 (8);
// back (slots, 12) int64, 16-byte aligned, and slot (2 n,) int32 from the
// bucket step; the lanes as make_lanes takes them (a list step's entries
// each a live lane, once, or -1).  Issues one launch and no memset.
// Returns a cudaError_t.
extern "C" int lf_shard_ext_step(void* alive, void* k, void* l, void* m,
                                 const void* pos_f, const void* b_lane,
                                 const void* rw, const void* lens,
                                 const void* l2, const void* back,
                                 const void* slot, const void* list_in,
                                 const void* n_in, void* list_out,
                                 void* n_out, void* live, void* zero,
                                 long long n,
                                 long long n_grid, long long seq_len,
                                 long long primary, int L, int W16,
                                 int pos_bytes, void* stream) {
  Lanes s;
  if (!make_lanes(list_in, n_in, list_out, n_out, live, zero, n, n_grid, s) ||
      L <= 0 || W16 * 16 < L || !aligned16(back) ||
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
                  static_cast<const int32_t*>(slot), n, seq_len, primary, L,
                  W16};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pos_bytes == 4) {
    shard_ext_step_kernel<int32_t><<<blocks_of(n_grid), kThreads, 0, st>>>(
        a, s);
  } else {
    shard_ext_step_kernel<int64_t><<<blocks_of(n_grid), kThreads, 0, st>>>(
        a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The walk step over n rows, in place: active (bool), rows, steps (int64);
// l2 as lf_shard_ext_step's; back and slot (n,) int32 from the bucket
// step; sa_intv a power of two above 1; the lanes as lf_shard_ext_step's.
// Returns a cudaError_t.
extern "C" int lf_shard_walk_step(void* active, void* rows, void* steps,
                                  const void* l2, const void* back,
                                  const void* slot, const void* list_in,
                                  const void* n_in, void* list_out,
                                  void* n_out, void* live, void* zero,
                                  long long n,
                                  long long n_grid, long long seq_len,
                                  long long primary, int sa_intv,
                                  int pos_bytes, void* stream) {
  Lanes s;
  if (!make_lanes(list_in, n_in, list_out, n_out, live, zero, n, n_grid, s) ||
      sa_intv < 2 || (sa_intv & (sa_intv - 1)) != 0 || !aligned16(back) ||
      (pos_bytes != 4 && pos_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const WalkArgs a{static_cast<uint8_t*>(active), static_cast<int64_t*>(rows),
                   static_cast<int64_t*>(steps), l2,
                   static_cast<const int64_t*>(back),
                   static_cast<const int32_t*>(slot), n, seq_len, primary,
                   static_cast<int64_t>(sa_intv - 1)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pos_bytes == 4) {
    shard_walk_step_kernel<int32_t><<<blocks_of(n_grid), kThreads, 0, st>>>(
        a, s);
  } else {
    shard_walk_step_kernel<int64_t><<<blocks_of(n_grid), kThreads, 0, st>>>(
        a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty launch of a step's grid over n_grid >= 1 lanes (256 threads a
// block, as the step kernels').  Returns a cudaError_t.
extern "C" int lf_shard_noop(long long n_grid, void* stream) {
  if (n_grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  shard_noop_kernel<<<blocks_of(n_grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
