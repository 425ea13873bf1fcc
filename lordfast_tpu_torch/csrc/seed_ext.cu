// The seeder's staged greedy backward extension with its occ == 1 finish,
// one thread per lane, for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's device loops in lordfast_tpu/ops/fm_index.py
// _seed_anchors_impl (:387): ext_loop_flat (:485, lax.while_loop :492),
// _resolve_rounds (:497, lax.while_loop :568) and staged_ext (:602), for
// a replicated index.  The port's plain version is ops/fm_index.py
// _staged_ext (eager: ~40 launches an extension step, a bool(act.any())
// a resolve round and a nonzero compaction a stage); it stays the CPU path
// and the oracle.  The sharded index's lockstep extension stays eager: it
// makes collective calls between steps, which a kernel cannot make.
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
// then a char by char comparison of the text left of p (pac_words, 2 bits
// a base) with the complemented read, stopping at the first mismatch, at
// the text's start, past the read or at MAX_ANCHOR_LEN: m grows by the
// run, rpos = p - run, rflag = 1, and k, l keep their one-row values.
// That is the plain version's schedule: a lane that reaches one row in
// mid-block keeps extending by rank queries until the block ends, and
// rflag depends on it.  The plain version compares 128-char chunks; the
// run it finds is the same.
//
// Design, simple and right first: one thread per lane (B x sampling_count
// lanes, 128,000 at the defaults), the whole loop in registers, no
// compaction and no host sync; the index rows are read through the
// read-only path (__ldg), and only the BWT words a query needs (those up
// to its row's word).  Lanes of a warp end at different steps and take
// different phases, and the warp issues until its last lane ends: that
// divergence is accepted here.  With `stats`, each lane also counts its
// extension steps, walk steps and compared chars, from which the smoke
// reports the warp efficiency (active lane-steps over issued ones).
//
// What bounds it on the card: the latency of the dependent row loads of
// the warp's longest lane (each extension step's two rank rows depend on
// the previous step's interval), not bytes: the rows the run's lane-steps
// read are a few MB.  Template instances: the two rank layouts, and the
// index's position dtype (int32 or int64) of sa_samp and L2.
// tests/test_torch_seed_ext.py holds a numpy model of this kernel (names
// as here) against the plain version and the JAX package.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int64_t kMaxAnchor = 4095;  // ops/fm_index.py MAX_ANCHOR_LEN

struct Args {
  const uint8_t* alive0;   // (BS,) bool
  const int64_t* k0;       // (BS,)
  const int64_t* l0;
  const int64_t* m0;
  const int64_t* pos_f;
  const int64_t* b_lane;
  const uint8_t* reads;    // (B, L) codes, 4 = N / pad
  const int32_t* lens;     // (B,)
  const int64_t* rank_a;   // fm_blocks (nb, 12), or occ_cp (nc, 4)
  const int64_t* rank_b;   // bwt_blocks (nb, 8) with occ_cp
  const int64_t* bwt_words;
  const void* sa_samp;     // Pos
  const void* l2;          // (5,) Pos
  const int64_t* pac_words;
  int64_t* k_out;
  int64_t* l_out;
  int64_t* m_out;
  int64_t* rpos_out;
  uint8_t* rflag_out;
  int32_t* stats;          // (BS, 3) or null
  int64_t n_lanes, seq_len, primary, n_sa;
  int L, phase1_steps, sa_intv, log2_intv;
};

__device__ __forceinline__ int64_t ld(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

__device__ __forceinline__ uint32_t word32(const int64_t* p) {
  return static_cast<uint32_t>(ld(p));
}

// per-char match bits of a BWT word (low bit of each 2-bit char)
__device__ __forceinline__ uint32_t match(uint32_t w, int c) {
  const uint32_t hi = (c & 2) ? w : ~w;
  const uint32_t lo = (c & 1) ? w : ~w;
  return (hi >> 1) & lo & 0x55555555u;
}

// L2 (the count of chars smaller than c) in registers: five values
// selected by c, so no array of them goes to local memory
struct L2 {
  int64_t v0, v1, v2, v3, v4;
  __device__ __forceinline__ int64_t operator[](int c) const {
    return c == 0 ? v0 : c == 1 ? v1 : c == 2 ? v2 : c == 3 ? v3 : v4;
  }
};

template <bool kFused>
__device__ __forceinline__ int64_t occ(const Args& a, const L2& l2,
                                       int64_t k, int c) {
  if (k < 0) return 0;
  if (k == a.seq_len) return l2[c + 1] - l2[c];
  const int64_t kk = k < a.seq_len - 1 ? k : a.seq_len - 1;
  const int64_t kp = kk - (kk >= a.primary ? 1 : 0);
  const int64_t blk = kp >> 7;
  const int off = static_cast<int>(kp & 127);
  const int f = off >> 4;  // word holding the row
  const int r = off & 15;  // char offset within it
  int64_t base;
  const int64_t* words;
  if (kFused) {
    const int64_t* row = a.rank_a + blk * 12;
    base = ld(row + c);
    words = row + 4;
  } else {
    base = ld(a.rank_a + blk * 4 + c);
    words = a.rank_b + blk * 8;
  }
  // the row's own word (its chars up to r) first, then the full words
  // before it: in this order ptxas keeps every instance off the stack
  // (the other order spilled 4 bytes in the fused int32 one, nvcc 12.9)
  uint32_t cnt = __popc(match(word32(words + f), c) &
                        ~((1u << ((15 - r) << 1)) - 1u));
  for (int w = 0; w < f; ++w) cnt += __popc(match(word32(words + w), c));
  return base + static_cast<int64_t>(cnt);
}

// element i of an int32 or int64 array of the index's position dtype
template <typename Pos>
__device__ __forceinline__ int64_t pos_at(const void* p, int64_t i) {
  if constexpr (sizeof(Pos) == 8) {
    return ld(static_cast<const int64_t*>(p) + i);
  } else {
    return static_cast<int64_t>(__ldg(static_cast<const int32_t*>(p) + i));
  }
}

template <bool kFused, typename Pos>
__global__ void __launch_bounds__(kThreads) seed_ext_kernel(const Args a) {
  const int64_t lane =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= a.n_lanes) return;
  bool alive = a.alive0[lane] != 0;
  int64_t k = a.k0[lane];
  int64_t l = a.l0[lane];
  int64_t m = a.m0[lane];
  int64_t rpos = 0;
  bool rflag = false;
  int32_t n_ext = 0, n_walk = 0, n_cmp = 0;
  if (alive) {
    const L2 l2{pos_at<Pos>(a.l2, 0), pos_at<Pos>(a.l2, 1),
                pos_at<Pos>(a.l2, 2), pos_at<Pos>(a.l2, 3),
                pos_at<Pos>(a.l2, 4)};
    const int64_t posf = a.pos_f[lane];
    const int64_t b = a.b_lane[lane];
    const uint8_t* read = a.reads + b * a.L;
    const int64_t len = a.lens[b];
    for (;;) {
      // phase1_steps greedy steps (_ext_steps)
      for (int s = 0; s < a.phase1_steps && alive; ++s) {
        const int64_t q = posf + m;  // next read position to consume
        const int c = read[q < a.L ? q : a.L - 1];
        const bool ok_char = q < len && c < 4;
        const int cc = ok_char ? 3 - c : 0;  // complemented
        const int64_t nk = l2[cc] + occ<kFused>(a, l2, k - 1, cc) + 1;
        const int64_t nl = l2[cc] + occ<kFused>(a, l2, l, cc);
        alive = ok_char && nk <= nl && m < kMaxAnchor;
        if (alive) {
          k = nk;
          l = nl;
          ++m;
        }
        ++n_ext;
      }
      if (!alive) break;
      if (k != l) continue;
      // one row at the block's end: locate it (_resolve_rounds' sa_lookup)
      int64_t p;
      if (a.sa_intv == 1) {
        const int64_t r = k < 0 ? 0 : (k < a.n_sa - 1 ? k : a.n_sa - 1);
        p = pos_at<Pos>(a.sa_samp, r);
      } else {
        const int64_t mask = a.sa_intv - 1;
        int64_t rows = k;
        int64_t steps = 0;
        while ((rows & mask) != 0) {  // _walk_step (bwt_invPsi)
          if (rows == a.primary) {
            rows = 0;
          } else {
            const int64_t x = rows - (rows > a.primary ? 1 : 0);
            const int ch = static_cast<int>(
                (word32(a.bwt_words + (x >> 4)) >> ((15 - (x & 15)) << 1)) &
                3u);
            rows = l2[ch] + occ<kFused>(a, l2, rows, ch);
          }
          ++steps;
          ++n_walk;
        }
        p = steps + pos_at<Pos>(a.sa_samp, rows >> a.log2_intv);
      }
      // the text left of p against the complemented read, char by char
      while (m < kMaxAnchor && p > 0) {
        const int64_t q = posf + m;
        if (q >= len) break;
        const int c = read[q];
        if (c >= 4) break;
        const int64_t tp = p - 1;
        const int tc = static_cast<int>(
            (word32(a.pac_words + (tp >> 4)) >> ((15 - (tp & 15)) << 1)) &
            3u);
        if (tc != 3 - c) break;
        ++m;
        --p;
        ++n_cmp;
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
  if (a.stats != nullptr) {
    a.stats[3 * lane] = n_ext;
    a.stats[3 * lane + 1] = n_walk;
    a.stats[3 * lane + 2] = n_cmp;
  }
}

template <bool kFused>
int launch_pos(const Args& a, int pos_bytes, cudaStream_t stream) {
  const unsigned grid =
      static_cast<unsigned>((a.n_lanes + kThreads - 1) / kThreads);
  if (pos_bytes == 4) {
    seed_ext_kernel<kFused, int32_t><<<grid, kThreads, 0, stream>>>(a);
  } else {
    seed_ext_kernel<kFused, int64_t><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Per lane (BS lanes): alive0 bool, k0, l0, m0, pos_f, b_lane int64;
// reads (B, L) uint8 and lens (B,) int32; the index: fused = 1 with
// rank_a = fm_blocks (nb, 12) int64, or fused = 0 with rank_a = occ_cp
// (nc, 4) and rank_b = bwt_blocks (nb, 8) int64; bwt_words and pac_words
// int64 (uint32 words); sa_samp (n_sa,) and l2 (5,) int32 (pos_bytes 4) or
// int64 (8); sa_intv a power of two.  Outputs k, l, m, rpos int64 and
// rflag bool per lane; stats (BS, 3) int32 or null.  Returns a
// cudaError_t (0 on a clean launch).
extern "C" int lf_seed_ext(
    const void* alive0, const void* k0, const void* l0, const void* m0,
    const void* pos_f, const void* b_lane, const void* reads,
    const void* lens, const void* rank_a, const void* rank_b,
    const void* bwt_words, const void* sa_samp, const void* l2,
    const void* pac_words, void* k_out, void* l_out, void* m_out,
    void* rpos_out, void* rflag_out, void* stats, long long n_lanes, int L,
    int phase1_steps, long long seq_len, long long primary, long long n_sa,
    int sa_intv, int pos_bytes, int fused, void* stream) {
  if (L <= 0 || phase1_steps <= 0 || sa_intv <= 0 ||
      (sa_intv & (sa_intv - 1)) != 0 || (pos_bytes != 4 && pos_bytes != 8) ||
      (!fused && rank_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_lanes <= 0) return 0;
  int log2_intv = 0;
  while ((1 << log2_intv) < sa_intv) ++log2_intv;
  auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  auto o64 = [](void* p) { return static_cast<int64_t*>(p); };
  const Args a{static_cast<const uint8_t*>(alive0), i64(k0), i64(l0),
               i64(m0), i64(pos_f), i64(b_lane),
               static_cast<const uint8_t*>(reads),
               static_cast<const int32_t*>(lens), i64(rank_a), i64(rank_b),
               i64(bwt_words), sa_samp, l2, i64(pac_words), o64(k_out),
               o64(l_out), o64(m_out), o64(rpos_out),
               static_cast<uint8_t*>(rflag_out),
               static_cast<int32_t*>(stats), n_lanes, seq_len, primary, n_sa,
               L, phase1_steps, sa_intv, log2_intv};
  auto st = static_cast<cudaStream_t>(stream);
  return fused ? launch_pos<true>(a, pos_bytes, st)
               : launch_pos<false>(a, pos_bytes, st);
}
