// The rank arithmetic of the FM index on the card, shared by the seeder's
// kernels: seed_ext.cu (a replicated index) and seed_shard.cu (an index
// striped over the ranks of a mesh), so the two cannot drift.
//
// A rank row of 128 BWT positions is 12 int64 values (the index's uint32
// words held as int64, FMIndex.device_arrays): the counts of A, C, G, T
// before the block, then its 8 BWT words of 16 2-bit chars, the first
// char in the highest bits (fm_blocks; occ_cp + bwt_blocks hold the same
// values in two arrays).  A Row holds one occ query's row in registers as
// 16-byte pieces; occ_of_row counts from it (bwt_occ, lib/bwa/bwt.c:107-129,
// with the primary-row adjustment) and walk_next takes one inverse-Psi
// step (bwt_invPsi, lib/bwa/bwt.c:53-59) from it.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace fm_rank {

constexpr int64_t kMaxAnchor = 4095;  // ops/fm_index.py MAX_ANCHOR_LEN

__device__ __forceinline__ int64_t ld(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

// L2 (the count of chars smaller than c) in registers: five values
// selected by c, so no array of them goes to local memory
struct L2 {
  int64_t v0, v1, v2, v3, v4;
  __device__ __forceinline__ int64_t operator[](int c) const {
    return c == 0 ? v0 : c == 1 ? v1 : c == 2 ? v2 : c == 3 ? v3 : v4;
  }
};

// element i of an int32 or int64 array of the index's position dtype
template <typename Pos>
__device__ __forceinline__ int64_t pos_at(const void* p, int64_t i) {
  if constexpr (sizeof(Pos) == 8) {
    return ld(static_cast<const int64_t*>(p) + i);
  } else {
    return static_cast<int64_t>(__ldg(static_cast<const int32_t*>(p) + i));
  }
}

template <typename Pos>
__device__ __forceinline__ L2 load_l2(const void* l2) {
  return L2{pos_at<Pos>(l2, 0), pos_at<Pos>(l2, 1), pos_at<Pos>(l2, 2),
            pos_at<Pos>(l2, 3), pos_at<Pos>(l2, 4)};
}

// One occ query's rank row in registers: the four counts and the BWT
// word pairs up to the pair of the row's word (the rest are not loaded,
// zero), with the queried row and its position in the block.
struct Row {
  longlong2 cnt01, cnt23;
  longlong2 w01, w23, w45, w67;
  int64_t k;  // the queried row: < 0 and == seq_len are special
  int off;    // the row's char in its block of 128 (word off >> 4)
};

// The $-removed BWT position of an occ query of row k: k clamped into
// [0, seq_len - 1] and shifted past primary (bwt_occ's adjustment).
__device__ __forceinline__ int64_t occ_pos(int64_t seq_len, int64_t primary,
                                           int64_t k) {
  const int64_t kk = k < 0 ? 0 : (k < seq_len - 1 ? k : seq_len - 1);
  return kk - (kk >= primary ? 1 : 0);
}

// The rank row of position pos (its counts at cp, its words at wp), for
// the query of row k, all its loads issued together (16 bytes each, the
// read-only path): one round trip.
__device__ __forceinline__ void load_rank_row(const longlong2* cp,
                                              const longlong2* wp,
                                              int64_t pos, int64_t k,
                                              Row& row) {
  row.k = k;
  row.off = static_cast<int>(pos & 127);
  const int f = row.off >> 4;
  const longlong2 z = make_longlong2(0, 0);
  row.cnt01 = __ldg(cp);
  row.cnt23 = __ldg(cp + 1);
  row.w01 = __ldg(wp);
  row.w23 = f >= 2 ? __ldg(wp + 1) : z;
  row.w45 = f >= 4 ? __ldg(wp + 2) : z;
  row.w67 = f >= 6 ? __ldg(wp + 3) : z;
}

// per-char match bits of a BWT word (low bit of each 2-bit char)
__device__ __forceinline__ uint32_t match(uint32_t w, int c) {
  const uint32_t hi = (c & 2) ? w : ~w;
  const uint32_t lo = (c & 1) ? w : ~w;
  return (hi >> 1) & lo & 0x55555555u;
}

// the chars 0..n - 1 of a BWT word (the first char highest)
__device__ __forceinline__ uint32_t first_chars(int n) {
  return n >= 16 ? ~0u : (n <= 0 ? 0u : ~0u << (32 - 2 * n));
}

// occ(k, c) from a loaded row (bwt_occ with the primary-row adjustment):
// the count of c before the row's block plus, in 32-bit arithmetic on the
// block offset, the c's among the block's chars 0..off: each word's match
// bits masked to those chars, one popcount a word (the words past the
// row's are not loaded, zero, and masked out), all eight independent, in
// place of a select a word.
__device__ __forceinline__ int64_t occ_of_row(int64_t seq_len, const L2& l2,
                                              const Row& row, int c) {
  if (row.k < 0) return 0;
  if (row.k == seq_len) return l2[c + 1] - l2[c];
  const int64_t base = c == 0 ? row.cnt01.x : c == 1 ? row.cnt01.y
                     : c == 2 ? row.cnt23.x : row.cnt23.y;
  const int n = row.off + 1;
  auto masked = [&](int64_t w, int first) {
    return __popc(match(static_cast<uint32_t>(w), c) &
                  first_chars(n - first));
  };
  const uint32_t cnt = masked(row.w01.x, 0) + masked(row.w01.y, 16) +
                       masked(row.w23.x, 32) + masked(row.w23.y, 48) +
                       masked(row.w45.x, 64) + masked(row.w45.y, 80) +
                       masked(row.w67.x, 96) + masked(row.w67.y, 112);
  return base + static_cast<int64_t>(cnt);
}

// the char of a loaded row's own position, from its word
__device__ __forceinline__ int row_char(const Row& row) {
  const int f = row.off >> 4;
  const longlong2 p = f >= 6 ? row.w67 : f >= 4 ? row.w45
                    : f >= 2 ? row.w23 : row.w01;
  const uint32_t w = static_cast<uint32_t>((f & 1) ? p.y : p.x);
  return static_cast<int>((w >> ((15 - (row.off & 15)) << 1)) & 3u);
}

// One inverse-Psi step from row k != primary, from the rank row of x = k -
// (k > primary) loaded for the query of row k: L2[c] + occ(k, c), c the
// char at x.  For k < seq_len the rank row of x is k's own, and its word
// holds c; row seq_len, past the last rank row, counts c's total and takes
// c from the row of x = seq_len - 1.
__device__ __forceinline__ int64_t walk_next(int64_t seq_len, const L2& l2,
                                             const Row& row) {
  const int c = row_char(row);
  return l2[c] + occ_of_row(seq_len, l2, row, c);
}

}  // namespace fm_rank
