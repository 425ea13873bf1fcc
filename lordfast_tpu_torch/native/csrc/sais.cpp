// SA-IS suffix array construction (Nong, Zhang & Chan, 2009), implemented
// from the published algorithm for the lordfast-tpu index builder.
//
// Role in the engine: offline construction of the suffix array of the
// concatenated fwd+revcomp genome text, from which the BWT / FM-index
// device arrays are derived (the reference uses BWT-SW incremental
// construction, lib/bwa/bwt_gen.c, or induced sorting, lib/bwa/is.c, for
// the same purpose; this is an independent implementation).
//
// Exposed C ABI:
//   int sais_u8 (const uint8_t* T, int64_t* SA, int64_t n, int64_t K);
//   int bwt_from_sa(const uint8_t* T, const int64_t* SA, uint8_t* bwt,
//                   int64_t* primary, int64_t n);
// T must end with a unique smallest sentinel (value 0); K = alphabet size.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename CharT>
struct SaisProblem {
  const CharT* T;
  int64_t* SA;
  int64_t n;
  int64_t K;
};

template <typename CharT>
void get_buckets(const CharT* T, int64_t n, int64_t K, int64_t* bkt, bool end) {
  std::memset(bkt, 0, sizeof(int64_t) * K);
  for (int64_t i = 0; i < n; ++i) bkt[T[i]]++;
  int64_t sum = 0;
  for (int64_t c = 0; c < K; ++c) {
    sum += bkt[c];
    bkt[c] = end ? sum : sum - bkt[c];
  }
}

template <typename CharT>
void induce_l(const CharT* T, int64_t* SA, int64_t n, int64_t K,
              const std::vector<uint8_t>& t, int64_t* bkt) {
  get_buckets(T, n, K, bkt, /*end=*/false);
  for (int64_t i = 0; i < n; ++i) {
    int64_t j = SA[i];
    if (j > 0 && !t[j - 1]) SA[bkt[T[j - 1]]++] = j - 1;
  }
}

template <typename CharT>
void induce_s(const CharT* T, int64_t* SA, int64_t n, int64_t K,
              const std::vector<uint8_t>& t, int64_t* bkt) {
  get_buckets(T, n, K, bkt, /*end=*/true);
  for (int64_t i = n - 1; i >= 0; --i) {
    int64_t j = SA[i];
    if (j > 0 && t[j - 1]) SA[--bkt[T[j - 1]]] = j - 1;
  }
}

template <typename CharT>
void sais_main(const CharT* T, int64_t* SA, int64_t n, int64_t K) {
  if (n == 1) {
    SA[0] = 0;
    return;
  }
  // classify positions: 1 = S-type, 0 = L-type; sentinel is S.
  std::vector<uint8_t> t(n);
  t[n - 1] = 1;
  for (int64_t i = n - 2; i >= 0; --i)
    t[i] = (T[i] < T[i + 1]) || (T[i] == T[i + 1] && t[i + 1]);

  auto is_lms = [&](int64_t i) { return i > 0 && t[i] && !t[i - 1]; };

  std::vector<int64_t> bkt_v(K);
  int64_t* bkt = bkt_v.data();

  // ---- stage 1: sort LMS substrings by induced sorting ----
  for (int64_t i = 0; i < n; ++i) SA[i] = -1;
  get_buckets(T, n, K, bkt, /*end=*/true);
  for (int64_t i = 1; i < n; ++i)
    if (is_lms(i)) SA[--bkt[T[i]]] = i;
  induce_l(T, SA, n, K, t, bkt);
  induce_s(T, SA, n, K, t, bkt);

  // compact sorted LMS positions into SA[0..n1)
  int64_t n1 = 0;
  for (int64_t i = 0; i < n; ++i)
    if (SA[i] > 0 && is_lms(SA[i])) SA[n1++] = SA[i];

  // name LMS substrings; names go into SA[n1..n)
  for (int64_t i = n1; i < n; ++i) SA[i] = -1;
  int64_t name = 0, prev = -1;
  for (int64_t i = 0; i < n1; ++i) {
    int64_t pos = SA[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      // compare LMS substrings at pos and prev
      for (int64_t d = 0;; ++d) {
        if (T[pos + d] != T[prev + d] || t[pos + d] != t[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
          diff = !(is_lms(pos + d) && is_lms(prev + d));
          break;
        }
      }
    }
    if (diff) {
      ++name;
      prev = pos;
    }
    SA[n1 + pos / 2] = name - 1;
  }
  // compact names
  for (int64_t i = n - 1, j = n - 1; i >= n1; --i)
    if (SA[i] >= 0) SA[j--] = SA[i];

  // ---- recurse or directly order ----
  int64_t* SA1 = SA;
  int64_t* s1 = SA + n - n1;
  if (name < n1) {
    std::vector<int64_t> s1_copy(s1, s1 + n1);
    sais_main<int64_t>(s1_copy.data(), SA1, n1, name);
  } else {
    for (int64_t i = 0; i < n1; ++i) SA1[s1[i]] = i;
  }

  // ---- stage 2: induce final SA from sorted LMS suffixes ----
  // rebuild P (LMS positions in text order) into s1
  for (int64_t i = 1, j = 0; i < n; ++i)
    if (is_lms(i)) s1[j++] = i;
  for (int64_t i = 0; i < n1; ++i) SA1[i] = s1[SA1[i]];
  for (int64_t i = n1; i < n; ++i) SA[i] = -1;
  get_buckets(T, n, K, bkt, /*end=*/true);
  for (int64_t i = n1 - 1; i >= 0; --i) {
    int64_t j = SA[i];
    SA[i] = -1;
    SA[--bkt[T[j]]] = j;
  }
  induce_l(T, SA, n, K, t, bkt);
  induce_s(T, SA, n, K, t, bkt);
}

}  // namespace

extern "C" {

int sais_u8(const uint8_t* T, int64_t* SA, int64_t n, int64_t K) {
  if (n <= 0 || K <= 0) return -1;
  sais_main<uint8_t>(T, SA, n, K);
  return 0;
}

// Derive the $-removed BWT string and primary row from SA of T$ (where T$
// includes the sentinel as its last char and SA has n entries).
// bwt[i] = T[SA_row - 1] for every row except the one with SA value 0
// (recorded as *primary); row indexing matches bwa (lib/bwa/bwt.c:114).
int bwt_from_sa(const uint8_t* T, const int64_t* SA, uint8_t* bwt,
                int64_t* primary, int64_t n) {
  int64_t w = 0;
  *primary = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (SA[i] == 0) {
      *primary = i;
    } else {
      bwt[w++] = T[SA[i] - 1];
    }
  }
  return *primary >= 0 ? 0 : -1;
}

// ---------------------------------------------------------------------
// Batched sampled-SA locate walk (bwt_sa, lib/bwa/bwt.c:86-96): walk each
// row with inverse-Psi until a row divisible by the sampling interval,
// recording the step count and final row.  Used by the index builder's
// SA densification (builder.densify_sa: interval 32 -> 16 re-sampling
// without a suffix re-sort) — ~3e9 scalar rank queries at Gbp scale,
// which a tight two-thread C loop does in minutes where vectorized
// numpy takes hours (gather-bound).
// Rank semantics are exactly fm_host.occ_np / ops.fm_index.occ
// (bwt_occ, lib/bwa/bwt.c:107-129), against the builder's layout:
// bwt_words 16 bases/uint32 (base k at shift (~k&15)<<1) and occ_cp
// checkpoints every 128 bases.
// ---------------------------------------------------------------------

namespace {

inline int64_t occ_rank(const uint32_t* bw, const uint32_t* cp,
                        int64_t primary, int64_t k, int c) {
  // k in [0, seq_len-1]
  int64_t kp = k - (k >= primary ? 1 : 0);
  int64_t blk = kp >> 7;
  uint32_t off = (uint32_t)(kp & 127);
  int64_t cnt = cp[blk * 4 + c];
  const uint32_t* w = bw + blk * 8;
  int f = (int)(off >> 4);
  uint32_t r = off & 15;
  for (int i = 0; i < f; ++i) {
    uint32_t x = w[i];
    uint32_t hi = (c & 2) ? x : ~x;
    uint32_t lo = (c & 1) ? x : ~x;
    cnt += __builtin_popcount((hi >> 1) & lo & 0x55555555u);
  }
  uint32_t x = w[f];
  uint32_t hi = (c & 2) ? x : ~x;
  uint32_t lo = (c & 1) ? x : ~x;
  uint32_t m = (hi >> 1) & lo & 0x55555555u;
  uint32_t partial = ~((1u << ((15u - r) << 1)) - 1u);
  cnt += __builtin_popcount(m & partial);
  return cnt;
}

void sa_walk_range(const uint32_t* bw, const uint32_t* cp,
                   const int64_t* L2, int64_t primary, int64_t intv_mask,
                   int64_t* rows, int64_t* steps, int64_t lo, int64_t hi) {
  for (int64_t i = lo; i < hi; ++i) {
    int64_t k = rows[i];
    int64_t s = 0;
    while (k & intv_mask) {
      if (k == primary) {
        k = 0;
      } else {
        int64_t x = k - (k > primary ? 1 : 0);
        int c = (int)((bw[x >> 4] >> (((~x) & 15) << 1)) & 3);
        k = L2[c] + occ_rank(bw, cp, primary, k, c);
      }
      ++s;
    }
    rows[i] = k;
    steps[i] = s;
  }
}

}  // namespace

// rows: in = row ids to locate, out = final (sampled) row; steps: out.
// sa value = steps[i] + sampled_sa[rows[i] / intv].
int sa_walk_batch(const uint32_t* bwt_words, const uint32_t* occ_cp,
                  const int64_t* L2, int64_t primary, int64_t intv_mask,
                  int64_t* rows, int64_t* steps, int64_t n,
                  int n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1) {
    sa_walk_range(bwt_words, occ_cp, L2, primary, intv_mask, rows, steps,
                  0, n);
    return 0;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    ts.emplace_back(sa_walk_range, bwt_words, occ_cp, L2, primary,
                    intv_mask, rows, steps, lo, hi);
  }
  for (auto& th : ts) th.join();
  return 0;
}

}  // extern "C"
