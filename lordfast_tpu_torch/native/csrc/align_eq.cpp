// Host alignment primitives, behaviorally equivalent to the libraries the
// reference links against:
//
//  - nw_align / shw_best_end: global / prefix edit-distance alignment with
//    path, equivalent to edlibAlign modes NW / SHW with TASK_PATH
//    (lib/edlib/edlib.cpp:101-221).  The traceback reproduces edlib's move
//    priority (UP i.e. consume-query, then LEFT i.e. consume-target, then
//    diagonal; edlib.cpp:948-1064) so CIGAR/MD strings match byte-for-byte
//    in the unbanded regime.  Implementation here is a plain rolling-row DP
//    with 2-bit per-cell move decisions recorded at fill time (the decision
//    only depends on the three neighbor scores, so it can be precomputed).
//
//  - sw_extend: affine-gap, banded, z-drop extension alignment equivalent
//    to ksw_extend2 (lib/bwa/ksw.c:380-479): finds the best-scoring
//    extension of a seed (initial score h0) and reports query/target end
//    positions.  Used for the clip / split escalation paths
//    (src/LordFAST.cpp:1848, 1971).
//
// Provenance: nw_align/shw_best_end are written from the published Myers /
// Needleman-Wunsch algorithms, independent of edlib's bit-parallel
// implementation.  sw_extend, by contrast, deliberately follows the scalar
// loop structure of ksw_extend2 (lib/bwa/ksw.c:380-479) statement by
// statement: its job is to be a bit-exact host oracle for that function
// (including the (int)((double)...+1.) band truncation and the z-drop /
// interval-shrink timing), and any faithful implementation converges to
// that ~100-line loop.  The TPU compute path (ops/affine_pl.py) is an
// original band-relative / prefix-max design that shares none of this
// structure.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

// move codes, same numbering as edlib's EDLIB_EDOP_*
constexpr uint8_t OP_MATCH = 0;
constexpr uint8_t OP_INSERT = 1;  // consumes query (vertical move)
constexpr uint8_t OP_DELETE = 2;  // consumes target (horizontal move)
constexpr uint8_t OP_MISMATCH = 3;

// 2-bit fill-time decisions
constexpr uint8_t DEC_DIAG = 0;
constexpr uint8_t DEC_UP = 1;
constexpr uint8_t DEC_LEFT = 2;

}  // namespace

extern "C" {

// Banded edlib-exact primitives (edlib_path.cpp in this library)
int edlib_band_path(const uint8_t* q, int64_t ql, const uint8_t* t,
                    int64_t tl, int64_t k, uint8_t* moves,
                    int64_t* moves_len);
int64_t edlib_nw_dist(const uint8_t* q, int64_t ql, const uint8_t* t,
                      int64_t tl);

int64_t nw_align_full(const uint8_t* q, int64_t ql, const uint8_t* t,
                      int64_t tl, uint8_t* moves, int64_t* moves_len);

// Global (NW) edit-distance alignment of q (length ql) vs t (length tl).
// moves must have capacity ql + tl.  Returns edit distance (>= 0) or -1 on
// allocation failure.  Move semantics: OP_INSERT consumes a query char,
// OP_DELETE a target char (edlib convention; see edlibAlignmentToCigar,
// edlib.cpp:224-273).
//
// Distance comes from the banded dynamic-k fill and the PATH from the
// bit-exact edlib banded traceback (edlib_path.cpp) — so band-edge
// equal-score tie moves match the reference byte-for-byte, at
// O((d/64)*tl) instead of O(ql*tl).  nw_align_full (the original
// unbanded DP, whose ties follow the same UP/LEFT/DIAG priority but
// without edlib's band-availability masking) remains as the fallback
// and as the independent cross-check oracle in tests.
int64_t nw_align(const uint8_t* q, int64_t ql, const uint8_t* t, int64_t tl,
                 uint8_t* moves, int64_t* moves_len) {
  if (ql > 0 && tl > 0) {
    int64_t d = edlib_nw_dist(q, ql, t, tl);
    if (d >= 0 && edlib_band_path(q, ql, t, tl, d, moves, moves_len) == 0)
      return d;
  }
  return nw_align_full(q, ql, t, tl, moves, moves_len);
}

int64_t nw_align_full(const uint8_t* q, int64_t ql, const uint8_t* t,
                      int64_t tl, uint8_t* moves, int64_t* moves_len) {
  if (ql == 0) {
    for (int64_t j = 0; j < tl; j++) moves[j] = OP_DELETE;
    *moves_len = tl;
    return tl;
  }
  if (tl == 0) {
    for (int64_t i = 0; i < ql; i++) moves[i] = OP_INSERT;
    *moves_len = ql;
    return ql;
  }

  // decisions: 2 bits per cell, row-major (ql rows, tl cols)
  const int64_t ncells = ql * tl;
  std::vector<uint8_t> dec((ncells + 3) / 4, 0);
  std::vector<int32_t> prev_row(tl + 1), cur_row(tl + 1);

  for (int64_t j = 0; j <= tl; j++) prev_row[j] = (int32_t)j;
  for (int64_t i = 1; i <= ql; i++) {
    cur_row[0] = (int32_t)i;
    const uint8_t qc = q[i - 1];
    const int64_t base = (i - 1) * tl;
    for (int64_t j = 1; j <= tl; j++) {
      const int32_t diag = prev_row[j - 1] + (qc != t[j - 1]);
      const int32_t up = prev_row[j] + 1;
      const int32_t left = cur_row[j - 1] + 1;
      int32_t best = diag;
      if (up < best) best = up;
      if (left < best) best = left;
      // edlib traceback priority: UP, then LEFT, then DIAG
      // (obtainAlignmentTraceback, edlib.cpp:950,984,1015)
      uint8_t d;
      if (up == best) d = DEC_UP;
      else if (left == best) d = DEC_LEFT;
      else d = DEC_DIAG;
      const int64_t cell = base + (j - 1);
      dec[cell >> 2] |= d << ((cell & 3) << 1);
      cur_row[j] = best;
    }
    std::swap(prev_row, cur_row);
  }
  const int64_t dist = prev_row[tl];

  // traceback
  int64_t r = ql - 1, c = tl - 1, n = 0;
  while (r >= 0 && c >= 0) {
    const int64_t cell = r * tl + c;
    const uint8_t d = (dec[cell >> 2] >> ((cell & 3) << 1)) & 3;
    if (d == DEC_UP) {
      moves[n++] = OP_INSERT;
      r--;
    } else if (d == DEC_LEFT) {
      moves[n++] = OP_DELETE;
      c--;
    } else {
      moves[n++] = (q[r] == t[c]) ? OP_MATCH : OP_MISMATCH;
      r--;
      c--;
    }
  }
  while (r >= 0) { moves[n++] = OP_INSERT; r--; }
  while (c >= 0) { moves[n++] = OP_DELETE; c--; }
  std::reverse(moves, moves + n);
  *moves_len = n;
  return dist;
}

// Prefix (SHW) alignment: query must be fully consumed, trailing target is
// free.  Returns the best edit distance; *end_out = 0-based target index
// of the end of the best alignment, the FIRST position among score ties
// (edlib records positions in ascending order and lordFAST reads
// endLocations[0]; edlib.cpp:583-618, src/LordFAST.cpp:1860).
//
// edlib artifact replicated exactly: edlib pads the query to a multiple of
// WORD_SIZE=64 with W wildcard rows, and its position bookkeeping
// (position = column - W in the main loop, plus the last-W-columns pass,
// edlib.cpp:595,605-618) lets it report NEGATIVE end positions when that
// beats every real column.  Only position -1 can ever win (more negative
// positions cost strictly more), with score C = min_j (d_j + j) over
// j in [0, min(W, tl)] where d_j = editdist(q, t[:j]) — i.e. "align only a
// prefix of the query's left part and clip", realized downstream as an
// all-insertions path over an empty target slice (edlib.cpp:1097,
// src/LordFAST.cpp:1860-1898).  This requires W >= 1 (ql % 64 != 0).
int64_t shw_best_end(const uint8_t* q, int64_t ql, const uint8_t* t,
                     int64_t tl, int64_t* end_out) {
  if (ql == 0) {
    *end_out = -1;
    return 0;
  }
  const int64_t W = (64 - (ql % 64)) % 64;
  std::vector<int32_t> col(ql + 1);
  for (int64_t i = 0; i <= ql; i++) col[i] = (int32_t)i;
  int64_t best_end = -2;  // -2 = unset
  int32_t best = INT32_MAX;
  // j = 0 term of the virtual position -1 (d_0 + 0 = ql)
  int32_t neg1 = (W >= 1) ? (int32_t)ql : INT32_MAX;
  for (int64_t j = 1; j <= tl; j++) {
    int32_t prev_diag = col[0];
    // gap BEFORE the query is penalized in SHW (startHout = 1,
    // edlib.cpp:512): boundary row value is the column index.
    col[0] = (int32_t)j;
    const uint8_t tc = t[j - 1];
    for (int64_t i = 1; i <= ql; i++) {
      const int32_t diag = prev_diag + (q[i - 1] != tc);
      const int32_t up = col[i - 1] + 1;  // consume query (vertical)
      const int32_t left = col[i] + 1;    // consume target
      prev_diag = col[i];
      int32_t best_c = diag;
      if (up < best_c) best_c = up;
      if (left < best_c) best_c = left;
      col[i] = best_c;
    }
    if (W >= 1 && j <= W && col[ql] + (int32_t)j < neg1)
      neg1 = col[ql] + (int32_t)j;
    if (col[ql] < best) {
      best = col[ql];
      best_end = j - 1;
    }
  }
  if (W >= 1 && neg1 <= best) {  // position -1 precedes all real columns
    *end_out = -1;
    return neg1;
  }
  if (best_end == -2) {  // empty target: whole query deleted
    *end_out = -1;
    return ql;
  }
  *end_out = best_end;
  return best;
}

// Affine-gap extension, semantics of ksw_extend2 (lib/bwa/ksw.c:380-479):
// extends from a seed with initial score h0; banded (width w, adapted to
// the max possible insertion/deletion count), z-drop termination, and
// row-wise active-interval shrinking.  mat is a m x m score matrix.
// Outputs: *qle/*tle = query/target lengths of the best-scoring extension
// (0 if no cell beats h0 going... matches reference: max starts at h0 with
// max_i = max_j = -1, so qle = tle = 0 when nothing extends);
// *gtle/*gscore: best target length / score for reaching the query end.
// Returns the best score.
int32_t sw_extend(int32_t qlen, const uint8_t* query, int32_t tlen,
                  const uint8_t* target, int32_t m, const int8_t* mat,
                  int32_t o_del, int32_t e_del, int32_t o_ins, int32_t e_ins,
                  int32_t w, int32_t end_bonus, int32_t zdrop, int32_t h0,
                  int32_t* qle, int32_t* tle, int32_t* gtle,
                  int32_t* gscore_out, int32_t* max_off_out) {
  const int32_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  std::vector<int32_t> H(qlen + 1), E(qlen + 1, 0);
  std::vector<int8_t> qprof((size_t)qlen * m);
  for (int32_t k = 0; k < m; ++k)
    for (int32_t j = 0; j < qlen; ++j)
      qprof[(size_t)k * qlen + j] = mat[k * m + query[j]];

  // first row: H(0,j) decays by insertion cost from h0
  H[0] = h0;
  H[1] = h0 > oe_ins ? h0 - oe_ins : 0;
  int32_t j;
  for (j = 2; j <= qlen && H[j - 1] > e_ins; ++j) H[j] = H[j - 1] - e_ins;
  for (; j <= qlen; ++j) H[j] = 0;

  // clamp band width by maximum possible #ins / #del (ksw.c:399-407)
  int32_t max_sc = 0;
  for (int32_t i = 0; i < m * m; ++i) max_sc = std::max(max_sc, (int32_t)mat[i]);
  int32_t max_ins =
      (int32_t)(((double)qlen * max_sc + end_bonus - o_ins) / e_ins + 1.);
  max_ins = std::max(max_ins, 1);
  w = std::min(w, max_ins);
  int32_t max_del =
      (int32_t)(((double)qlen * max_sc + end_bonus - o_del) / e_del + 1.);
  max_del = std::max(max_del, 1);
  w = std::min(w, max_del);

  int32_t best = h0, best_i = -1, best_j = -1, best_ie = -1, gscore = -1;
  int32_t max_off = 0;
  int32_t beg = 0, end = qlen;
  for (int32_t i = 0; i < tlen; ++i) {
    int32_t f = 0, h1, row_max = 0, row_max_j = -1;
    const int8_t* qp = &qprof[(size_t)target[i] * qlen];
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
      // cell order identical to the reference recurrence (ksw.c:424-448):
      // M separated from H so a gap cannot immediately follow a gap
      int32_t diagH = H[j], e = E[j];
      H[j] = h1;  // becomes H(i, j-1) for the next row
      int32_t M = diagH ? diagH + qp[j] : 0;
      int32_t h = M > e ? M : e;
      h = h > f ? h : f;
      h1 = h;
      // ksw.c:437 `mj = m > h? mj : j`: on ties row_max_j moves to the
      // LAST j achieving the running max (incl. h == row_max == 0, where
      // the reference also records j; unused there since m==0 breaks)
      if (row_max <= h) {
        row_max = h;
        row_max_j = j;
      }
      int32_t tmp = M - oe_del;
      tmp = tmp > 0 ? tmp : 0;
      e -= e_del;
      e = e > tmp ? e : tmp;
      E[j] = e;
      tmp = M - oe_ins;
      tmp = tmp > 0 ? tmp : 0;
      f -= e_ins;
      f = f > tmp ? f : tmp;
    }
    H[end] = h1;
    E[end] = 0;
    if (j == qlen) {  // reached the query end: track global extension
      // ties take the LATEST row (ksw.c:451-452 updates unless gscore > h1)
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
      max_off = std::max(max_off, std::abs(row_max_j - i));
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
    for (j = beg; j < end && H[j] == 0 && E[j] == 0; ++j) {
    }
    beg = j;
    for (j = end; j >= beg && H[j] == 0 && E[j] == 0; --j) {
    }
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  if (qle) *qle = best_j + 1;
  if (tle) *tle = best_i + 1;
  if (gtle) *gtle = best_ie + 1;
  if (gscore_out) *gscore_out = gscore;
  if (max_off_out) *max_off_out = max_off;
  return best;
}

}  // extern "C"

// Expand the Myers Pallas kernel's per-column (run << 2 | move) codes
// (ops/gap_dp_pallas.py GapColsResult) into flat forward move arrays.
// col: (g, T) row-major uint16 (the kernel's (T, G) output transposed and
// sliced to the used gaps); ends/leads per gap.  Writes all gaps' moves
// into `out` back to back, recording per-gap offsets and lengths.
// Returns total bytes written, or -1 if out_cap would overflow.
extern "C" int64_t decode_colcodes(const uint16_t* col, int64_t T,
                                   const int64_t* ends,
                                   const int64_t* leads, int64_t g,
                                   uint8_t* out, int64_t out_cap,
                                   int64_t* offs, int64_t* lens) {
  int64_t pos = 0;
  for (int64_t i = 0; i < g; i++) {
    offs[i] = pos;
    const int64_t e = ends[i], ld = leads[i];
    if (pos + ld > out_cap) return -1;
    std::memset(out + pos, 1, ld);  // OP_INSERT
    pos += ld;
    if (e >= 0) {
      const uint16_t* row = col + i * T;
      for (int64_t c = 0; c <= e; c++) {
        const uint16_t v = row[c];
        const int64_t run = v >> 2;
        if (pos + 1 + run > out_cap) return -1;
        out[pos++] = (uint8_t)(v & 3);
        std::memset(out + pos, 1, run);
        pos += run;
      }
    }
    lens[i] = pos - offs[i];
  }
  return pos;
}
