// Chain stitching in native code: the complete alignChain_edlib walk
// (src/LordFAST.cpp:1765-2258) — left/right end extension with clip
// escalation, inter-seed gap alignment with split/inversion escalation,
// CIGAR/MD construction — plus the alignWin window scoring
// (src/LordFAST.cpp:1063-1090).  Semantics mirror align/chain_align.py
// (the readable Python reference implementation, cross-checked in tests);
// this version exists because the stitch is the host hot loop.
//
// DP primitives (nw_align / shw_best_end / sw_extend) come from
// align_eq.cpp in this library.

#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <vector>

extern "C" {
int64_t nw_align(const uint8_t* q, int64_t ql, const uint8_t* t, int64_t tl,
                 uint8_t* moves, int64_t* moves_len);
int edlib_band_path(const uint8_t* q, int64_t ql, const uint8_t* t,
                    int64_t tl, int64_t k, uint8_t* moves,
                    int64_t* moves_len);
int64_t shw_best_end(const uint8_t* q, int64_t ql, const uint8_t* t,
                     int64_t tl, int64_t* end_out);
int32_t sw_extend(int32_t qlen, const uint8_t* query, int32_t tlen,
                  const uint8_t* target, int32_t m, const int8_t* mat,
                  int32_t o_del, int32_t e_del, int32_t o_ins, int32_t e_ins,
                  int32_t w, int32_t end_bonus, int32_t zdrop, int32_t h0,
                  int32_t* qle, int32_t* tle, int32_t* gtle,
                  int32_t* gscore_out, int32_t* max_off_out);
}

namespace {

constexpr uint8_t OP_MATCH = 0, OP_INSERT = 1, OP_DELETE = 2, OP_MISMATCH = 3;
const char NT[] = "ACGTN";

inline uint8_t comp(uint8_t c) { return c < 4 ? 3 - c : 4; }

struct Ctx {
  const uint8_t* ref;  // slice
  int64_t ref_off;
  int64_t ref_len;
  std::vector<uint8_t> tmp;

  const uint8_t* slice(int64_t gpos, int64_t len) {
    // caller guarantees [gpos, gpos+len) within the slice
    return ref + (gpos - ref_off);
  }
};

void rc_into(const uint8_t* src, int64_t n, std::vector<uint8_t>& dst) {
  dst.resize(n);
  for (int64_t i = 0; i < n; i++) dst[i] = comp(src[n - 1 - i]);
}

// Path for a gap whose edit distance d is already known (device Myers
// kernel): the edlib-exact banded traceback at O((d/64)*tl); the full
// nw_align recompute only as a defensive fallback.
int64_t path_known_dist(const uint8_t* q, int64_t ql, const uint8_t* t,
                        int64_t tl, int64_t d, uint8_t* moves,
                        int64_t* mlen) {
  if (ql == 0) {
    for (int64_t j = 0; j < tl; j++) moves[j] = OP_DELETE;
    *mlen = tl;
    return d;
  }
  if (tl == 0) {
    for (int64_t i = 0; i < ql; i++) moves[i] = OP_INSERT;
    *mlen = ql;
    return d;
  }
  if (edlib_band_path(q, ql, t, tl, d, moves, mlen) == 0) return d;
  return nw_align(q, ql, t, tl, moves, mlen);
}

// edlibCigar_pushback + edlibMD_pushback (src/LordFAST.cpp:1570-1665)
void push_back_aln(std::deque<char>& cig, std::deque<char>& md,
                   const uint8_t* t, const uint8_t* moves, int64_t n) {
  int64_t ti = 0;
  for (int64_t i = 0; i < n; i++) {
    switch (moves[i]) {
      case OP_MATCH:
        cig.push_back('M');
        md.push_back('=');
        ti++;
        break;
      case OP_INSERT:
        cig.push_back('I');
        md.push_back('-');
        break;
      case OP_DELETE:
        cig.push_back('D');
        md.push_back(NT[t[ti++]]);
        break;
      default:
        cig.push_back('M');
        md.push_back(NT[t[ti++]]);
    }
  }
}

// edlibCigar_pushfront + edlibMD_pushfront (src/LordFAST.cpp:1583-1715):
// iteration order pushed to the front (net: reversed block), MD letters
// complemented (target is a revcomp slice).
void push_front_aln(std::deque<char>& cig, std::deque<char>& md,
                    const uint8_t* t, const uint8_t* moves, int64_t n) {
  int64_t ti = 0;
  for (int64_t i = 0; i < n; i++) {
    switch (moves[i]) {
      case OP_MATCH:
        cig.push_front('M');
        md.push_front('=');
        ti++;
        break;
      case OP_INSERT:
        cig.push_front('I');
        md.push_front('-');
        break;
      case OP_DELETE:
        cig.push_front('D');
        md.push_front(NT[comp(t[ti++])]);
        break;
      default:
        cig.push_front('M');
        md.push_front(NT[comp(t[ti++])]);
    }
  }
}

// edlibCigar_toString (src/LordFAST.cpp:1596-1626)
std::string cigar_to_string(const std::deque<char>& cig) {
  std::string out;
  char ch = 0;
  int64_t num = 0, opnum = 0;
  for (char c : cig) {
    if (c != ch) {
      if (ch) {
        out += std::to_string(num);
        out += (opnum == 0 && ch == 'I') ? 'S' : ch;
        opnum++;
      }
      ch = c;
      num = 1;
    } else {
      num++;
    }
  }
  if (num) {
    out += std::to_string(num);
    out += (ch == 'I') ? 'S' : ch;
  }
  return out;
}

// edlibMD_toString (src/LordFAST.cpp:1717-1763)
std::string md_to_string(const std::deque<char>& md,
                         const std::deque<char>& cig) {
  std::string out;
  int64_t num = 0;
  char last = '=';
  auto ci = cig.begin();
  for (auto mi = md.begin(); mi != md.end() && ci != cig.end(); ++mi, ++ci) {
    char m = *mi, c = *ci;
    if (m == '=') {
      num++;
      last = '=';
    } else if (m == '-') {
      last = 'I';
    } else if (c == 'M') {
      out += std::to_string(num);
      num = 0;
      out += m;
      last = 'X';
    } else if (c == 'D') {
      if (last != 'D') {
        out += std::to_string(num);
        num = 0;
        out += '^';
      }
      out += m;
      last = 'D';
    }
  }
  out += std::to_string(num);
  return out;
}

}  // namespace

extern "C" {

typedef struct {
  int32_t flag;
  int64_t pos, pos_end;
  int64_t q_start, q_end;
  int64_t nm_count;
  int64_t aln_score;
  int64_t cigar_off, cigar_len, md_off, md_len;
} StitchRecord;

// Returns the number of SAM records produced (>= 1), or -1 if the record /
// string buffers are too small.  total_score_out receives the alignWin
// window score.  gap_penalty: pass 0.15 for forward windows and the
// configured gapPenalty for reverse (reference quirk,
// src/LordFAST.cpp:1077 vs :1162).
//
// Precomputed gap table (device batched Myers results, ops/gap_dp.py):
// slot 0 = left end extension, slot i+1 = inter-seed gap i, slot n =
// right end extension.  pre_has[slot] != 0 means (pre_dist, pre_end,
// moves at pre_moves + pre_off[slot], length pre_len[slot]) replace the
// local shw_best_end / nw_align calls for the PLAIN path of that site;
// escalation re-alignments (clip / split / inversion) always run
// locally.  Pass pre_has = NULL to compute everything locally.
int32_t stitch_chain(
    const int64_t* chain_q, const int64_t* chain_t, const int64_t* chain_l,
    int32_t n, const uint8_t* query, int64_t read_len, int32_t is_rev,
    const uint8_t* ref_slice, int64_t ref_off, int64_t ref_slice_len,
    int64_t chr_beg, int64_t chr_end,
    int32_t clip_len, double clip_sim, int32_t split_len, double split_sim,
    double reverse_sim, int32_t slack, const int8_t* mat_clip,
    int32_t clip_gapo, int32_t clip_gape, int32_t clip_band,
    int32_t clip_zdrop, int32_t split_odel, int32_t split_edel,
    int32_t split_oins, int32_t split_eins, int32_t split_band,
    int32_t split_zdrop, double gap_penalty, StitchRecord* recs,
    int32_t max_recs, char* strbuf, int64_t strbuf_cap,
    int64_t* total_score_out,
    const uint8_t* pre_has, const int64_t* pre_dist, const int64_t* pre_end,
    const uint8_t* pre_moves, const int64_t* pre_off,
    const int64_t* pre_len,
    // escalation precompute (engine _escalation_pass): 6 sub-slots per
    // gap slot — [0]=ksw fwd (a=qle,b=tle), [1]=ksw rc, [2]=NW part1 /
    // clip-trim (a=dist,b=mlen,+moves), [3]=NW inversion fwd (a=dist),
    // [4]=NW inversion rc (+moves), [5]=NW part2 (+moves).  Missing
    // sub-slots are computed locally (precomputed values are exact, so
    // partial coverage is safe).  esc_has = NULL disables.
    const uint8_t* esc_has, const int64_t* esc_a, const int64_t* esc_b,
    const uint8_t* esc_moves, const int64_t* esc_off) {
  Ctx ctx{ref_slice, ref_off, ref_slice_len, {}};
  auto eidx = [&](int32_t slot, int32_t sub) { return slot * 6 + sub; };
  auto esc_ok = [&](int32_t slot, int32_t sub) -> bool {
    return esc_has && esc_has[eidx(slot, sub)];
  };
  std::deque<char> cig, md;
  int64_t edit_score = 0;
  int32_t nrec = 0;
  int64_t str_used = 0;

  StitchRecord rec;
  std::memset(&rec, 0, sizeof(rec));
  rec.flag = is_rev ? 16 : 0;
  rec.pos = chain_t[0];
  rec.q_start = chain_q[0];

  std::vector<uint8_t> q_rc, t_rc, moves, q_tmp, t_tmp;
  // nw_align writes at most ql + tl moves; gaps can span the whole window
  // (~3 * read_len of target), so size generously once
  moves.resize(8 * (read_len + 1024));

  auto emit = [&](StitchRecord& r) -> bool {
    if (nrec >= max_recs) return false;
    std::string cs = cigar_to_string(cig);
    std::string ms = md_to_string(md, cig);
    if (str_used + (int64_t)cs.size() + (int64_t)ms.size() > strbuf_cap)
      return false;
    r.cigar_off = str_used;
    r.cigar_len = cs.size();
    std::memcpy(strbuf + str_used, cs.data(), cs.size());
    str_used += cs.size();
    r.md_off = str_used;
    r.md_len = ms.size();
    std::memcpy(strbuf + str_used, ms.data(), ms.size());
    str_used += ms.size();
    r.nm_count = edit_score;
    recs[nrec++] = r;
    return true;
  };

  // ---- left end (src/LordFAST.cpp:1820-1899) ----
  {
    int64_t r_len = chain_q[0];
    int64_t t_len = r_len + slack;
    if (r_len > 0) {
      if (chain_t[0] - t_len >= chr_beg) {
        rc_into(query, r_len, q_rc);
        rc_into(ctx.slice(chain_t[0] - t_len, t_len), t_len, t_rc);
        int64_t end, mlen, d;
        const bool pre0 = pre_has && pre_has[0];
        if (pre0) {
          d = pre_dist[0];
          end = pre_end[0];
        } else {
          d = shw_best_end(q_rc.data(), r_len, t_rc.data(), t_len, &end);
        }
        float sim = 1.0f - (float)d / (float)r_len;
        bool done = false;
        if (r_len > clip_len && sim < clip_sim) {
          int32_t qle, tle, g1, g2, g3;
          if (esc_ok(0, 0)) {
            qle = (int32_t)esc_a[eidx(0, 0)];
            tle = (int32_t)esc_b[eidx(0, 0)];
          } else {
            sw_extend((int32_t)r_len, q_rc.data(), (int32_t)t_len,
                      t_rc.data(), 5, mat_clip, clip_gapo, clip_gape,
                      clip_gapo, clip_gape, clip_band, 0, clip_zdrop,
                      (int32_t)r_len, &qle, &tle, &g1, &g2, &g3);
          }
          if (qle > 0 && qle < r_len) {
            int64_t d2;
            if (esc_ok(0, 2)) {
              d2 = esc_a[eidx(0, 2)];
              mlen = esc_b[eidx(0, 2)];
              std::memcpy(moves.data(), esc_moves + esc_off[eidx(0, 2)],
                          mlen);
            } else {
              d2 = nw_align(q_rc.data(), qle, t_rc.data(), tle,
                            moves.data(), &mlen);
            }
            push_front_aln(cig, md, t_rc.data(), moves.data(), mlen);
            edit_score -= d2;
            rec.pos = chain_t[0] - (tle - 1) - 1;
            rec.q_start = chain_q[0] - qle;
            for (int64_t i = 0; i < r_len - qle; i++) {
              cig.push_front('I');
              md.push_front('-');
            }
            done = true;
          }
        }
        if (!done) {
          edit_score -= d;
          // path: NW over t_rc[0..end] (empty when end = -1)
          if (pre0 && pre_len[0] >= 0) {
            mlen = pre_len[0];
            std::memcpy(moves.data(), pre_moves + pre_off[0], mlen);
          } else if (end >= 0) {
            if (pre0)  // dist/end provided, path computed banded-exact
              path_known_dist(q_rc.data(), r_len, t_rc.data(), end + 1, d,
                              moves.data(), &mlen);
            else
              nw_align(q_rc.data(), r_len, t_rc.data(), end + 1,
                       moves.data(), &mlen);
          } else {
            mlen = r_len;
            std::fill(moves.begin(), moves.begin() + r_len, OP_INSERT);
          }
          push_front_aln(cig, md, t_rc.data(), moves.data(), mlen);
          rec.pos = chain_t[0] - end - 1;
          rec.q_start = 0;
        }
      } else {
        for (int64_t i = 0; i < r_len; i++) {
          cig.push_front('I');
          md.push_front('-');
        }
      }
    }
  }

  // ---- inter-seed gaps (src/LordFAST.cpp:1901-2137) ----
  int32_t num_anchors = 1;
  for (int32_t i = 0; i < n - 1; i++) {
    for (int64_t k = 0; k < chain_l[i]; k++) {
      cig.push_back('M');
      md.push_back('=');
    }
    int64_t r_s = chain_q[i] + chain_l[i];
    int64_t t_s = chain_t[i] + chain_l[i];
    int64_t r_e = chain_q[i + 1];
    int64_t t_e = chain_t[i + 1];
    int64_t r_len = r_e - r_s;
    int64_t t_len = t_e - t_s;

    if (r_len > 0 && t_len > 0) {
      const uint8_t* t_seq = ctx.slice(t_s, t_len);
      const uint8_t* q_seq = query + r_s;
      int64_t mlen, d;
      if (pre_has && pre_has[i + 1]) {
        d = pre_dist[i + 1];
        if (pre_len[i + 1] >= 0) {
          mlen = pre_len[i + 1];
          std::memcpy(moves.data(), pre_moves + pre_off[i + 1], mlen);
        } else {  // dist only: banded-exact local path
          path_known_dist(q_seq, r_len, t_seq, t_len, d, moves.data(),
                          &mlen);
        }
      } else {
        d = nw_align(q_seq, r_len, t_seq, t_len, moves.data(), &mlen);
      }
      float sim = 1.0f - (float)d / (float)r_len;
      bool handled = false;
      if ((r_len > t_len ? r_len - t_len : t_len - r_len) >= split_len &&
          sim < split_sim) {
        int32_t qle1, tle1, qle2, tle2, g1, g2, g3;
        const int32_t slot = i + 1;
        if (esc_ok(slot, 0)) {
          qle1 = (int32_t)esc_a[eidx(slot, 0)];
          tle1 = (int32_t)esc_b[eidx(slot, 0)];
        } else {
          sw_extend((int32_t)r_len, q_seq, (int32_t)t_len, t_seq, 5,
                    mat_clip, split_odel, split_edel, split_oins,
                    split_eins, split_band, 0, split_zdrop, (int32_t)r_len,
                    &qle1, &tle1, &g1, &g2, &g3);
        }
        rc_into(q_seq, r_len, q_rc);
        rc_into(t_seq, t_len, t_rc);
        if (esc_ok(slot, 1)) {
          qle2 = (int32_t)esc_a[eidx(slot, 1)];
          tle2 = (int32_t)esc_b[eidx(slot, 1)];
        } else {
          sw_extend((int32_t)r_len, q_rc.data(), (int32_t)t_len,
                    t_rc.data(), 5, mat_clip, split_odel, split_edel,
                    split_oins, split_eins, split_band, 0, split_zdrop,
                    (int32_t)r_len, &qle2, &tle2, &g1, &g2, &g3);
        }
        int64_t r_s_new = r_s + qle1, t_s_new = t_s + tle1;
        int64_t r_e_new = r_e - qle2, t_e_new = t_e - tle2;

        if (r_s_new < r_e_new || t_s_new < t_e_new) {
          // first part (:1998-2031)
          if (r_s_new > r_s || t_s_new > t_s) {
            int64_t d1;
            if (esc_ok(slot, 2)) {
              d1 = esc_a[eidx(slot, 2)];
              mlen = esc_b[eidx(slot, 2)];
              std::memcpy(moves.data(), esc_moves + esc_off[eidx(slot, 2)],
                          mlen);
            } else {
              d1 = nw_align(q_seq, r_s_new - r_s, t_seq, t_s_new - t_s,
                            moves.data(), &mlen);
            }
            push_back_aln(cig, md, t_seq, moves.data(), mlen);
            edit_score -= d1;
          }
          for (int64_t k = 0; k < read_len - r_s_new; k++) {
            cig.push_back('I');
            md.push_back('-');
          }
          rec.pos_end = t_s_new;
          rec.q_end = r_s_new;
          if (num_anchors > 1) {
            if (!emit(rec)) return -1;
          }
          cig.clear();
          md.clear();
          edit_score = 0;

          // middle inversion check (:2034-2077)
          if (r_s_new < r_e_new && t_s_new < t_e_new) {
            int64_t mid_len_r = r_e_new - r_s_new;
            int64_t mid_len_t = t_e_new - t_s_new;
            const uint8_t* t_mid = ctx.slice(t_s_new, mid_len_t);
            const uint8_t* q_mid = query + r_s_new;
            int64_t d_f;
            if (esc_ok(slot, 3)) {
              d_f = esc_a[eidx(slot, 3)];
            } else {
              d_f = nw_align(q_mid, mid_len_r, t_mid, mid_len_t,
                             moves.data(), &mlen);
            }
            int64_t d_r;
            if (esc_ok(slot, 4)) {
              d_r = esc_a[eidx(slot, 4)];
              mlen = esc_b[eidx(slot, 4)];
              std::memcpy(moves.data(), esc_moves + esc_off[eidx(slot, 4)],
                          mlen);
            } else {
              rc_into(q_mid, mid_len_r, q_tmp);
              d_r = nw_align(q_tmp.data(), mid_len_r, t_mid, mid_len_t,
                             moves.data(), &mlen);
            }
            double sim_f = 1.0 - (double)d_f / (double)mid_len_r;
            double sim_r = 1.0 - (double)d_r / (double)mid_len_r;
            if (sim_r > sim_f && sim_r > reverse_sim) {
              StitchRecord inv;
              std::memset(&inv, 0, sizeof(inv));
              inv.flag = is_rev ? 0 : 16;  // flipped strand
              inv.pos = t_s_new;
              inv.q_start = r_s_new;
              inv.pos_end = t_e_new;
              inv.q_end = r_e_new;
              for (int64_t k = 0; k < r_s_new; k++) {
                cig.push_back('I');
                md.push_back('-');
              }
              push_back_aln(cig, md, t_mid, moves.data(), mlen);
              edit_score -= d_r;
              for (int64_t k = 0; k < read_len - r_e_new; k++) {
                cig.push_back('I');
                md.push_front('-');  // reference quirk (:2056-2057)
              }
              if (!emit(inv)) return -1;
              cig.clear();
              md.clear();
              edit_score = 0;
            }
          }

          // second part (:2080-2093)
          if (r_e_new < r_e || t_e_new < t_e) {
            rc_into(q_seq, r_len, q_rc);
            rc_into(t_seq, t_len, t_rc);
            int64_t d2;
            if (esc_ok(slot, 5)) {
              d2 = esc_a[eidx(slot, 5)];
              mlen = esc_b[eidx(slot, 5)];
              std::memcpy(moves.data(), esc_moves + esc_off[eidx(slot, 5)],
                          mlen);
            } else {
              d2 = nw_align(q_rc.data(), r_e - r_e_new, t_rc.data(),
                            t_e - t_e_new, moves.data(), &mlen);
            }
            push_front_aln(cig, md, t_rc.data(), moves.data(), mlen);
            edit_score -= d2;
          }
          for (int64_t k = 0; k < r_e_new; k++) {
            cig.push_front('I');
            md.push_front('-');
          }
          rec.flag = is_rev ? 16 : 0;
          rec.pos = t_e_new;
          rec.q_start = r_e_new;
          num_anchors = 0;
          handled = true;
        }
      }
      if (!handled) {
        // moves still holds the plain NW path (the crossed-split branch
        // never overwrites it), matching the reference's reuse of
        // edResult (src/LordFAST.cpp:2099-2115)
        edit_score -= d;
        push_back_aln(cig, md, t_seq, moves.data(), mlen);
      }
    } else if (r_len > 0) {
      for (int64_t k = 0; k < r_len; k++) {
        cig.push_back('I');
        md.push_back('-');
      }
      edit_score -= r_len;
    } else {
      const uint8_t* t_seq = ctx.slice(t_s, t_len);
      for (int64_t k = 0; k < t_len; k++) {
        cig.push_back('D');
        md.push_back(NT[t_seq[k]]);
      }
      edit_score -= t_len;
    }
    num_anchors++;
  }

  // ---- last seed + right end (src/LordFAST.cpp:2149-2230) ----
  {
    int32_t last = n - 1;
    for (int64_t k = 0; k < chain_l[last]; k++) {
      cig.push_back('M');
      md.push_back('=');
    }
    rec.pos_end = chain_t[last] + chain_l[last] - 1;
    rec.q_end = chain_q[last] + chain_l[last] - 1;

    int64_t r_s = chain_q[last] + chain_l[last];
    int64_t r_len = read_len - r_s;
    int64_t t_len = r_len + slack;
    if (r_len > 0) {
      if (chain_t[last] + chain_l[last] + t_len - 1 <= chr_end) {
        int64_t t_start = chain_t[last] + chain_l[last];
        const uint8_t* t_seq = ctx.slice(t_start, t_len);
        const uint8_t* q_seq = query + r_s;
        int64_t end, mlen, d;
        const bool pre_n = pre_has && pre_has[n];
        if (pre_n) {
          d = pre_dist[n];
          end = pre_end[n];
        } else {
          d = shw_best_end(q_seq, r_len, t_seq, t_len, &end);
        }
        float sim = 1.0f - (float)d / (float)r_len;
        bool done = false;
        if (r_len > clip_len && sim < clip_sim) {
          int32_t qle, tle, g1, g2, g3;
          if (esc_ok(n, 0)) {
            qle = (int32_t)esc_a[eidx(n, 0)];
            tle = (int32_t)esc_b[eidx(n, 0)];
          } else {
            sw_extend((int32_t)r_len, q_seq, (int32_t)t_len, t_seq, 5,
                      mat_clip, clip_gapo, clip_gape, clip_gapo, clip_gape,
                      clip_band, 0, clip_zdrop, (int32_t)r_len, &qle, &tle,
                      &g1, &g2, &g3);
          }
          if (qle > 0 && qle < r_len) {
            int64_t d2;
            if (esc_ok(n, 2)) {
              d2 = esc_a[eidx(n, 2)];
              mlen = esc_b[eidx(n, 2)];
              std::memcpy(moves.data(), esc_moves + esc_off[eidx(n, 2)],
                          mlen);
            } else {
              d2 = nw_align(q_seq, qle, t_seq, tle, moves.data(), &mlen);
            }
            push_back_aln(cig, md, t_seq, moves.data(), mlen);
            edit_score -= d2;
            rec.pos_end = t_start + (tle - 1);
            rec.q_end = r_s + qle;
            for (int64_t k = 0; k < r_len - qle; k++) {
              cig.push_back('I');
              md.push_back('-');
            }
            done = true;
          }
        }
        if (!done) {
          edit_score -= d;
          if (pre_n && pre_len[n] >= 0) {
            mlen = pre_len[n];
            std::memcpy(moves.data(), pre_moves + pre_off[n], mlen);
          } else if (end >= 0) {
            if (pre_n)
              path_known_dist(q_seq, r_len, t_seq, end + 1, d,
                              moves.data(), &mlen);
            else
              nw_align(q_seq, r_len, t_seq, end + 1, moves.data(), &mlen);
          } else {
            mlen = r_len;
            std::fill(moves.begin(), moves.begin() + r_len, OP_INSERT);
          }
          push_back_aln(cig, md, t_seq, moves.data(), mlen);
          rec.pos_end = t_start + end;
          rec.q_end = read_len;
        }
      } else {
        for (int64_t k = 0; k < r_len; k++) {
          cig.push_back('I');
          md.push_back('-');
        }
      }
    }
  }

  if (!emit(rec)) return -1;

  // ---- window scoring (src/LordFAST.cpp:1063-1090) ----
  int64_t ts = 0;
  for (int32_t i = 0; i < nrec; i++) {
    recs[i].aln_score = recs[i].nm_count + (recs[i].q_end - recs[i].q_start);
    ts += recs[i].nm_count;
  }
  for (int32_t i = 0; i + 1 < nrec; i++) {
    int64_t dpos = recs[i + 1].pos - recs[i].pos_end;
    int64_t dq = recs[i + 1].q_start - recs[i].q_end;
    int64_t diff = (dpos < 0 ? -dpos : dpos) + (dq < 0 ? -dq : dq);
    ts = (int64_t)((double)ts - gap_penalty * (double)diff);
  }
  ts -= recs[0].q_start;
  ts -= read_len - recs[nrec - 1].q_end;
  *total_score_out = ts;
  return nrec;
}

}  // extern "C"
