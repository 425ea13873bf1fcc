// Banded Myers NW alignment PATH, bit-exact with edlib.
//
// Provenance: this file is a deliberate, statement-level port of the
// alignment-path machinery of edlib (Martin Sosic, MIT license), the
// library the reference binary links for all its gap alignments:
//   - calculateBlock / buildPeq / getBlockCellValues / readBlock(Reverse)
//     (lib/edlib/edlib.cpp:281-440)
//   - myersCalcEditDistanceNW, the Ukkonen-banded fill with its exact
//     firstBlock/lastBlock update rules, per-column k reduction and
//     STRONG_REDUCE pass (lib/edlib/edlib.cpp:657-867)
//   - obtainAlignmentTraceback, whose band-edge availability checks
//     (block within [firstBlocks[c-1], lastBlocks[c-1]]) decide
//     equal-score tie moves differently from an unbanded DP
//     (lib/edlib/edlib.cpp:872-1071)
//   - obtainAlignment + obtainAlignmentHirschberg, incl. the 1 MB
//     traceback-memory gate (lib/edlib/edlib.cpp:1090-1345)
//
// Like sw_extend in align_eq.cpp (ksw.c port), its entire job is to be a
// bit-exact oracle for the reference's tie behavior: the engine's device
// kernels compute every gap's edit DISTANCE (ops/gap_dp_pallas.py, an
// original TPU design), and this code reconstructs the PATH exactly as
// edlib would — closing the band-edge tie-placement divergence (the one
// output difference left at Gbp scale) and handling arbitrary gap sizes
// via Hirschberg.  Sequences here are 0..4 codes (alphabet length 5);
// edlib's per-call alphabet transform is an index relabeling with
// identical match semantics.

#include <cstdint>
#include <cstring>
#include <vector>

namespace edpath {

typedef uint64_t Word;
static const int WORD_SIZE = 64;
static const Word WORD_1 = (Word)1;
static const Word HIGH_BIT_MASK = WORD_1 << (WORD_SIZE - 1);
static const int ALPHA = 5;  // codes 0..4 (4 = N, matches itself)

// edlib EDOP codes == this engine's OP codes (see align_eq.cpp)
static const uint8_t EDOP_MATCH = 0, EDOP_INSERT = 1, EDOP_DELETE = 2,
                     EDOP_MISMATCH = 3;

static inline int ceilDiv(const int x, const int y) {
  return x % y ? x / y + 1 : x / y;
}
static inline int minI(const int x, const int y) { return x < y ? x : y; }
static inline int maxI(const int x, const int y) { return x > y ? x : y; }

struct Block {
  Word P;
  Word M;
  int score;  // score of last cell in block
  Block() {}
  Block(Word P_, Word M_, int s) : P(P_), M(M_), score(s) {}
};

// edlib.cpp:335-374
static inline int calculateBlock(Word Pv, Word Mv, Word Eq, const int hin,
                                 Word& PvOut, Word& MvOut) {
  Word hinIsNeg = (Word)(hin >> 2) & WORD_1;
  Word Xv = Eq | Mv;
  Eq |= hinIsNeg;
  Word Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq;
  Word Ph = Mv | ~(Xh | Pv);
  Word Mh = Pv & Xh;
  int hout = 0;
  hout = (int)((Ph & HIGH_BIT_MASK) >> (WORD_SIZE - 1));
  hout -= (int)((Mh & HIGH_BIT_MASK) >> (WORD_SIZE - 1));
  Ph <<= 1;
  Mh <<= 1;
  Mh |= hinIsNeg;
  Ph |= (Word)((hin + 1) >> 1);
  PvOut = Mh | ~(Xv | Ph);
  MvOut = Ph & Xv;
  return hout;
}

// edlib.cpp:393-407
static inline void getBlockCellValues(const Block block,
                                      int scores[WORD_SIZE]) {
  int score = block.score;
  Word mask = HIGH_BIT_MASK;
  for (int i = 0; i < WORD_SIZE - 1; i++) {
    scores[i] = score;
    if (block.P & mask) score--;
    if (block.M & mask) score++;
    mask >>= 1;
  }
  scores[WORD_SIZE - 1] = score;
}

// edlib.cpp:414-424
static inline void readBlock(const Block block, int* const dest) {
  int score = block.score;
  Word mask = HIGH_BIT_MASK;
  for (int i = 0; i < WORD_SIZE - 1; i++) {
    dest[WORD_SIZE - 1 - i] = score;
    if (block.P & mask) score--;
    if (block.M & mask) score++;
    mask >>= 1;
  }
  dest[0] = score;
}

// edlib.cpp:431-441
static inline void readBlockReverse(const Block block, int* const dest) {
  int score = block.score;
  Word mask = HIGH_BIT_MASK;
  for (int i = 0; i < WORD_SIZE - 1; i++) {
    dest[i] = score;
    if (block.P & mask) score--;
    if (block.M & mask) score++;
    mask >>= 1;
  }
  dest[WORD_SIZE - 1] = score;
}

// edlib.cpp:281-303 (alphabet fixed at 5 + wildcard padding column)
static void buildPeq(const uint8_t* query, const int queryLength,
                     std::vector<Word>& Peq) {
  int maxNumBlocks = ceilDiv(queryLength, WORD_SIZE);
  Peq.assign((size_t)(ALPHA + 1) * maxNumBlocks, 0);
  for (int symbol = 0; symbol <= ALPHA; symbol++) {
    for (int b = 0; b < maxNumBlocks; b++) {
      if (symbol < ALPHA) {
        Word w = 0;
        for (int r = (b + 1) * WORD_SIZE - 1; r >= b * WORD_SIZE; r--) {
          w <<= 1;
          if (r >= queryLength || query[r] == symbol) w += 1;
        }
        Peq[(size_t)symbol * maxNumBlocks + b] = w;
      } else {
        Peq[(size_t)symbol * maxNumBlocks + b] = (Word)-1;
      }
    }
  }
}

struct AlignmentData {
  std::vector<Word> Ps, Ms;
  std::vector<int> scores;
  std::vector<int> firstBlocks, lastBlocks;
  AlignmentData(int maxNumBlocks, int targetLength)
      : Ps((size_t)maxNumBlocks * targetLength),
        Ms((size_t)maxNumBlocks * targetLength),
        scores((size_t)maxNumBlocks * targetLength),
        firstBlocks(targetLength),
        lastBlocks(targetLength) {}
};

// edlib.cpp:657-867, findAlignment/targetStopPosition variants included.
// Returns 0; *bestScore_ = -1 when no score <= k exists.
static int myersCalcEditDistanceNW(const Word* Peq, const int W,
                                   const int maxNumBlocks,
                                   const uint8_t* query,
                                   const int queryLength,
                                   const uint8_t* target,
                                   const int targetLength, int k,
                                   int* const bestScore_,
                                   int* const position_,
                                   const bool findAlignment,
                                   AlignmentData** const alignData,
                                   const int targetStopPosition) {
  if (targetStopPosition > -1 && findAlignment) return -1;
  const int STRONG_REDUCE_NUM = 2048;
  if (k < (targetLength > queryLength ? targetLength - queryLength
                                      : queryLength - targetLength)) {
    *bestScore_ = *position_ = -1;
    return 0;
  }
  k = minI(k, maxI(queryLength, targetLength));

  int firstBlock = 0;
  int lastBlock =
      minI(maxNumBlocks,
           ceilDiv(minI(k, (k + queryLength - targetLength) / 2) + 1,
                   WORD_SIZE)) -
      1;
  Block* bl;
  std::vector<Block> blocks(maxNumBlocks);

  bl = blocks.data();
  for (int b = 0; b <= lastBlock; b++) {
    bl->score = (b + 1) * WORD_SIZE;
    bl->P = (Word)-1;
    bl->M = (Word)0;
    bl++;
  }

  if (findAlignment)
    *alignData = new AlignmentData(maxNumBlocks, targetLength);
  else if (targetStopPosition > -1)
    *alignData = new AlignmentData(maxNumBlocks, 1);
  else
    *alignData = NULL;

  const uint8_t* targetChar = target;
  for (int c = 0; c < targetLength; c++) {
    const Word* Peq_c = Peq + (size_t)(*targetChar) * maxNumBlocks;

    int hout = 1;
    bl = blocks.data() + firstBlock;
    for (int b = firstBlock; b <= lastBlock; b++) {
      hout = calculateBlock(bl->P, bl->M, Peq_c[b], hout, bl->P, bl->M);
      bl->score += hout;
      bl++;
    }
    bl--;

    k = minI(k,
             bl->score +
                 maxI(targetLength - c - 1,
                      queryLength - ((1 + lastBlock) * WORD_SIZE - 1) - 1) +
                 (lastBlock == maxNumBlocks - 1 ? W : 0));

    //--- Adjust last block ---//
    if (lastBlock + 1 < maxNumBlocks &&
        !((lastBlock + 1) * WORD_SIZE - 1 >
          k - bl->score + 2 * WORD_SIZE - 2 - targetLength + c +
              queryLength)) {
      lastBlock++;
      bl++;
      bl->P = (Word)-1;
      bl->M = (Word)0;
      int newHout = calculateBlock(bl->P, bl->M, Peq_c[lastBlock], hout,
                                   bl->P, bl->M);
      bl->score = (bl - 1)->score - hout + WORD_SIZE + newHout;
      hout = newHout;
    }

    while (lastBlock >= firstBlock &&
           (bl->score >= k + WORD_SIZE ||
            ((lastBlock + 1) * WORD_SIZE - 1 >
             k - bl->score + 2 * WORD_SIZE - 2 - targetLength + c +
                 queryLength + 1))) {
      lastBlock--;
      bl--;
    }

    //--- Adjust first block ---//
    while (firstBlock <= lastBlock &&
           (blocks[firstBlock].score >= k + WORD_SIZE ||
            ((firstBlock + 1) * WORD_SIZE - 1 <
             blocks[firstBlock].score - k - targetLength + queryLength +
                 c))) {
      firstBlock++;
    }

    if (c % STRONG_REDUCE_NUM == 0) {
      while (lastBlock >= firstBlock) {
        int scores[WORD_SIZE];
        getBlockCellValues(*bl, scores);
        int numCells =
            lastBlock == maxNumBlocks - 1 ? WORD_SIZE - W : WORD_SIZE;
        int r = lastBlock * WORD_SIZE + numCells - 1;
        bool reduce = true;
        for (int i = WORD_SIZE - numCells; i < WORD_SIZE; i++) {
          if (scores[i] <= k &&
              r <= k - scores[i] - targetLength + c + queryLength + 1) {
            reduce = false;
            break;
          }
          r--;
        }
        if (!reduce) break;
        lastBlock--;
        bl--;
      }

      while (firstBlock <= lastBlock) {
        int scores[WORD_SIZE];
        getBlockCellValues(blocks[firstBlock], scores);
        int numCells =
            firstBlock == maxNumBlocks - 1 ? WORD_SIZE - W : WORD_SIZE;
        int r = firstBlock * WORD_SIZE + numCells - 1;
        bool reduce = true;
        for (int i = WORD_SIZE - numCells; i < WORD_SIZE; i++) {
          if (scores[i] <= k &&
              r >= scores[i] - k - targetLength + c + queryLength) {
            reduce = false;
            break;
          }
          r--;
        }
        if (!reduce) break;
        firstBlock++;
      }
    }

    if (lastBlock < firstBlock) {
      *bestScore_ = *position_ = -1;
      return 0;
    }

    if (findAlignment && c < targetLength) {
      bl = blocks.data() + firstBlock;
      for (int b = firstBlock; b <= lastBlock; b++) {
        (*alignData)->Ps[(size_t)maxNumBlocks * c + b] = bl->P;
        (*alignData)->Ms[(size_t)maxNumBlocks * c + b] = bl->M;
        (*alignData)->scores[(size_t)maxNumBlocks * c + b] = bl->score;
        (*alignData)->firstBlocks[c] = firstBlock;
        (*alignData)->lastBlocks[c] = lastBlock;
        bl++;
      }
    }
    if (c == targetStopPosition) {
      for (int b = firstBlock; b <= lastBlock; b++) {
        (*alignData)->Ps[b] = blocks[b].P;
        (*alignData)->Ms[b] = blocks[b].M;
        (*alignData)->scores[b] = blocks[b].score;
        (*alignData)->firstBlocks[0] = firstBlock;
        (*alignData)->lastBlocks[0] = lastBlock;
      }
      *bestScore_ = -1;
      *position_ = targetStopPosition;
      return 0;
    }

    targetChar++;
  }

  if (lastBlock == maxNumBlocks - 1) {
    int scores[WORD_SIZE];
    getBlockCellValues(blocks[lastBlock], scores);
    int bestScore = scores[W];
    if (bestScore <= k) {
      *bestScore_ = bestScore;
      *position_ = targetLength - 1;
      return 0;
    }
  }

  *bestScore_ = *position_ = -1;
  return 0;
}

// edlib.cpp:872-1071.  Appends moves (reversed during walk, flipped at
// the end, exactly like the original).
static int obtainAlignmentTraceback(const int queryLength,
                                    const int targetLength,
                                    const int bestScore,
                                    const AlignmentData* const alignData,
                                    std::vector<uint8_t>& alignment) {
  const int maxNumBlocks = ceilDiv(queryLength, WORD_SIZE);
  const int W = maxNumBlocks * WORD_SIZE - queryLength;

  alignment.clear();
  alignment.reserve(queryLength + targetLength - 1);
  int c = targetLength - 1;
  int b = maxNumBlocks - 1;
  int currScore = bestScore;
  int lScore = -1, uScore = -1, ulScore = -1;
  Word currP = alignData->Ps[(size_t)c * maxNumBlocks + b];
  Word currM = alignData->Ms[(size_t)c * maxNumBlocks + b];
  bool thereIsLeftBlock = c > 0 && b >= alignData->firstBlocks[c - 1] &&
                          b <= alignData->lastBlocks[c - 1];
  Word lP = 0, lM = 0;
  if (thereIsLeftBlock) {
    lP = alignData->Ps[(size_t)(c - 1) * maxNumBlocks + b];
    lM = alignData->Ms[(size_t)(c - 1) * maxNumBlocks + b];
  }
  currP <<= W;
  currM <<= W;
  int blockPos = WORD_SIZE - W - 1;

  while (true) {
    if (c == 0) {
      thereIsLeftBlock = true;
      lScore = b * WORD_SIZE + blockPos + 1;
      ulScore = lScore - 1;
    }

    if (lScore == -1 && thereIsLeftBlock) {
      lScore = alignData->scores[(size_t)(c - 1) * maxNumBlocks + b];
      for (int i = 0; i < WORD_SIZE - blockPos - 1; i++) {
        if (lP & HIGH_BIT_MASK) lScore--;
        if (lM & HIGH_BIT_MASK) lScore++;
        lP <<= 1;
        lM <<= 1;
      }
    }
    if (ulScore == -1) {
      if (lScore != -1) {
        ulScore = lScore;
        if (lP & HIGH_BIT_MASK) ulScore--;
        if (lM & HIGH_BIT_MASK) ulScore++;
      } else if (c > 0 && b - 1 >= alignData->firstBlocks[c - 1] &&
                 b - 1 <= alignData->lastBlocks[c - 1]) {
        ulScore = alignData->scores[(size_t)(c - 1) * maxNumBlocks + b - 1];
      }
    }
    if (uScore == -1) {
      uScore = currScore;
      if (currP & HIGH_BIT_MASK) uScore--;
      if (currM & HIGH_BIT_MASK) uScore++;
      currP <<= 1;
      currM <<= 1;
    }

    // Move up
    if (uScore != -1 && uScore + 1 == currScore) {
      currScore = uScore;
      lScore = ulScore;
      uScore = ulScore = -1;
      if (blockPos == 0) {
        if (b == 0) {
          alignment.push_back(EDOP_INSERT);
          for (int i = 0; i < c + 1; i++)
            alignment.push_back(EDOP_DELETE);
          break;
        } else {
          blockPos = WORD_SIZE - 1;
          b--;
          currP = alignData->Ps[(size_t)c * maxNumBlocks + b];
          currM = alignData->Ms[(size_t)c * maxNumBlocks + b];
          if (c > 0 && b >= alignData->firstBlocks[c - 1] &&
              b <= alignData->lastBlocks[c - 1]) {
            thereIsLeftBlock = true;
            lP = alignData->Ps[(size_t)(c - 1) * maxNumBlocks + b];
            lM = alignData->Ms[(size_t)(c - 1) * maxNumBlocks + b];
          } else {
            thereIsLeftBlock = false;
          }
        }
      } else {
        blockPos--;
        lP <<= 1;
        lM <<= 1;
      }
      alignment.push_back(EDOP_INSERT);
    }
    // Move left
    else if (lScore != -1 && lScore + 1 == currScore) {
      currScore = lScore;
      uScore = ulScore;
      lScore = ulScore = -1;
      c--;
      if (c == -1) {
        alignment.push_back(EDOP_DELETE);
        int numUp = b * WORD_SIZE + blockPos + 1;
        for (int i = 0; i < numUp; i++) alignment.push_back(EDOP_INSERT);
        break;
      }
      currP = lP;
      currM = lM;
      if (c > 0 && b >= alignData->firstBlocks[c - 1] &&
          b <= alignData->lastBlocks[c - 1]) {
        thereIsLeftBlock = true;
        lP = alignData->Ps[(size_t)(c - 1) * maxNumBlocks + b];
        lM = alignData->Ms[(size_t)(c - 1) * maxNumBlocks + b];
      } else {
        if (c == 0) {
          thereIsLeftBlock = true;
          lScore = b * WORD_SIZE + blockPos + 1;
          ulScore = lScore - 1;
        } else {
          thereIsLeftBlock = false;
        }
      }
      alignment.push_back(EDOP_DELETE);
    }
    // Move up left
    else if (ulScore != -1) {
      uint8_t moveCode =
          ulScore == currScore ? EDOP_MATCH : EDOP_MISMATCH;
      currScore = ulScore;
      uScore = lScore = ulScore = -1;
      c--;
      if (c == -1) {
        alignment.push_back(moveCode);
        int numUp = b * WORD_SIZE + blockPos;
        for (int i = 0; i < numUp; i++) alignment.push_back(EDOP_INSERT);
        break;
      }
      if (blockPos == 0) {
        if (b == 0) {
          alignment.push_back(moveCode);
          for (int i = 0; i < c + 1; i++)
            alignment.push_back(EDOP_DELETE);
          break;
        }
        blockPos = WORD_SIZE - 1;
        b--;
        currP = alignData->Ps[(size_t)c * maxNumBlocks + b];
        currM = alignData->Ms[(size_t)c * maxNumBlocks + b];
      } else {
        blockPos--;
        currP = lP;
        currM = lM;
        currP <<= 1;
        currM <<= 1;
      }
      if (c > 0 && b >= alignData->firstBlocks[c - 1] &&
          b <= alignData->lastBlocks[c - 1]) {
        thereIsLeftBlock = true;
        lP = alignData->Ps[(size_t)(c - 1) * maxNumBlocks + b];
        lM = alignData->Ms[(size_t)(c - 1) * maxNumBlocks + b];
      } else {
        if (c == 0) {
          thereIsLeftBlock = true;
          lScore = b * WORD_SIZE + blockPos + 1;
          ulScore = lScore - 1;
        } else {
          thereIsLeftBlock = false;
        }
      }
      alignment.push_back(moveCode);
    } else {
      break;  // reached end
    }
  }

  // edlib reverses at the end (edlib.cpp:1069)
  for (size_t i = 0, j = alignment.size(); i + 1 < j; i++, j--) {
    uint8_t tmp = alignment[i];
    alignment[i] = alignment[j - 1];
    alignment[j - 1] = tmp;
  }
  return 0;
}

static int obtainAlignment(const uint8_t* query, const uint8_t* rQuery,
                           int queryLength, const uint8_t* target,
                           const uint8_t* rTarget, int targetLength,
                           int bestScore, std::vector<uint8_t>& alignment);

// edlib.cpp:1161-1345
static int obtainAlignmentHirschberg(
    const uint8_t* query, const uint8_t* rQuery, const int queryLength,
    const uint8_t* target, const uint8_t* rTarget, const int targetLength,
    const int bestScore, std::vector<uint8_t>& alignment) {
  const int maxNumBlocks = ceilDiv(queryLength, WORD_SIZE);
  const int W = maxNumBlocks * WORD_SIZE - queryLength;

  std::vector<Word> Peq, rPeq;
  buildPeq(query, queryLength, Peq);
  buildPeq(rQuery, queryLength, rPeq);

  const int leftHalfWidth = targetLength / 2;  // floor (edlib.cpp:1177)
  const int rightHalfWidth = targetLength - leftHalfWidth;

  int score_, endLocation_;
  AlignmentData* alignDataLeftHalf = NULL;
  int ls = myersCalcEditDistanceNW(
      Peq.data(), W, maxNumBlocks, query, queryLength, target,
      targetLength, bestScore, &score_, &endLocation_, false,
      &alignDataLeftHalf, leftHalfWidth - 1);
  AlignmentData* alignDataRightHalf = NULL;
  int rs = myersCalcEditDistanceNW(
      rPeq.data(), W, maxNumBlocks, rQuery, queryLength, rTarget,
      targetLength, bestScore, &score_, &endLocation_, false,
      &alignDataRightHalf, rightHalfWidth - 1);
  if (ls != 0 || rs != 0 || !alignDataLeftHalf || !alignDataRightHalf) {
    delete alignDataLeftHalf;
    delete alignDataRightHalf;
    return -1;
  }

  int firstBlockIdxLeft = alignDataLeftHalf->firstBlocks[0];
  int lastBlockIdxLeft = alignDataLeftHalf->lastBlocks[0];
  int scoresLeftLength =
      (lastBlockIdxLeft - firstBlockIdxLeft + 1) * WORD_SIZE;
  std::vector<int> scoresLeftV(scoresLeftLength);
  int* scoresLeft = scoresLeftV.data();
  for (int blockIdx = firstBlockIdxLeft; blockIdx <= lastBlockIdxLeft;
       blockIdx++) {
    Block block(alignDataLeftHalf->Ps[blockIdx],
                alignDataLeftHalf->Ms[blockIdx],
                alignDataLeftHalf->scores[blockIdx]);
    readBlock(block,
              scoresLeft + (blockIdx - firstBlockIdxLeft) * WORD_SIZE);
  }
  int scoresLeftStartIdx = firstBlockIdxLeft * WORD_SIZE;
  if (lastBlockIdxLeft == maxNumBlocks - 1) scoresLeftLength -= W;

  int firstBlockIdxRight = alignDataRightHalf->firstBlocks[0];
  int lastBlockIdxRight = alignDataRightHalf->lastBlocks[0];
  int scoresRightLength =
      (lastBlockIdxRight - firstBlockIdxRight + 1) * WORD_SIZE;
  std::vector<int> scoresRightV(scoresRightLength);
  int* scoresRight = scoresRightV.data();
  for (int blockIdx = firstBlockIdxRight; blockIdx <= lastBlockIdxRight;
       blockIdx++) {
    Block block(alignDataRightHalf->Ps[blockIdx],
                alignDataRightHalf->Ms[blockIdx],
                alignDataRightHalf->scores[blockIdx]);
    readBlockReverse(block, scoresRight + (lastBlockIdxRight - blockIdx) *
                                              WORD_SIZE);
  }
  int scoresRightStartIdx = queryLength - (lastBlockIdxRight + 1) * WORD_SIZE;
  if (scoresRightStartIdx < 0) {
    scoresRight += W;
    scoresRightStartIdx += W;
    scoresRightLength -= W;
  }

  delete alignDataLeftHalf;
  delete alignDataRightHalf;

  int queryIdxLeftStart = maxI(scoresLeftStartIdx, scoresRightStartIdx - 1);
  int queryIdxLeftEnd = minI(scoresLeftStartIdx + scoresLeftLength - 1,
                             scoresRightStartIdx + scoresRightLength - 2);
  int leftScore = -1, rightScore = -1;
  int queryIdxLeftAlignment = -1;
  bool queryIdxLeftAlignmentFound = false;
  for (int queryIdx = queryIdxLeftStart; queryIdx <= queryIdxLeftEnd;
       queryIdx++) {
    leftScore = scoresLeft[queryIdx - scoresLeftStartIdx];
    rightScore = scoresRight[queryIdx + 1 - scoresRightStartIdx];
    if (leftScore + rightScore == bestScore) {
      queryIdxLeftAlignment = queryIdx;
      queryIdxLeftAlignmentFound = true;
      break;
    }
  }
  if (!queryIdxLeftAlignmentFound && scoresLeftStartIdx == 0 &&
      scoresRightStartIdx == 0) {
    leftScore = leftHalfWidth;
    rightScore = scoresRight[0];
    if (leftScore + rightScore == bestScore) {
      queryIdxLeftAlignment = -1;
      queryIdxLeftAlignmentFound = true;
    }
  }
  if (!queryIdxLeftAlignmentFound &&
      scoresLeftStartIdx + scoresLeftLength == queryLength &&
      scoresRightStartIdx + scoresRightLength == queryLength) {
    leftScore = scoresLeft[scoresLeftLength - 1];
    rightScore = rightHalfWidth;
    if (leftScore + rightScore == bestScore) {
      queryIdxLeftAlignment = queryLength - 1;
      queryIdxLeftAlignmentFound = true;
    }
  }
  if (!queryIdxLeftAlignmentFound) return -1;

  const int ulHeight = queryIdxLeftAlignment + 1;
  const int lrHeight = queryLength - ulHeight;
  const int ulWidth = leftHalfWidth;
  const int lrWidth = rightHalfWidth;
  std::vector<uint8_t> ulAlignment, lrAlignment;
  int ulStatus =
      obtainAlignment(query, rQuery + lrHeight, ulHeight, target,
                      rTarget + lrWidth, ulWidth, leftScore, ulAlignment);
  int lrStatus = obtainAlignment(query + ulHeight, rQuery, lrHeight,
                                 target + ulWidth, rTarget, lrWidth,
                                 rightScore, lrAlignment);
  if (ulStatus != 0 || lrStatus != 0) return -1;

  alignment.clear();
  alignment.reserve(ulAlignment.size() + lrAlignment.size());
  alignment.insert(alignment.end(), ulAlignment.begin(), ulAlignment.end());
  alignment.insert(alignment.end(), lrAlignment.begin(), lrAlignment.end());
  return 0;
}

// edlib.cpp:1090-1145
static int obtainAlignment(const uint8_t* query, const uint8_t* rQuery,
                           const int queryLength, const uint8_t* target,
                           const uint8_t* rTarget, const int targetLength,
                           const int bestScore,
                           std::vector<uint8_t>& alignment) {
  if (queryLength == 0 || targetLength == 0) {
    alignment.assign(targetLength + queryLength,
                     queryLength == 0 ? EDOP_DELETE : EDOP_INSERT);
    return 0;
  }

  const int maxNumBlocks = ceilDiv(queryLength, WORD_SIZE);
  const int W = maxNumBlocks * WORD_SIZE - queryLength;
  int statusCode;

  long long alignmentDataSize =
      (long long)(2 * sizeof(Word) + sizeof(int)) * maxNumBlocks *
          targetLength +
      (long long)2 * sizeof(int) * targetLength;
  if (alignmentDataSize < 1024 * 1024) {
    int score_, endLocation_;
    AlignmentData* alignData = NULL;
    std::vector<Word> Peq;
    buildPeq(query, queryLength, Peq);
    myersCalcEditDistanceNW(Peq.data(), W, maxNumBlocks, query,
                            queryLength, target, targetLength, bestScore,
                            &score_, &endLocation_, true, &alignData, -1);
    if (!alignData || score_ != bestScore ||
        endLocation_ != targetLength - 1) {
      delete alignData;
      return -1;
    }
    statusCode = obtainAlignmentTraceback(queryLength, targetLength,
                                          bestScore, alignData, alignment);
    delete alignData;
  } else {
    statusCode = obtainAlignmentHirschberg(query, rQuery, queryLength,
                                           target, rTarget, targetLength,
                                           bestScore, alignment);
  }
  return statusCode;
}

}  // namespace edpath

extern "C" {

// PATH of the optimal NW alignment of q vs t whose edit distance k is
// already known (e.g. from the device Myers kernel) — exactly the moves
// edlib's obtainAlignment produces, band-edge tie behavior and
// Hirschberg splitting included.  moves must hold ql + tl bytes.
// Returns 0 and sets *moves_len, or -1 on failure (caller falls back to
// its local unbanded path).
int edlib_band_path(const uint8_t* q, int64_t ql, const uint8_t* t,
                    int64_t tl, int64_t k, uint8_t* moves,
                    int64_t* moves_len) {
  if (ql < 0 || tl < 0 || k < 0) return -1;
  std::vector<uint8_t> rq(q, q + ql), rt(t, t + tl);
  for (size_t i = 0, j = rq.size(); i + 1 < j; i++, j--) {
    uint8_t x = rq[i];
    rq[i] = rq[j - 1];
    rq[j - 1] = x;
  }
  for (size_t i = 0, j = rt.size(); i + 1 < j; i++, j--) {
    uint8_t x = rt[i];
    rt[i] = rt[j - 1];
    rt[j - 1] = x;
  }
  std::vector<uint8_t> aln;
  int rc = edpath::obtainAlignment(q, rq.data(), (int)ql, t, rt.data(),
                                   (int)tl, (int)k, aln);
  if (rc != 0) return -1;
  std::memcpy(moves, aln.data(), aln.size());
  *moves_len = (int64_t)aln.size();
  return 0;
}

// Edit distance via the banded fill with edlib's dynamic-k doubling
// (edlibAlign, lib/edlib/edlib.cpp:134-154): O((d/64)*tl) instead of the
// full unbanded DP — what makes host-side distance of oversized gaps
// (beyond every device bucket) cheap at any size.
int64_t edlib_nw_dist(const uint8_t* q, int64_t ql, const uint8_t* t,
                      int64_t tl) {
  using namespace edpath;
  if (ql == 0) return tl;
  if (tl == 0) return ql;
  const int maxNumBlocks = ceilDiv((int)ql, WORD_SIZE);
  const int W = maxNumBlocks * WORD_SIZE - (int)ql;
  std::vector<Word> Peq;
  buildPeq(q, (int)ql, Peq);
  int best = -1, pos = -1;
  int k = WORD_SIZE;
  do {
    AlignmentData* ad = NULL;
    myersCalcEditDistanceNW(Peq.data(), W, maxNumBlocks, q, (int)ql, t,
                            (int)tl, k, &best, &pos, false, &ad, -1);
    delete ad;
    k *= 2;
  } while (best == -1);
  return best;
}

}  // extern "C"
