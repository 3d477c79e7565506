// Row-sweep fill (B2) for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces tpu_align/kernels/fill.py::_make_kernel (launched by _fill_jit)
// for its four aligners -- LNW, LSW, ANW and BSW -- and its three modes:
// packed directions, scores only, and the last DP row (LNW, ANW; with
// ANW's Myers-Miller open_top credits) that Hirschberg's split fills use.
// Bound to PyTorch through a plain C entry point loaded with ctypes
// (tpu_align_torch/kernels/_build.py).
//
// What it computes, per pair b (H-space; the TPU kernel's G-space compares
// same-rank operands, so its tie predicates are the same):
//   mm = H[i-1][j-1] + (ref[j-1] == qry[i-1] ? match : mismatch)
//   dele = H[i-1][j] + gap, ins = H[i][j-1] + gap
//   LNW: t = max(mm, dele), H[i][j] = max(t, ins); DELETION on dele >= mm,
//     then INSERTION on ins >= t (tested last, so it wins a tie).  H[0][j]
//     = j*gap, H[i][0] = i*gap.
//   LSW, BSW: H = max(mm, dele, ins, 0); INSERTION on ins >= mm, then
//     DELETION on dele >= max(ins, mm).  H[0][j] = H[i][0] = 0.  BSW's
//     row recurrence runs unmasked, max(t, H[i][j-1] + gap) with t = 0 out
//     of the band (j outside [i-band+1, i+band-1]), and the row it stores,
//     which the next row and the best cell read, is 0 out of the band
//     (fill.py:335-355); ins reads the unmasked left neighbour.  Best cell:
//     the largest stored H, first in row-major order, or score and cell 0
//     when no H is above 0.
//   ANW (Gotoh, goe = gap_open + gap_extend, tb = open_top[b] or
//     gap_open): H[0][j] = go + j*ge, H[i][0] = tb + i*ge, F[0][j] = -inf;
//     F = max(H[i-1][j] + goe, F[i-1][j] + ge) (row 1: H[0][j] + tb + ge),
//     E = max(H[i][j-1] + goe, E[i][j-1] + ge), E[i][0] = -inf, C = max(mm,
//     F), H = max(C, E); DELETION on F >= mm, INSERTION on E >= C;
//     F-extend bit unless f_open >= f_ext (never on row 1), E-extend bit
//     unless e_open >= e_ext.  The TPU kernel opens E from C; for
//     gap_open <= 0, which the wrapper requires, an E opened from an H that
//     came from E is dominated by extending it, so E, H and both bits agree.
//   Global score H[qlen][rlen] at (qlen, rlen); last-row mode writes
//   H[qlen][j] (and F[qlen][j]) to hlast[j-1, b] (flast) of (N, B).
//   Dirs (MW, B, N) word-major: row i's code of column j at bits
//   bits*((i-1) % rpw) of dirs[(i-1)/rpw, b, j-1], rpw = 16 (2-bit codes)
//   or 8 (ANW, 4-bit codes with the E/F bits).  Only cells with i <= qlen
//   and j <= rlen are computed for the outputs, and only words of columns
//   j <= rlen and word rows holding a row <= qlen are written; the bits of
//   rows past qlen in the last such word are 0.
//
// One design for every mode: a band wavefront across the card.  The TPU
// kernel sweeps a pair's rows in order, a row's left dependency being one
// prefix max in G-space.  On Hopper that is a block a pair paying two
// passes, a block scan and two barriers a row, in sequence over the rows
// (about 3.3 us a row for a 250-bp pair, 64 blocks on 132 SMs for LSW's
// 64 x 16,384^2 end points).  Here each problem's rows are cut into bands
// of kBand = 128 rows, one warp a band, and a band runs B1's anti-diagonal
// wavefront (stagger_fill.cu): lane r owns rows 4r+1..4r+4 of the band and
// at step t computes column t - r + 1 of them, taking the row above from
// lane r-1 by a shuffle.  A band sweeps the columns in chunks of 32:
//   - Band k+1 reads band k's bottom row H (and F) from a global boundary
//     buffer, 32 columns a chunk, one column a lane, loaded 8 steps before
//     use; lane 0 takes column t+1 by one broadcast shuffle.  The top band
//     computes its incoming row 0 from the border.  Every band uses the
//     same border column H[i][0] (ANW: tb + i*ge), and only the top band's
//     first row opens F from the top boundary (tb + ge).
//   - The lane that holds the band's bottom row writes it to the buffer a
//     column a step and, after every 32nd column and the last, publishes
//     the count of columns written with st.release.gpu on the band's ready
//     word; band k+1 spins (ld.acquire.gpu by every lane, then __all_sync)
//     until that count covers the chunk it loads.  The bottom band writes
//     the outputs instead.
//   - Two boundary rows a problem, band k writing slot k % 2: band k+2
//     overwrites column j of the slot band k+1 reads only after band k+1
//     has published column j of its own row, which it computed from that
//     column (its loads happen before a __syncwarp that precedes the
//     publication), so no column is overwritten before it is read.  Ready
//     words are one a band, never reused within a launch.
//   - Forward progress by construction.  Warps are persistent and take
//     (band, problem) items from an atomic ticket counter, band-major
//     (ticket k*B + b), so band k-1 of a problem always holds a smaller
//     ticket than band k.  A warp takes a ticket only while it runs, so
//     the band it waits on has started on a resident warp; by induction
//     the smallest unfinished ticket waits on nothing, and no wait depends
//     on the order blocks are scheduled in or on every block being
//     resident.  Band-major order also lets the first wave of warps run
//     bands 0..G/B of every problem at once.
//   - The ticket and the ready words are reset by a cudaMemsetAsync on the
//     launch's stream; nothing else of the scratch needs clearing.
//   - Bands past a problem's qlen take their ticket and return; columns
//     past its rlen are never read.  A problem with qlen = 0 is row 0.
// What the modes add:
//   - Dirs.  A 128-row band is 8 word rows of 2-bit codes (16 of ANW's
//     4-bit codes), so no word is split between bands; lane 4w+k (2w+k)
//     holds byte (half-word) k of word row w.  No lane owns a word, and
//     the lanes of one word reach a column on consecutive steps.  Each
//     lane stores its byte of the column it computed into a shared-memory
//     ring of 64 columns a band; at the end of chunk c every lane has
//     passed the columns of chunk c-1, and the warp stores them as whole
//     128-byte rows, 32 columns of each word row, one column a lane, the
//     bits of rows past qlen cleared there (clearing them a step, in the
//     lanes' codes, made the dirs modes 5-10 % slower on the H100).  A
//     gather by shuffles instead (each lane keeping its last codes, the
//     word's last lane collecting them and storing 4 bytes a step, 8 or
//     16 scattered stores a warp a step) was 4-12 % slower on the H100
//     (PERF.md), and was removed.
//   - The local best (LSW, BSW).  Each lane keeps a running best per row,
//     taken on a strict >, so a row's first column wins (columns reach a
//     row in order); at the band's end the warp reduces in better() order.
//     A band that is not the problem's last writes its best to a (bands,
//     B) scratch, then publishes rlen + 1 on its ready word, its last
//     release (its releases within the sweep stop short of rlen), so the
//     next band's last wait in the sweep (for rlen, or for 1 when rlen =
//     0) acquires it before the band makes its own; the bottom band waits
//     for rlen + 1 and reduces the bests of the bands above in better()
//     order.  The release/acquire chain down the bands makes every best
//     visible.
//   - BSW keeps two values a row: the unmasked H of the row recurrence and
//     the masked H that flows down and into the best.
// A band costs rlen + 31 steps of 4 rows a lane; band k+1 trails band k by
// at least 70 steps (30 for the lanes' skew, 40 for the chunk it loads
// ahead) and the hand-off's latency.  A step's instructions (shuffles,
// selects, the chunk's bookkeeping) bound it, not the rows' arithmetic:
// on the card a step of one warp costs about the same at 1, 2, 4 or 8 rows
// a lane.  So the 32 steps of a chunk are unrolled (the shuffles' lanes
// and the chunk's checks are constants), and 128-row bands (4 rows a lane)
// timed best against 32, 64 and 256 (PERF.md).
//
// The entry point launches on the caller's stream, never synchronises, and
// returns cudaGetLastError() so a refused launch reaches the wrapper.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);  // -inf: one add of a score cannot overflow
constexpr unsigned kFull = 0xffffffffu;

constexpr uint32_t kDiagMatch = 0;
constexpr uint32_t kDiagMismatch = 1;
constexpr uint32_t kQueryDeletion = 2;
constexpr uint32_t kQueryInsertion = 3;
constexpr uint32_t kEExtend = 4;  // core/directions.py BIT_E_EXTEND
constexpr uint32_t kFExtend = 8;  // core/directions.py BIT_F_EXTEND

// algorithm and mode codes of the entry point
constexpr int kLNW = 0;
constexpr int kLSW = 1;
constexpr int kANW = 2;
constexpr int kBSW = 3;
constexpr int kModeScores = 0;
constexpr int kModeDirs = 1;
constexpr int kModeLastRows = 2;

constexpr int kRows = 4;             // query rows a lane
constexpr int kBand = 32 * kRows;    // query rows a band (a warp)
constexpr int kWarps = 4;            // warps a block
constexpr int kAhead = 24;  // the step of a chunk that loads the next one
constexpr int kRing = 64;   // columns of a band's dirs ring
// scratch words before the ready words: the ticket, alone in its line
constexpr int kHead = 32;

int bands_of(int M) { return std::max(1, (M + kBand - 1) / kBand); }

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// row-major first occurrence of the best local score
__device__ __forceinline__ bool better(int v1, int r1, int c1, int v2, int r2,
                                       int c2) {
  return v1 > v2 || (v1 == v2 && (r1 < r2 || (r1 == r2 && c1 < c2)));
}

// the best (score, row, column) across the warp, on every lane
__device__ __forceinline__ void warp_best(int& v, int& r, int& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int v2 = __shfl_xor_sync(kFull, v, off);
    const int r2 = __shfl_xor_sync(kFull, r, off);
    const int c2 = __shfl_xor_sync(kFull, c, off);
    if (better(v2, r2, c2, v, r, c)) {
      v = v2;
      r = r2;
      c = c2;
    }
  }
}

struct Args {
  const uint8_t* ref;       // (B, N)
  const uint8_t* qry;       // (B, M)
  const int32_t* ref_len;   // (B,)
  const int32_t* qry_len;   // (B,)
  const int32_t* open_top;  // (B,) or null (ANW)
  int B, N, M, match, mismatch, gap, gap_open, gap_extend, band;
  int bands;                // bands a problem, ceil(M / kBand)
  unsigned* ticket;         // the next (band, problem) item
  int32_t* ready;           // (bands, B): columns of a band's row published
  int32_t* hbuf;            // (B, 2, N): a band's bottom row H, 2 slots
  int32_t* fbuf;            // (B, 2, N): its F (ANW)
  int32_t* bests;           // (bands, B, 3): a band's best cell (LSW, BSW)
  int32_t* score;           // (B,)
  int32_t* srow;            // (B,) (scores and dirs modes)
  int32_t* scol;            // (B,)
  uint32_t* dirs;           // (MW, B, N) (dirs mode)
  int32_t* hlast;           // (N, B) (last-row mode)
  int32_t* flast;           // (N, B)
};

// Band k (rows 128k+1 .. 128k+128) of problem b; see the header.  ring is
// the warp's dirs ring, (word rows, kRing) words.
template <int kAlgo, int kMode>
__device__ void fill_band(const Args& a, int b, int k, int lane,
                          uint32_t* ring) {
  constexpr bool kLocal = kAlgo == kLSW || kAlgo == kBSW;
  constexpr bool kBanded = kAlgo == kBSW;
  constexpr bool kAffine = kAlgo == kANW;
  constexpr bool kDirs = kMode == kModeDirs;
  constexpr bool kLast = kMode == kModeLastRows;
  constexpr int kBits = kAffine ? 4 : 2;          // bits a code
  constexpr int kRpw = 32 / kBits;                // rows a dirs word
  constexpr int kLanesPerWord = kRpw / kRows;    // 4, or 2 for ANW
  constexpr int kWordRows = kBand / kRpw;         // 8, or 16 for ANW
  const int N = a.N;
  // never sweep past the padded widths, whatever the lengths claim
  const int rl_in = a.ref_len[b];
  const int ql_in = a.qry_len[b];
  const int rl = min(max(rl_in, 0), N);
  const int ql = min(max(ql_in, 0), a.M);
  const int gap = a.gap;
  const int ge = a.gap_extend;
  const int goe = a.gap_open + ge;
  const int tb = kAffine && a.open_top != nullptr ? a.open_top[b]
                                                  : a.gap_open;
  const size_t col = static_cast<size_t>(a.B);  // stride of an (N, B) row
  auto col_border = [&](int i) {  // H[i][0]
    if (kLocal) return 0;
    if (kAffine) return i == 0 ? 0 : tb + i * ge;
    return i * gap;
  };
  auto row_border = [&](int j) {  // H[0][j]
    if (kLocal) return 0;
    if (kAffine) return j == 0 ? 0 : a.gap_open + j * ge;
    return j * gap;
  };
  if (ql == 0) {  // the DP is row 0
    if (k == 0) {
      if (kLast) {
        for (int j = 1 + lane; j <= rl; j += 32) {
          a.hlast[(j - 1) * col + b] = row_border(j);
          if (kAffine) a.flast[(j - 1) * col + b] = kNeg;
        }
      }
      if (lane == 0) {
        a.score[b] = row_border(rl);
        if (!kLast) {
          a.srow[b] = kLocal ? 0 : ql_in;
          a.scol[b] = kLocal ? 0 : rl_in;
        }
      }
    }
    return;
  }
  const int i0 = k * kBand;
  if (i0 >= ql) return;  // past this problem's rows
  const int rows = min(kBand, ql - i0);
  const bool top = k == 0;
  const bool bottom = i0 + rows == ql;
  // the lane of the band's last row; its rows past qlen pass it down
  const int writer = (rows - 1) / kRows;
  const size_t slot = static_cast<size_t>(b) * 2;
  const int32_t* in_h = a.hbuf + (slot + ((k + 1) & 1)) * N;
  const int32_t* in_f = kAffine ? a.fbuf + (slot + ((k + 1) & 1)) * N
                                : nullptr;
  int32_t* out_h = a.hbuf + (slot + (k & 1)) * N;
  int32_t* out_f = kAffine ? a.fbuf + (slot + (k & 1)) * N : nullptr;
  const int32_t* in_ready =
      top ? nullptr : a.ready + static_cast<size_t>(k - 1) * a.B + b;
  int32_t* out_ready = a.ready + static_cast<size_t>(k) * a.B + b;
  const uint8_t* rp = a.ref + static_cast<size_t>(b) * N;
  // dirs: the band's first word row, the word rows holding a row <= qlen,
  // and this lane's word row
  const int wrow0 = i0 / kRpw;
  const int live_words = (rows + kRpw - 1) / kRpw;
  const int my_word = lane / kLanesPerWord;
  // the codes of rows <= qlen in the last live word row (rows past qlen
  // hold the codes of dead rows in the ring and are stored as 0)
  const int tail_bits = (rows - (live_words - 1) * kRpw) * kBits;
  const uint32_t tail_mask = tail_bits >= 32 ? ~0u : (1u << tail_bits) - 1u;

  const int i1 = i0 + kRows * lane + 1;  // this lane's first row
  // h: the stored H[i][j] of the previous step (left); BSW's hl: the
  // unmasked one its row recurrence reads
  int h[kRows], hl[kRows], f[kRows], e[kRows], border[kRows], f_open[kRows];
  int qc[kRows], bestv[kRows], bestj[kRows];
  uint32_t fbit[kRows];  // ANW's F-extend bit: never on row 1
  bool row_live[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = i1 + q;
    row_live[q] = i <= ql;
    qc[q] = row_live[q] ? a.qry[static_cast<size_t>(b) * a.M + i - 1] : 0;
    border[q] = col_border(i);
    f_open[q] = (kAffine && i == 1) ? tb + ge : goe;
    fbit[q] = i == 1 ? 0u : kFExtend;
    h[q] = hl[q] = border[q];
    f[q] = e[q] = kNeg;
    bestv[q] = bestj[q] = 0;
  }
  auto wait_until = [&](int v) {  // band k-1's ready word reaches v
    while (!__all_sync(kFull, ld_acquire(in_ready) >= v)) {
      __nanosleep(64);
    }
  };
  // band k-1 has published columns 1..cols of its bottom row; a local
  // band with rlen = 0 waits for the band above's last release (1), so
  // the chain of bests holds with no column to wait on
  auto wait_for = [&](int cols) {
    if (!top) wait_until(kLocal && rl == 0 ? 1 : min(cols, rl));
  };
  // the incoming row H[i0][j] (F[i0][j]) and ref[j-1], 32 columns a chunk
  auto load_h = [&](int j) {
    if (j > rl) return 0;
    return top ? row_border(j) : __ldcg(in_h + j - 1);
  };
  auto load_f = [&](int j) {
    return (top || j > rl) ? kNeg : __ldcg(in_f + j - 1);
  };
  auto load_c = [&](int kk) { return kk < rl ? static_cast<int>(rp[kk]) : 0; };
  // the dirs of columns 32*blk+1 .. 32*blk+32, one column a lane, from
  // the ring to whole 128-byte rows of each word row
  auto flush = [&](int blk) {
    __syncwarp();
    const int c = blk * 32 + lane + 1;
    if (c <= rl) {
#pragma unroll
      for (int w = 0; w < kWordRows; ++w) {
        if (w < live_words) {
          const uint32_t v = ring[w * kRing + ((c - 1) & (kRing - 1))];
          a.dirs[(static_cast<size_t>(wrow0 + w) * a.B + b) * N + c - 1] =
              w == live_words - 1 ? v & tail_mask : v;
        }
      }
    }
    __syncwarp();
  };
  wait_for(32);
  int cur_h = load_h(1 + lane), cur_c = load_c(lane);
  int cur_f = kAffine ? load_f(1 + lane) : kNeg;
  int nxt_h = 0, nxt_c = 0, nxt_f = kNeg;
  int diag = col_border(i0);  // lane 0's H[i1-1][j-1] at j = 1
  int c = 0;                  // ref[j-1] of the previous step
  int last = col_border(ql);  // H[qlen][rlen] when rlen is 0
  int blocks = 0;             // dirs: the 32-column blocks stored
  const int steps = rl + writer;
  // a chunk of 32 steps unrolled: the lane a shuffle reads and the step
  // that loads the next chunk are constants
  for (int t0 = 0; t0 < steps; t0 += 32) {
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      const int t = t0 + s;
      if (t >= steps) break;
      if (s == kAhead && t0 + 32 < rl) {  // the next chunk
        const int base = t0 + 32;
        wait_for(base + 32);
        nxt_h = load_h(base + 1 + lane);
        nxt_c = load_c(base + lane);
        if (kAffine) nxt_f = load_f(base + 1 + lane);
      }
      const int in_hs = __shfl_sync(kFull, cur_h, s);  // H[i0][t+1]
      const int in_c = __shfl_sync(kFull, cur_c, s);   // ref[t]
      int up = __shfl_up_sync(kFull, h[kRows - 1], 1);
      int cc = __shfl_up_sync(kFull, c, 1);
      int upf = kNeg;
      if (kAffine) {
        const int in_fs = __shfl_sync(kFull, cur_f, s);
        upf = __shfl_up_sync(kFull, f[kRows - 1], 1);
        if (lane == 0) upf = in_fs;
      }
      if (lane == 0) {
        up = in_hs;
        cc = in_c;
      }
      const int j = t - lane + 1;
      const bool before = j < 1;  // a lane at j <= 0 holds H[i][0]
      const bool counts = kLocal && !before && j <= rl;  // a best candidate
      // BSW: cell (i1 + q, j) is in the band when xb - q < 2*band - 1
      const unsigned xb = static_cast<unsigned>(j - i1) +
                          static_cast<unsigned>(a.band - 1);
      const unsigned width = 2u * static_cast<unsigned>(a.band) - 1u;
      int d = diag;  // H[i-1][j-1] of the lane's first row
      diag = up;
      c = cc;
      uint32_t codes = 0;  // the lane's codes of column j, row q at kBits*q
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        // values past rlen or qlen feed only cells outside the DP
        const bool eq = cc == qc[q];
        const int mm = d + (eq ? a.match : a.mismatch);
        const int left = kBanded ? hl[q] : h[q];
        d = h[q];  // the next row's diag
        int val, kept;  // H[i][j] unmasked, and as stored
        uint32_t code = 0;
        if (kAffine) {
          int fv, ev;
          if (kDirs) {
            bool f_open_wins, e_open_wins, take_del, take_ins;
            fv = __vibmax_s32(up + f_open[q], upf + ge, &f_open_wins);
            ev = __vibmax_s32(left + goe, e[q] + ge, &e_open_wins);
            const int cv = __vibmax_s32(fv, mm, &take_del);  // F >= mm
            val = __vibmax_s32(ev, cv, &take_ins);           // E >= C
            code = take_ins   ? kQueryInsertion
                   : take_del ? kQueryDeletion
                   : eq       ? kDiagMatch
                              : kDiagMismatch;
            code |= (f_open_wins ? 0u : fbit[q]) |
                    (e_open_wins ? 0u : kEExtend);
          } else {
            fv = max(up + f_open[q], upf + ge);
            ev = max(left + goe, e[q] + ge);
            val = max(max(fv, mm), ev);
          }
          e[q] = before ? kNeg : ev;  // E[i][0] = -inf
          f[q] = row_live[q] ? fv : upf;
          upf = f[q];
          kept = val;
        } else if (kLocal) {
          const bool in_band =
              !kBanded || xb - static_cast<unsigned>(q) < width;
          if (kDirs) {
            bool take_ins, take_del;
            const int dele = up + gap;
            const int b1 = __vibmax_s32(left + gap, mm, &take_ins);
            __vibmax_s32(dele, b1, &take_del);
            code = take_del   ? kQueryDeletion
                   : take_ins ? kQueryInsertion
                   : eq       ? kDiagMatch
                              : kDiagMismatch;
            val = in_band ? __vimax_s32_relu(b1, dele)
                          : __vimax_s32_relu(left + gap, 0);
          } else {
            val = in_band
                      ? __viaddmax_s32_relu(left, gap,
                                            __viaddmax_s32(up, gap, mm))
                      : __vimax_s32_relu(left + gap, 0);
          }
          kept = in_band ? val : 0;
        } else {
          if (kDirs) {
            bool take_del, take_ins;
            const int tv = __vibmax_s32(up + gap, mm, &take_del);
            val = __vibmax_s32(left + gap, tv, &take_ins);
            code = take_ins   ? kQueryInsertion
                   : take_del ? kQueryDeletion
                   : eq       ? kDiagMatch
                              : kDiagMismatch;
          } else {
            // DPX add-max: 4-7 % faster here; slower in the affine chain
            val = __viaddmax_s32(left, gap, __viaddmax_s32(up, gap, mm));
          }
          kept = val;
        }
        h[q] = before ? border[q] : row_live[q] ? kept : up;
        if (kBanded) hl[q] = before ? border[q] : row_live[q] ? val : up;
        up = h[q];  // the next row's up
        if (counts && h[q] > bestv[q]) {  // rows past qlen only tie
          bestv[q] = h[q];
          bestj[q] = j;
        }
        codes |= code << (kBits * q);
      }
      if constexpr (kDirs) {
        if (!before) {  // this lane's codes into the ring
          const int at = my_word * kRing + ((j - 1) & (kRing - 1));
          if (kAffine) {
            reinterpret_cast<uint16_t*>(ring)[at * 2 + lane % 2] =
                static_cast<uint16_t>(codes);
          } else {
            reinterpret_cast<uint8_t*>(ring)[at * 4 + lane % 4] =
                static_cast<uint8_t>(codes);
          }
        }
      }
      if (lane == writer && !before && j <= rl) {
        if (bottom) {
          if (kLast) {
            a.hlast[(j - 1) * col + b] = h[kRows - 1];
            if (kAffine) a.flast[(j - 1) * col + b] = f[kRows - 1];
          }
          if (j == rl) last = h[kRows - 1];
        } else {
          out_h[j - 1] = h[kRows - 1];
          if (kAffine) out_f[j - 1] = f[kRows - 1];
        }
      }
      // a local band's last release follows its best (below)
      const int jw = t - writer + 1;  // the writer's column, on every lane
      if (!bottom && jw >= 1 && (kLocal ? jw < rl : jw <= rl) &&
          ((jw & 31) == 0 || jw == rl)) {
        __syncwarp();  // this chunk's loads, on every lane, come first
        if (lane == writer) st_release(out_ready, jw);
      }
    }
    cur_h = nxt_h;
    cur_c = nxt_c;
    cur_f = nxt_f;
    // at the end of chunk t0/32 every lane has passed the chunk before
    if constexpr (kDirs) {
      if (t0 >= 32 && t0 + 32 <= steps) flush(blocks++);
    }
  }
  if constexpr (kDirs) {
    for (; blocks * 32 < rl; ++blocks) flush(blocks);
  }
  if (kLocal) {
    int v = 0, bi = 0, bj = 0;  // the lane's best, its rows in order
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (bestv[q] > v) {
        v = bestv[q];
        bi = i1 + q;
        bj = bestj[q];
      }
    }
    warp_best(v, bi, bj);
    if (!bottom) {
      __syncwarp();
      if (lane == writer) {
        int32_t* out = a.bests + (static_cast<size_t>(k) * a.B + b) * 3;
        out[0] = v;
        out[1] = bi;
        out[2] = bj;
        st_release(out_ready, rl + 1);
      }
      return;
    }
    if (!top) {  // every band above has published its best
      wait_until(rl + 1);
      for (int kk = lane; kk < k; kk += 32) {
        const int32_t* in = a.bests + (static_cast<size_t>(kk) * a.B + b) * 3;
        const int v2 = __ldcg(in), r2 = __ldcg(in + 1), c2 = __ldcg(in + 2);
        if (better(v2, r2, c2, v, bi, bj)) {
          v = v2;
          bi = r2;
          bj = c2;
        }
      }
      warp_best(v, bi, bj);
    }
    if (lane == 0) {
      a.score[b] = v;
      a.srow[b] = bi;
      a.scol[b] = bj;
    }
  } else if (bottom && lane == writer) {
    a.score[b] = last;
    if (!kLast) {
      a.srow[b] = ql_in;
      a.scol[b] = rl_in;
    }
  }
}

template <int kAlgo, int kMode>
__global__ void __launch_bounds__(kWarps * 32) band_fill_kernel(Args a) {
  constexpr int kRingWords =
      kMode == kModeDirs ? (kAlgo == kANW ? 16 : 8) * kRing : 1;
  __shared__ uint32_t ring[kWarps][kRingWords];
  const int lane = threadIdx.x & 31;
  const unsigned items = static_cast<unsigned>(a.bands) * a.B;
  for (;;) {
    unsigned item = 0;
    if (lane == 0) item = atomicAdd(a.ticket, 1u);
    item = __shfl_sync(kFull, item, 0);
    if (item >= items) return;
    fill_band<kAlgo, kMode>(a, static_cast<int>(item % a.B),
                            static_cast<int>(item / a.B), lane,
                            ring[threadIdx.x >> 5]);
  }
}

// warps (may be null) receives the persistent warps the launch runs, grid x
// kWarps, from the occupancy the instantiation's registers allow.
template <int kAlgo, int kMode>
cudaError_t launch(const Args& a, cudaStream_t st, int* warps) {
  auto kernel = band_fill_kernel<kAlgo, kMode>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kWarps * 32, 0);
  }
  if (e != cudaSuccess) return e;
  // the ticket and the ready words start at 0 on every launch
  e = cudaMemsetAsync(
      a.ticket, 0,
      (kHead + static_cast<size_t>(a.bands) * a.B) * sizeof(int32_t), st);
  if (e != cudaSuccess) return e;
  // persistent warps: as many as fit, or one an item
  const long long items = static_cast<long long>(a.bands) * a.B;
  const long long want = (items + kWarps - 1) / kWarps;
  const int grid = std::max(1, static_cast<int>(std::min<long long>(
                                   want, static_cast<long long>(per_sm) * sms)));
  kernel<<<grid, kWarps * 32, 0, st>>>(a);
  if (warps != nullptr) *warps = grid * kWarps;
  return cudaGetLastError();
}

}  // namespace

// int32 words of global scratch the fill needs for B problems of N
// columns and M rows: the ticket, a ready word a band, two boundary rows a
// problem (H, and F for ANW) and, for LSW and BSW, a best cell a band.
extern "C" long long ta_torch_rowscan_scratch_words(int algo, int mode, int B,
                                                    int N, int M) {
  (void)mode;
  const long long bands = bands_of(M);
  const long long rows = (algo == kANW ? 4LL : 2LL) * B * N;
  const long long bests = (algo == kLSW || algo == kBSW) ? 3LL * bands * B
                                                         : 0LL;
  return kHead + bands * B + rows + bests;
}

// algo: 0 = LNW, 1 = LSW, 2 = ANW, 3 = BSW; mode: 0 = scores only, 1 =
// dirs (MW, B, N), 2 = last rows hlast (and ANW's flast) (N, B) and the
// score, LNW and ANW only.  open_top (B,) may be null (ANW: gap_open).
// scratch holds ta_torch_rowscan_scratch_words(algo, mode, B, N, M) words.
// warps, a host int (may be null), receives the persistent warps launched
// (0 where nothing is launched); reading it needs no device sync.
extern "C" int ta_torch_rowscan_fill(
    int algo, int mode, const void* ref, const void* qry, const void* ref_len,
    const void* qry_len, const void* open_top, int B, int N, int M,
    int match, int mismatch, int gap, int gap_open, int gap_extend, int band,
    void* scratch, void* score, void* srow, void* scol, void* dirs,
    void* hlast, void* flast, void* stream, int* warps) {
  if (warps != nullptr) *warps = 0;
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const bool local = algo == kLSW || algo == kBSW;
  if (algo < kLNW || algo > kBSW || mode < kModeScores ||
      mode > kModeLastRows || N < 0 || M < 0 || scratch == nullptr ||
      (mode == kModeLastRows && local)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bands = bands_of(M);
  if (static_cast<long long>(bands) * B >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int32_t* w = static_cast<int32_t*>(scratch);
  int32_t* hbuf = w + kHead + static_cast<size_t>(bands) * B;
  int32_t* fbuf = hbuf + static_cast<size_t>(2) * B * N;
  int32_t* bests = fbuf + (algo == kANW ? static_cast<size_t>(2) * B * N : 0);
  const Args a{static_cast<const uint8_t*>(ref),
               static_cast<const uint8_t*>(qry),
               static_cast<const int32_t*>(ref_len),
               static_cast<const int32_t*>(qry_len),
               static_cast<const int32_t*>(open_top),
               B, N, M, match, mismatch, gap, gap_open, gap_extend, band,
               bands, reinterpret_cast<unsigned*>(w), w + kHead, hbuf, fbuf,
               bests, static_cast<int32_t*>(score),
               static_cast<int32_t*>(srow), static_cast<int32_t*>(scol),
               static_cast<uint32_t*>(dirs), static_cast<int32_t*>(hlast),
               static_cast<int32_t*>(flast)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (algo * 3 + mode) {
    case kLNW * 3 + kModeScores: e = launch<kLNW, kModeScores>(a, st, warps); break;
    case kLNW * 3 + kModeDirs: e = launch<kLNW, kModeDirs>(a, st, warps); break;
    case kLNW * 3 + kModeLastRows: e = launch<kLNW, kModeLastRows>(a, st, warps); break;
    case kLSW * 3 + kModeScores: e = launch<kLSW, kModeScores>(a, st, warps); break;
    case kLSW * 3 + kModeDirs: e = launch<kLSW, kModeDirs>(a, st, warps); break;
    case kANW * 3 + kModeScores: e = launch<kANW, kModeScores>(a, st, warps); break;
    case kANW * 3 + kModeDirs: e = launch<kANW, kModeDirs>(a, st, warps); break;
    case kANW * 3 + kModeLastRows: e = launch<kANW, kModeLastRows>(a, st, warps); break;
    case kBSW * 3 + kModeScores: e = launch<kBSW, kModeScores>(a, st, warps); break;
    default: e = launch<kBSW, kModeDirs>(a, st, warps); break;
  }
  return static_cast<int>(e);
}
