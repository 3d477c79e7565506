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
//   - Rows a lane (kRows; a band is 32 x kRows rows) are a template
//     argument: 4 in the dirs and last-row modes (a 16-row dirs word, the
//     ring), and in the scores mode what the host asks for
//     (kernels/fill.py band_rows) among the instantiations built.
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
//   - Scores only, a step of its own (fill_band_scores) for every band whose
//     rows are all live (all but a partial bottom band) and hold only A, C, G
//     and T, where match and mismatch fit a byte; every other band takes the
//     general step (fill_band).  At the end of a band that took it, lane 0
//     adds the band's real cells (its rows x rlen) to a 64-bit counter the
//     caller may pass: one atomic an item, none in the sweep
//     (runtime/profiler.py fill_band_scores_cells).  A band's sweep is peeled
//     into a ramp-in chunk (some lane still at j < 1), steady chunks (every
//     lane's column in [1, rlen]) and the ramp-out (some lane past rlen):
//     only the ramps test the border and rlen.  Rows are never dead, so the
//     writer is the last lane and its store and publication are constants of
//     the chunk.  Each lane packs, once a band, a substitution profile of its
//     rows: a word a row, byte c the score of base code c (A, C, T, G as
//     (code >> 1) & 3) against the row's base; a reference code becomes, once
//     a chunk, a prmt selector of its byte, sign-extended, or of the mismatch
//     word for any code other than A, C, G and T, so a row's score is one
//     prmt, equal to the compare of codes it replaces.  The selectors of the
//     chunk and of the one before, and the incoming row (H, F), go through a
//     per-warp shared-memory stage, two chunks deep, written one chunk ahead:
//     a lane reads its column's selector and lane 0 its incoming H where the
//     general step shuffles and selects.
//   - LNW's scores step runs in the gap-offset form: lanes hold H'[i][j] =
//     H[i][j] - gap*(i + j), for which H' = max(H'[i-1][j-1] + w - 2*gap,
//     H'[i-1][j], H'[i][j-1]) with borders H'[i][0] = H'[0][j] = 0, the
//     same integers once shifted back.  Both gap terms are free, so a cell
//     is a prmt of the profile (its bytes match - 2*gap and mismatch -
//     2*gap, the mismatch word likewise), the add of the diagonal (an
//     IMAD, off the integer ALU) and one 3-way max with the left
//     neighbour and the row above: 3 operations where the plain recurrence
//     takes 4, the row-to-row chain still one.  (A max of the row above
//     with an add-max of the diagonal and the left neighbour issues 3 too,
//     but ran at the 4-operation step's speed on the H100: PERF.md.)  The
//     form is converted only at the band's edges: the incoming row to H' as
//     it is staged, a chunk at a time, and the writer's row back to H as it
//     is stored, so the boundary buffer holds H whichever step wrote it or
//     reads it (a partial bottom band, or one holding a code other than A,
//     C, G and T, takes the general step on the same buffer); one running
//     gap*(i + j) of the writer's cell, an add a step, gives both, so the
//     sweep keeps no row index live.  The bottom band's score is H' +
//     gap*(qlen + rlen).  LNW's profile fits only where the shifted weights
//     fit a signed byte and (M + N) x (their larger magnitude + |gap|) fits
//     int32, which bounds H', gap*(i + j) and their sum (kernels/fill.py
//     profile_fits makes the same choice); elsewhere every LNW band takes
//     the general step.  LSW's and BSW's floor at 0 does not survive the
//     shift, and ANW's would issue fewer operations than
//     benchmarks/roofline.py counts for it.
// A band costs rlen + 31 steps; band k+1 trails band k by at least 70
// steps (30 for the lanes' skew, 40 for the chunk it loads ahead) and the
// hand-off's latency.  What bounds a step depends on the launch.  A lone
// warp (a few problems on an empty card) waits on its step's chain: the
// shuffle and one dependent operation a row, so a step of more rows is a
// longer wait (on the H100, one 16 kbp LNW pair: 3.4 ms at 4 rows a lane,
// 3.9 at 8).  A full card is bound by the instructions its SMs issue for
// all their warps: there the general step's bookkeeping (shuffles, lane-0
// and border selects, row_live selects, the compare and select of a
// substitution, the writer's and the publication's tests) cost about 27
// SM-cycles a warp-step for LNW's 12 operations, and the scores step,
// which issues little besides the cell's arithmetic, took 549 LNW pairs
// of 16 kbp from 118 ms to 47 at 4 rows a lane and 40 at 8 (ANW: 188 ->
// 77 / 65), the wider band sharing its step's few instructions among
// more rows, and the gap-offset form from 41.6 to 36.6 at 8 (PERF.md
// section 6).  So the host asks for 8 rows a lane only
// on a launch that fills the card many times over (kernels/fill.py
// band_rows).
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

constexpr int kWarps = 4;   // warps a block
constexpr int kAhead = 24;  // the step of a chunk that loads the next one
constexpr int kRing = 64;   // columns of a band's dirs ring
// a warp's scores stage: selectors [2][64], incoming H [2][32] and F [2][32]
constexpr int kStageWords = 256;
// scratch words before the ready words: the ticket, alone in its line
constexpr int kHead = 32;

// The steps of a scores chunk unrolled together (a divisor of 32 and of
// kAhead), by instantiation, as timed on the H100 (PERF.md section 6): a
// whole chunk for LNW at 8 rows a lane and for LSW, 8 steps elsewhere.
__host__ __device__ constexpr int scores_group(int algo, int rows) {
  return (algo == kLNW && rows == 8) || algo == kLSW ? 32 : 8;
}

int bands_of(int M, int band_rows) {
  return std::max(1, (M + band_rows - 1) / band_rows);
}

// Whether the scores step's profile holds the weights in signed bytes:
// LNW's in the gap-offset form (match and mismatch less 2*gap), and only
// where (M + N) x (their larger magnitude + |gap|) fits int32 (see the
// header); kernels/fill.py profile_fits is the same test.
bool profile_fits(int algo, int match, int mismatch, int gap, int M, int N) {
  const long long shift = algo == kLNW ? 2LL * gap : 0LL;
  const long long w1 = match - shift, w2 = mismatch - shift;
  if (w1 < -128 || w1 > 127 || w2 < -128 || w2 > 127) return false;
  if (algo != kLNW) return true;
  const long long size = std::max(std::max(w1, -w1), std::max(w2, -w2)) +
                         std::max<long long>(gap, -static_cast<long long>(gap));
  return (static_cast<long long>(M) + N) * size <= INT32_MAX;
}

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

// every lane spins until the ready word reaches v
__device__ __forceinline__ void wait_ready(const int32_t* p, int v) {
  while (!__all_sync(kFull, ld_acquire(p) >= v)) {
    __nanosleep(64);
  }
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

__device__ __forceinline__ bool is_base(int c) {
  return c == 'A' || c == 'C' || c == 'G' || c == 'T';
}

// The prmt selector of reference code c against a row's profile word
// (fill_band_scores): byte (c >> 1) & 3 for A, C, T, G (0, 1, 2, 3), byte
// 4 (the mismatch word's) for any other code, sign-extended to 32 bits.
__device__ __forceinline__ uint32_t code_sel(int c) {
  const uint32_t k = is_base(c) ? (static_cast<uint32_t>(c) >> 1) & 3u : 4u;
  return k * 0x1111u + 0x8880u;
}

// bytes 0-3 of a, 4-7 of b, picked and sign-extended by sel
__device__ __forceinline__ int prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return static_cast<int>(d);
}

template <bool kValue>
struct Flag {  // a compile-time argument of a generic lambda
  static constexpr bool value = kValue;
};

struct Args {
  const uint8_t* ref;       // (B, N)
  const uint8_t* qry;       // (B, M)
  const int32_t* ref_len;   // (B,)
  const int32_t* qry_len;   // (B,)
  const int32_t* open_top;  // (B,) or null (ANW)
  int B, N, M, match, mismatch, gap, gap_open, gap_extend, band;
  int bands;                // bands a problem, ceil(M / band rows)
  bool packed;              // the scores step's profile fits (profile_fits)
  unsigned* ticket;         // the next (band, problem) item
  int32_t* ready;           // (bands, B): columns of a band's row published
  int32_t* hbuf;            // (B, 2, N): a band's bottom row H, 2 slots
  int32_t* fbuf;            // (B, 2, N): its F (ANW)
  int32_t* bests;           // (bands, B, 3): a band's best cell (LSW, BSW)
  // real cells of the band items that took the scores step, added to (may
  // be null)
  unsigned long long* scores_cells;
  int32_t* score;           // (B,)
  int32_t* srow;            // (B,) (scores and dirs modes)
  int32_t* scol;            // (B,)
  uint32_t* dirs;           // (MW, B, N) (dirs mode)
  int32_t* hlast;           // (N, B) (last-row mode)
  int32_t* flast;           // (N, B)
};

// H[i][0] and H[0][j] of problem b
template <int kAlgo>
__device__ __forceinline__ int col_border(const Args& a, int tb, int i) {
  if (kAlgo == kLSW || kAlgo == kBSW) return 0;
  if (kAlgo == kANW) return i == 0 ? 0 : tb + i * a.gap_extend;
  return i * a.gap;
}

template <int kAlgo>
__device__ __forceinline__ int row_border(const Args& a, int j) {
  if (kAlgo == kLSW || kAlgo == kBSW) return 0;
  if (kAlgo == kANW) return j == 0 ? 0 : a.gap_open + j * a.gap_extend;
  return j * a.gap;
}

// A local band's end: the lane's best over its rows (those <= qlen), the
// warp's; a band above the bottom one writes it and makes its last
// release (rlen + 1), the bottom band reduces the bands above and writes
// the outputs.  See the header.
template <int kRows>
__device__ __forceinline__ void finish_local(const Args& a, int b, int k, int lane,
                             int writer, bool top, bool bottom, int rl,
                             int ql, int i1, const int (&bestv)[kRows],
                             const int (&bestj)[kRows],
                             const int32_t* in_ready, int32_t* out_ready) {
  int v = 0, bi = 0, bj = 0;  // the lane's best, its rows in order
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    if (i1 + q <= ql && bestv[q] > v) {
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
    wait_ready(in_ready, rl + 1);
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
}

// Band k (rows kBand*k+1 .. kBand*k+kBand) of problem b, the general step
// of every mode; see the header.  smem is the warp's dirs ring, (word
// rows, kRing) words.
template <int kAlgo, int kMode, int kRows>
__device__ __forceinline__ void fill_band(const Args& a, int b, int k, int lane,
                          uint32_t* ring) {
  constexpr bool kLocal = kAlgo == kLSW || kAlgo == kBSW;
  constexpr bool kBanded = kAlgo == kBSW;
  constexpr bool kAffine = kAlgo == kANW;
  constexpr bool kDirs = kMode == kModeDirs;
  constexpr bool kLast = kMode == kModeLastRows;
  constexpr int kBand = 32 * kRows;               // query rows a band
  constexpr int kBits = kAffine ? 4 : 2;          // bits a code
  constexpr int kRpw = 32 / kBits;                // rows a dirs word
  constexpr int kLanesPerWord = kRpw / kRows;    // 4, or 2 for ANW
  constexpr int kWordRows = kBand / kRpw;         // 8, or 16 for ANW
  static_assert(!kDirs || kRows == 4, "a dirs word spans 4 lanes' rows");
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
  if (ql == 0) {  // the DP is row 0
    if (k == 0) {
      if (kLast) {
        for (int j = 1 + lane; j <= rl; j += 32) {
          a.hlast[(j - 1) * col + b] = row_border<kAlgo>(a, j);
          if (kAffine) a.flast[(j - 1) * col + b] = kNeg;
        }
      }
      if (lane == 0) {
        a.score[b] = row_border<kAlgo>(a, rl);
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
    border[q] = col_border<kAlgo>(a, tb, i);
    f_open[q] = (kAffine && i == 1) ? tb + ge : goe;
    fbit[q] = i == 1 ? 0u : kFExtend;
    h[q] = hl[q] = border[q];
    f[q] = e[q] = kNeg;
    bestv[q] = bestj[q] = 0;
  }
  // band k-1 has published columns 1..cols of its bottom row; a local
  // band with rlen = 0 waits for the band above's last release (1), so
  // the chain of bests holds with no column to wait on
  auto wait_for = [&](int cols) {
    if (!top) wait_ready(in_ready, kLocal && rl == 0 ? 1 : min(cols, rl));
  };
  // the incoming row H[i0][j] (F[i0][j]) and ref[j-1], 32 columns a chunk
  auto load_h = [&](int j) {
    if (j > rl) return 0;
    return top ? row_border<kAlgo>(a, j) : __ldcg(in_h + j - 1);
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
  int diag = col_border<kAlgo>(a, tb, i0);  // lane 0's H[i1-1][j-1] at j = 1
  int c = 0;                  // ref[j-1] of the previous step
  int last = col_border<kAlgo>(a, tb, ql);  // H[qlen][rlen] when rlen is 0
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
  if constexpr (kLocal) {
    finish_local<kRows>(a, b, k, lane, writer, top, bottom, rl, ql, i1,
                        bestv, bestj, in_ready, out_ready);
  } else if (bottom && lane == writer) {
    a.score[b] = last;
    if (!kLast) {
      a.srow[b] = ql_in;
      a.scol[b] = rl_in;
    }
  }
}

// Whether band k of problem b takes the scores step: every row of it is
// live (qlen reaches its end) and holds A, C, G or T, and the scores fit
// the profile's bytes.
template <int kRows>
__device__ __forceinline__ bool takes_scores_step(const Args& a, int b, int k, int lane) {
  const int ql = min(max(a.qry_len[b], 0), a.M);
  const int i0 = k * 32 * kRows;
  if (!a.packed || i0 + 32 * kRows > ql) return false;
  const uint8_t* qp = a.qry + static_cast<size_t>(b) * a.M + i0 + kRows * lane;
  bool base = true;
#pragma unroll
  for (int q = 0; q < kRows; ++q) base = base && is_base(qp[q]);
  return __all_sync(kFull, base);
}

// Band k of problem b, the scores step: every row live and a base (see
// takes_scores_step and the header).  stage is the warp's kStageWords.
template <int kAlgo, int kRows>
__device__ __forceinline__ void fill_band_scores(const Args& a, int b, int k, int lane,
                                 uint32_t* stage) {
  constexpr bool kLocal = kAlgo == kLSW || kAlgo == kBSW;
  constexpr bool kBanded = kAlgo == kBSW;
  constexpr bool kAffine = kAlgo == kANW;
  constexpr bool kOffset = kAlgo == kLNW;  // H' = H - gap*(i + j): the header
  constexpr int kBand = 32 * kRows;
  constexpr int kGroup = scores_group(kAlgo, kRows);
  const int N = a.N;
  const int rl_in = a.ref_len[b];
  const int ql_in = a.qry_len[b];
  const int rl = min(max(rl_in, 0), N);
  const int ql = min(max(ql_in, 0), a.M);
  const int gap = a.gap;
  const int ge = a.gap_extend;
  const int goe = a.gap_open + ge;
  const int tb = kAffine && a.open_top != nullptr ? a.open_top[b]
                                                  : a.gap_open;
  const int i0 = k * kBand;
  const bool top = k == 0;
  const bool bottom = i0 + kBand == ql;
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
  const int i1 = i0 + kRows * lane + 1;  // this lane's first row
  // the profile: byte c of prof[q] scores base code c against row i1 + q,
  // less 2*gap in the offset form
  const int shift = kOffset ? 2 * gap : 0;
  const uint32_t mis = (static_cast<uint32_t>(a.mismatch - shift) & 0xffu) *
                       0x01010101u;
  const uint32_t flip =
      static_cast<uint32_t>((a.match - shift) ^ (a.mismatch - shift)) & 0xffu;
  // H[i][0] (H'[i][0] = 0 in the offset form)
  auto border = [&](int i) {
    return kOffset ? 0 : col_border<kAlgo>(a, tb, i);
  };
  const uint8_t* qp = a.qry + static_cast<size_t>(b) * a.M + i1 - 1;
  // h: the stored H[i][j] of the previous step (left); BSW's hl: the
  // unmasked one its row recurrence reads
  int h[kRows], hl[kRows], f[kRows], e[kRows], bestv[kRows], bestj[kRows];
  uint32_t prof[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    prof[q] = mis ^ (flip << (8 * ((qp[q] >> 1) & 3)));
    h[q] = hl[q] = border(i1 + q);
    f[q] = e[q] = kNeg;
    bestv[q] = bestj[q] = 0;
  }
  const int fo0 = kAffine && i1 == 1 ? tb + ge : goe;  // row i1's F open
  const unsigned width = 2u * static_cast<unsigned>(a.band) - 1u;
  // the stage: a chunk's window of selectors, [2][64] (entry 32 + s - r
  // is lane r's at step s: the chunk's codes and the 32 before), lane 0's
  // incoming H and F, [2][32]; chunk c uses half c % 2
  uint32_t* win = stage;
  int32_t* stage_h = reinterpret_cast<int32_t*>(stage + 128);
  int32_t* stage_f = reinterpret_cast<int32_t*>(stage + 192);
  auto wait_for = [&](int cols) {
    if (!top) wait_ready(in_ready, kLocal && rl == 0 ? 1 : min(cols, rl));
  };
  // the incoming row H[i0][j]; H'[i0][j] in the offset form, where conv
  // is gap*(i0 + j)
  auto load_h = [&](int j, int conv) {
    if (j > rl) return 0;
    if (kOffset) return top ? 0 : __ldcg(in_h + j - 1) - conv;
    return top ? row_border<kAlgo>(a, j) : __ldcg(in_h + j - 1);
  };
  auto load_f = [&](int j) {
    return (top || j > rl) ? kNeg : __ldcg(in_f + j - 1);
  };
  auto load_sel = [&](int kk) {
    return code_sel(kk < rl ? static_cast<int>(rp[kk]) : 0);
  };
  __syncwarp();  // the warp's last band has read its stage
  wait_for(32);
  uint32_t cur_sel = load_sel(lane);  // the codes of the newest chunk staged
  win[lane] = code_sel(0);
  win[32 + lane] = cur_sel;
  stage_h[lane] = load_h(1 + lane, gap * (i0 + 1 + lane));
  if (kAffine) stage_f[lane] = load_f(1 + lane);
  // The offset form's gap*(i0 + kBand + t - 30) at step t: the writer's
  // row and column, one add a step, the incoming row's conversion derived
  // from it when it is staged (so the sweep keeps no row index live).
  // Step -1 to begin with.
  int conv = gap * (i0 + kBand - 31);
  // stage the chunk after chunk t0 in the other half, at step t0 + kAhead
  auto stage_next = [&](int t0) {
    const int half = ((t0 >> 5) + 1) & 1;
    win[half * 64 + lane] = cur_sel;
    const int base = t0 + 32;
    if (base < rl) {
      wait_for(base + 32);
      cur_sel = load_sel(base + lane);
      win[half * 64 + 32 + lane] = cur_sel;
      // gap*(i0 + base + 1 + lane), from the step's conv
      stage_h[half * 32 + lane] = load_h(
          base + 1 + lane, conv + gap * (63 - kAhead - kBand + lane));
      if (kAffine) stage_f[half * 32 + lane] = load_f(base + 1 + lane);
    }
  };
  int diag = border(i0);  // lane 0's H[i1-1][j-1] at j = 1
  const int steps = rl + 31;
  const bool writes = !bottom && lane == 31;  // the band's row goes down
  // Chunk t0's 32 steps, kGroup at a time.  kIn: some lane may be at
  // j < 1; kOut: some lane may be past rlen, or the sweep may end.
  auto chunk = [&](auto in_ramp, auto out_ramp, const int t0) {
    constexpr bool kIn = decltype(in_ramp)::value;
    constexpr bool kOut = decltype(out_ramp)::value;
    __syncwarp();  // the chunk's stage, written in the chunk before
    const int half = (t0 >> 5) & 1;
    const uint32_t* ws = win + half * 64 + 32 - lane;
    const int32_t* hs = stage_h + half * 32;
    const int32_t* fs = stage_f + half * 32;
#pragma unroll 1
    for (int g = 0; g < 32; g += kGroup) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int s = g + u;
        const int t = t0 + s;
        if (kOut && t >= steps) return;
        if (kOffset) conv += gap;
        if (u == kAhead % kGroup && g == kAhead - kAhead % kGroup) {
          stage_next(t0);
        }
        int up = __shfl_up_sync(kFull, h[kRows - 1], 1);
        int upf = kNeg;
        if (kAffine) upf = __shfl_up_sync(kFull, f[kRows - 1], 1);
        if (lane == 0) {
          up = hs[s];  // H[i0][t+1]
          if (kAffine) upf = fs[s];
        }
        const uint32_t sel = ws[s];  // ref[j-1]'s selector
        const int j = t - lane + 1;
        const bool before = kIn && j < 1;  // a lane at j <= 0: H[i][0]
        const bool counts = (!kIn || j >= 1) && (!kOut || j <= rl);
        const unsigned xb = static_cast<unsigned>(j - i1) +
                            static_cast<unsigned>(a.band - 1);
        int d = diag;  // H[i-1][j-1] of the lane's first row
        diag = up;
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int mm = d + prmt(prof[q], mis, sel);
          const int left = kBanded ? hl[q] : h[q];
          d = h[q];  // the next row's diag
          int val;
          if (kAffine) {
            const int ev = __viaddmax_s32(left, goe, e[q] + ge);
            const int fv = __viaddmax_s32(up, q == 0 ? fo0 : goe, upf + ge);
            val = __vimax3_s32(fv, mm, ev);
            e[q] = before ? kNeg : ev;  // E[i][0] = -inf
            f[q] = upf = fv;
          } else if (kLocal) {
            const bool in_band =
                !kBanded || xb - static_cast<unsigned>(q) < width;
            // the row above's term last: one operation on the chain
            val = in_band
                      ? __viaddmax_s32_relu(up, gap,
                                            __viaddmax_s32(left, gap, mm))
                      : __vimax_s32_relu(left + gap, 0);
            if (kBanded) hl[q] = before ? 0 : val;
            if (kBanded && !in_band) val = 0;
          } else {  // the offset form: mm's add on the FMA pipe, one max3
            val = __vimax3_s32(up, left, mm);
          }
          h[q] = before ? border(i1 + q) : val;
          up = h[q];  // the next row's up
          if (kLocal) {
            if (kIn || kOut) {
              if (counts && h[q] > bestv[q]) {
                bestv[q] = h[q];
                bestj[q] = j;
              }
            } else {  // the first column of a row's best keeps it
              bool keep;
              bestv[q] = __vibmax_s32(bestv[q], h[q], &keep);
              bestj[q] = keep ? bestj[q] : j;
            }
          }
        }
        // the last lane's column t - 30 goes down; a local band's last
        // release follows its best
        if (writes && (!kIn || t >= 31)) {  // row i0 + kBand in H
          out_h[t - 31] = kOffset ? h[kRows - 1] + conv : h[kRows - 1];
          if (kAffine) out_f[t - 31] = f[kRows - 1];
        }
        const int jw = t - 30;
        if (kIn || kOut) {
          if (!bottom && jw >= 1 && (kLocal ? jw < rl : jw <= rl) &&
              ((jw & 31) == 0 || jw == rl)) {
            __syncwarp();  // this chunk's loads, on every lane, come first
            if (lane == 31) st_release(out_ready, jw);
          }
        } else if (u == 30 % kGroup && g == 30 - 30 % kGroup && !bottom) {
          __syncwarp();
          if (lane == 31) st_release(out_ready, jw);  // jw = t0
        }
      }
    }
  };
  using Yes = Flag<true>;
  using No = Flag<false>;
  chunk(Yes(), Yes(), 0);
  int t0 = 32;
  for (; t0 + 32 <= rl; t0 += 32) chunk(No(), No(), t0);
  for (; t0 < steps; t0 += 32) chunk(No(), Yes(), t0);
  if constexpr (kLocal) {
    finish_local<kRows>(a, b, k, lane, 31, top, bottom, rl, ql, i1, bestv,
                        bestj, in_ready, out_ready);
  } else if (bottom && lane == 31) {  // H[qlen][rlen], or H[qlen][0]
    a.score[b] = kOffset ? h[kRows - 1] + gap * (ql + rl) : h[kRows - 1];
    a.srow[b] = ql_in;
    a.scol[b] = rl_in;
  }
  // the band's cells into the caller's count, after the sweep: placed
  // here, it leaves every instantiation's registers as they were without
  // it (in fill_items, before the call, LSW's went 80 -> 72 and its step
  // ran 1.4 % slower on the H100: PERF.md section 6)
  if (lane == 0 && a.scores_cells != nullptr) {
    atomicAdd(a.scores_cells, static_cast<unsigned long long>(kBand) * rl);
  }
}

// The persistent warps' loop: take (band, problem) tickets until none is
// left.
template <int kAlgo, int kMode, int kRows>
__device__ __forceinline__ void fill_items(const Args& a) {
  constexpr int kSmemWords =
      kMode == kModeDirs     ? (kAlgo == kANW ? 16 : 8) * kRing
      : kMode == kModeScores ? kStageWords
                             : 1;
  __shared__ uint32_t smem[kWarps][kSmemWords];
  const int lane = threadIdx.x & 31;
  uint32_t* mine = smem[threadIdx.x >> 5];
  const unsigned items = static_cast<unsigned>(a.bands) * a.B;
  for (;;) {
    unsigned item = 0;
    if (lane == 0) item = atomicAdd(a.ticket, 1u);
    item = __shfl_sync(kFull, item, 0);
    if (item >= items) return;
    const int b = static_cast<int>(item % a.B);
    const int k = static_cast<int>(item / a.B);
    if constexpr (kMode == kModeScores) {
      if (takes_scores_step<kRows>(a, b, k, lane)) {
        fill_band_scores<kAlgo, kRows>(a, b, k, lane, mine);
        continue;
      }
    }
    fill_band<kAlgo, kMode, kRows>(a, b, k, lane, mine);
  }
}

template <int kAlgo, int kMode, int kRows>
__global__ void __launch_bounds__(kWarps * 32) band_fill_kernel(Args a) {
  fill_items<kAlgo, kMode, kRows>(a);
}

// BSW's scores instantiation spills a few registers at the blocks a SM
// ptxas trims it to under the plain bounds: held to 5 blocks (96
// registers) it spills none and ran fastest on the H100 (PERF.md)
template <>
__global__ void __launch_bounds__(kWarps * 32, 5)
    band_fill_kernel<kBSW, kModeScores, 4>(Args a) {
  fill_items<kBSW, kModeScores, 4>(a);
}

// The warps of an instantiation the card holds at once: blocks a SM (from
// its registers and shared memory) x SMs x kWarps.
template <int kAlgo, int kMode, int kRows>
cudaError_t resident_warps(int* warps) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, band_fill_kernel<kAlgo, kMode, kRows>, kWarps * 32, 0);
  }
  *warps = per_sm * sms * kWarps;
  return e;
}

// warps (may be null) receives the persistent warps the launch runs, grid x
// kWarps: the resident warps, or one an item.
template <int kAlgo, int kMode, int kRows>
cudaError_t launch(const Args& a, cudaStream_t st, int* warps) {
  int resident = 0;
  cudaError_t e = resident_warps<kAlgo, kMode, kRows>(&resident);
  if (e != cudaSuccess) return e;
  // the ticket and the ready words start at 0 on every launch
  e = cudaMemsetAsync(
      a.ticket, 0,
      (kHead + static_cast<size_t>(a.bands) * a.B) * sizeof(int32_t), st);
  if (e != cudaSuccess) return e;
  const long long items = static_cast<long long>(a.bands) * a.B;
  const long long want = (items + kWarps - 1) / kWarps;
  const int grid = std::max(1, static_cast<int>(std::min<long long>(
                                   want, resident / kWarps)));
  band_fill_kernel<kAlgo, kMode, kRows><<<grid, kWarps * 32, 0, st>>>(a);
  if (warps != nullptr) *warps = grid * kWarps;
  return cudaGetLastError();
}

template <int A, int M, int R>
struct Instance {
  static constexpr int kAlgo = A, kMode = M, kRows = R;
};

// f(Instance<...>()) for the instantiation of (algo, mode) at 4 rows a lane,
// or at 8 (wide: LNW and ANW scores alone); cudaErrorInvalidValue for any
// other
template <class F>
cudaError_t with_instance(int algo, int mode, bool wide, F f) {
  switch ((algo * 3 + mode) * 2 + (wide ? 1 : 0)) {
    case (kLNW * 3 + kModeScores) * 2: return f(Instance<kLNW, kModeScores, 4>());
    case (kLNW * 3 + kModeScores) * 2 + 1: return f(Instance<kLNW, kModeScores, 8>());
    case (kLNW * 3 + kModeDirs) * 2: return f(Instance<kLNW, kModeDirs, 4>());
    case (kLNW * 3 + kModeLastRows) * 2: return f(Instance<kLNW, kModeLastRows, 4>());
    case (kLSW * 3 + kModeScores) * 2: return f(Instance<kLSW, kModeScores, 4>());
    case (kLSW * 3 + kModeDirs) * 2: return f(Instance<kLSW, kModeDirs, 4>());
    case (kANW * 3 + kModeScores) * 2: return f(Instance<kANW, kModeScores, 4>());
    case (kANW * 3 + kModeScores) * 2 + 1: return f(Instance<kANW, kModeScores, 8>());
    case (kANW * 3 + kModeDirs) * 2: return f(Instance<kANW, kModeDirs, 4>());
    case (kANW * 3 + kModeLastRows) * 2: return f(Instance<kANW, kModeLastRows, 4>());
    case (kBSW * 3 + kModeScores) * 2: return f(Instance<kBSW, kModeScores, 4>());
    case (kBSW * 3 + kModeDirs) * 2: return f(Instance<kBSW, kModeDirs, 4>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// int32 words of global scratch the fill needs for B problems of N
// columns and M rows in bands of band_rows: the ticket, a ready word a
// band, two boundary rows a problem (H, and F for ANW) and, for LSW and
// BSW, a best cell a band.
extern "C" long long ta_torch_rowscan_scratch_words(int algo, int mode, int B,
                                                    int N, int M,
                                                    int band_rows) {
  (void)mode;
  const long long bands = bands_of(M, band_rows);
  const long long rows = (algo == kANW ? 4LL : 2LL) * B * N;
  const long long bests = (algo == kLSW || algo == kBSW) ? 3LL * bands * B
                                                         : 0LL;
  return kHead + bands * B + rows + bests;
}

// The warps the card holds at once of the instantiation for (algo, mode,
// band_rows) (see ta_torch_rowscan_fill), or -1 where none is built or
// the occupancy query fails.
extern "C" int ta_torch_rowscan_resident_warps(int algo, int mode,
                                               int band_rows) {
  int warps = 0;
  const cudaError_t e = with_instance(
      algo, mode, band_rows == 256, [&](auto inst) -> cudaError_t {
        using I = decltype(inst);
        if (band_rows != 32 * I::kRows) return cudaErrorInvalidValue;
        return resident_warps<I::kAlgo, I::kMode, I::kRows>(&warps);
      });
  return e == cudaSuccess ? warps : -1;
}

// algo: 0 = LNW, 1 = LSW, 2 = ANW, 3 = BSW; mode: 0 = scores only, 1 =
// dirs (MW, B, N), 2 = last rows hlast (and ANW's flast) (N, B) and the
// score, LNW and ANW only.  band_rows: 32 x the rows a lane, 128, or 256
// for LNW's and ANW's scores mode (kernels/fill.py band_rows picks).
// open_top (B,) may be null (ANW: gap_open).  scratch holds
// ta_torch_rowscan_scratch_words(algo, mode, B, N, M, band_rows) int32
// words.  scores_cells, a device uint64 (may be null), gains each band
// item's real cells (band rows x rlen) where the item takes the scores
// step, one atomic add an item; the caller zeroes it.  warps, a host int
// (may be null), receives the persistent warps launched (0 where nothing
// is launched); reading it needs no device sync.
extern "C" int ta_torch_rowscan_fill(
    int algo, int mode, int band_rows, const void* ref, const void* qry,
    const void* ref_len, const void* qry_len, const void* open_top, int B,
    int N, int M, int match, int mismatch, int gap, int gap_open,
    int gap_extend, int band, void* scratch, void* score, void* srow,
    void* scol, void* dirs, void* hlast, void* flast, void* scores_cells,
    void* stream, int* warps) {
  if (warps != nullptr) *warps = 0;
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const bool local = algo == kLSW || algo == kBSW;
  if (algo < kLNW || algo > kBSW || mode < kModeScores ||
      mode > kModeLastRows || N < 0 || M < 0 || scratch == nullptr ||
      (mode == kModeLastRows && local) ||
      (band_rows != 128 && band_rows != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bands = bands_of(M, band_rows);
  if (static_cast<long long>(bands) * B >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int32_t* w = static_cast<int32_t*>(scratch);
  int32_t* hbuf = w + kHead + static_cast<size_t>(bands) * B;
  int32_t* fbuf = hbuf + static_cast<size_t>(2) * B * N;
  int32_t* bests = fbuf + (algo == kANW ? static_cast<size_t>(2) * B * N : 0);
  const bool packed = profile_fits(algo, match, mismatch, gap, M, N);
  const Args a{static_cast<const uint8_t*>(ref),
               static_cast<const uint8_t*>(qry),
               static_cast<const int32_t*>(ref_len),
               static_cast<const int32_t*>(qry_len),
               static_cast<const int32_t*>(open_top),
               B, N, M, match, mismatch, gap, gap_open, gap_extend, band,
               bands, packed, reinterpret_cast<unsigned*>(w), w + kHead,
               hbuf, fbuf, bests,
               static_cast<unsigned long long*>(scores_cells),
               static_cast<int32_t*>(score),
               static_cast<int32_t*>(srow), static_cast<int32_t*>(scol),
               static_cast<uint32_t*>(dirs), static_cast<int32_t*>(hlast),
               static_cast<int32_t*>(flast)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_instance(
      algo, mode, band_rows == 256, [&](auto inst) -> cudaError_t {
        using I = decltype(inst);
        return launch<I::kAlgo, I::kMode, I::kRows>(a, st, warps);
      }));
}
