// Banded Smith-Waterman (BSW) fill for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces tpu_align/kernels/banded.py::_make_banded_kernel (launched by
// _fill_banded_jit), with and without packed directions.  Bound to PyTorch
// through a plain C entry point loaded with ctypes
// (tpu_align_torch/kernels/_build.py).
//
// The skewed frame: slot k of DP row i holds column j = i - band + k, for
// k in [0, K8), K8 = max(round8(2*band), 8).  What it computes, per pair b
// (H-space; the TPU kernel's G-space over the slots compares same-rank
// operands, so its tie predicates are the same), for rows i = 1..qlen:
//   a cell is valid iff 1 <= k <= 2*band-1 and 1 <= j <= rlen; an invalid
//   cell holds H = 0, and so does every cell of row 0;
//   mm   = H[i-1][slot k] + (ref[j-1] == qry[i-1] ? match : mismatch)
//   dele = H[i-1][slot k+1] + gap, except at the last slot K8-1, whose up
//          neighbour is -inf (banded.py:71-74 fills the shift with NEG);
//          so when K8 == 2*band (band a multiple of 4) the edge slot
//          2*band-1 never takes a deletion, while for K8 > 2*band it reads
//          the invalid slot 2*band as H = 0
//   t    = valid ? max(mm, dele, 0) : 0
//   chain[k] = max(t[k], chain[k-1] + gap)  (the G-space prefix max over
//          the slots, which runs through invalid slots too)
//   H    = valid ? chain : 0
//   ins  = H[i][slot k-1] + gap (-inf at slot 0)
//   code: MATCH / MISMATCH; INSERTION if ins >= mm; then DELETION if
//         dele >= max(mm, ins), tested last (banded.py:154-163)
// Score: the largest valid H, at its first cell in row-major order (strict
// >, so the smallest j wins within a row); score and start cell are all 0
// when no H is above 0.
//
// Directions layout (banded.py, shared with the native walker's skew_band
// mode and the banded walk, stagger_walk.cu): (MW, B, K8) words, MW =
// ceil(M/16); cell (i, slot k) of lane b is word ((i-1)/16, b, k), bits
// 2*((i-1)%16).  Every slot of rows 1..qlen is written, valid or not; only
// the valid cells' codes are the contract, and words of rows past qlen
// are left as they were (no walker reads them).
//
// Bounds on this card (H100 SXM): a 2048-pair 250-bp bucket at band 16
// has 15.8 M band cells at 5 integer lane-operations each (chip_smoke.py
// CELL_OPS), 4.7 us at 16.7 T lane-ops/s, and moves 8.4 MB of dirs, 2.5 us
// at 3.35 TB/s: bound by operations.  A row's chain is serial across its
// slots, so the slots of a row are what can run in parallel.
//
// Design: one warp a pair, the lanes owning the frame's slots, so a
// 2048-pair bucket is 2048 warps (about 15.5 a SM) and a row is a few
// shuffles, not K8 serial steps of one thread.  Lane l owns the S
// consecutive slots k = l*S .. l*S+S-1, S the least power of two with
// 32*S >= K8 (band 16: K8 = 32, S = 1; band 20: K8 = 40, S = 2, 20 lanes
// busy; band <= 4: K8 = 8, 8 lanes busy and 24 idle -- one pair a warp,
// rather than four pairs on 8 lanes each, keeps one code path).  Per row:
//   - diag is the lane's own H of the previous row (slot k, column j-1);
//     up is slot k+1's: the lane's next slot, or lane l+1's first slot by
//     one __shfl_down_sync, -inf at slot K8-1;
//   - the chain is a max-prefix in G-space (G = t - k*gap): a serial pass
//     over the lane's S slots, a warp inclusive max-scan of the lane
//     totals (5 shuffles) and one shuffle for the exclusive prefix, then
//     k*gap added back;
//   - ins of the lane's first slot is slot k-1's new H, which the
//     exclusive prefix already holds (excl + (k-1)*gap when valid, else
//     0), so it takes no shuffle;
//   - the query byte is the row's broadcast load; each lane loads its own
//     reference bytes, the warp's 32*S of them contiguous in the (B, N)
//     tokens (no transposed copy);
//   - each lane builds its slots' 2-bit codes in registers and every 16
//     rows (and at row qlen) the warp stores its K8 consecutive words of
//     (MW, B, K8): 128 bytes for band 16, one coalesced store;
//   - each lane keeps its best with a strict > (rows in order, its slots
//     in column order), and one warp reduction at the end takes the
//     largest value, then the smallest i, then the smallest j.
// Where a lane's slots (H and the dirs accumulators) live, by width:
//   - S <= 8 (band <= 128): registers, no scratch;
//   - K8 <= 29,056 (band <= 14,528): shared memory, slot s of lane l at
//     [s*32 + l], one warp a block, as much as a block's 227 KB hold;
//   - wider: a global scratch of (B, 2, 32*S) int32 that the wrapper
//     allocates (ta_torch_banded_scratch_words gives its size), H at
//     [b][0][s*32 + l] and the accumulators at [b][1][s*32 + l], so a
//     warp's access to one slot of its lanes is one coalesced 128-byte
//     line, as in shared memory.  The same kernel body runs on all three;
//     this one is bound by the slots' traffic, each row reading and
//     writing a pair's 2*32*S words (233 KB at K8 = 29,064) in L2 or HBM.
//
// The entry point launches on the caller's stream, never synchronises, and
// returns cudaGetLastError() so a refused launch reaches the wrapper.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // pairs (warps) a block, register slots
constexpr int kMaxRegSlots = 8;
constexpr int kRowsPerWord = 16;  // 2-bit codes per 32-bit word
constexpr int kNeg = -(1 << 30);  // -inf: one add of a score cannot overflow
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a block may use
constexpr size_t kSmemBytes = 232448;

// whether S slots a lane (H and accumulators) overflow one warp's shared
// memory, so they go to the global scratch
constexpr bool in_global(int S) {
  return S > kMaxRegSlots &&
         static_cast<size_t>(2) * 32 * S * sizeof(int32_t) > kSmemBytes;
}

constexpr uint32_t kDiagMatch = 0;
constexpr uint32_t kDiagMismatch = 1;
constexpr uint32_t kQueryDeletion = 2;
constexpr uint32_t kQueryInsertion = 3;

// A lane's kS slots (H and the dirs accumulators) in registers.
template <int kS>
struct LaneSlots {
  int h[kS];
  uint32_t acc[kS];
  __device__ LaneSlots(int32_t*, int, int) {}
  __device__ int& H(int s) { return h[s]; }
  __device__ uint32_t& Acc(int s) { return acc[s]; }
};

// The same for S slots in memory, shared or global: slot s of lane l at
// [s*32 + l], H first, then the accumulators.
template <>
struct LaneSlots<0> {
  int32_t* h;
  uint32_t* acc;
  __device__ LaneSlots(int32_t* smem, int S, int lane)
      : h(smem + lane),
        acc(reinterpret_cast<uint32_t*>(smem + S * 32 + lane)) {}
  __device__ int& H(int s) { return h[s * 32]; }
  __device__ uint32_t& Acc(int s) { return acc[s * 32]; }
};

// kS slots a lane in registers; kS = 0: S slots a lane in shared memory;
// kS = -1: S slots a lane in the global scratch
template <int kS, bool kDirs>
__global__ void __launch_bounds__(kWarps * 32)
banded_fill_kernel(const uint8_t* __restrict__ ref,      // (B, N)
                   const uint8_t* __restrict__ qry,      // (B, M)
                   const int32_t* __restrict__ ref_len,  // (B,)
                   const int32_t* __restrict__ qry_len,  // (B,)
                   int B, int N, int M, int K8, int band, int S,
                   int match, int mismatch, int gap,
                   int32_t* __restrict__ score,
                   int32_t* __restrict__ srow,
                   int32_t* __restrict__ scol,
                   uint32_t* __restrict__ dirs,          // (MW, B, K8)
                   int32_t* __restrict__ scratch) {      // (B, 2, 32*S)
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  const int ns = kS > 0 ? kS : S;
  int32_t* const slots =
      kS < 0 ? scratch + static_cast<size_t>(b) * 2 * 32 * ns
             : smem + static_cast<size_t>(warp) * 2 * 32 * ns;
  LaneSlots<(kS > 0 ? kS : 0)> sl(slots, ns, lane);
  // never sweep past the padded widths, whatever the lengths claim
  const int rl = min(max(ref_len[b], 0), N);
  const int ql = min(max(qry_len[b], 0), M);
  const int kmax = 2 * band - 1;  // last slot of the band
  const int k0 = lane * ns;       // this lane's first slot
  const uint8_t* rp = ref + static_cast<size_t>(b) * N;
  const uint8_t* qp = qry + static_cast<size_t>(b) * M;
  auto valid = [&](int i, int k) {
    const int j = i - band + k;
    return k >= 1 && k <= kmax && j >= 1 && j <= rl;
  };

#pragma unroll
  for (int s = 0; s < ns; ++s) sl.H(s) = 0;  // row 0: H = 0
  int best = 0, best_i = 0, best_j = 0;
  for (int i = 1; i <= ql; ++i) {
    const uint8_t qc = qp[i - 1];
    const int r = (i - 1) % kRowsPerWord;
    // slot k0 + ns's H of the previous row: lane l+1's first slot
    const int up_next = __shfl_down_sync(kFull, sl.H(0), 1);
    // pass 1: the lane's G-space total
    int total = kNeg;
#pragma unroll
    for (int s = 0; s < ns; ++s) {
      const int k = k0 + s;
      const bool ok = valid(i, k);
      const int up = k + 1 >= K8 ? kNeg : s + 1 < ns ? sl.H(s + 1) : up_next;
      const bool eq = ok && rp[i - band + k - 1] == qc;
      const int mm = sl.H(s) + (eq ? match : mismatch);
      const int t = ok ? max(max(mm, up + gap), 0) : 0;
      total = max(total, t - k * gap);
    }
    // the prefix of the lanes below: an inclusive scan, shifted one lane
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = max(incl, y);
    }
    int g = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) g = kNeg;
    // ins of slot k0: slot k0-1's new H (G-space g), -inf at slot 0
    int ins = kNeg;
    if (k0 > 0) ins = (valid(i, k0 - 1) ? g + (k0 - 1) * gap : 0) + gap;
    // pass 2: finish the row, its codes and the running best, in place
    // (slot s+1's old H is still there when slot s reads it)
#pragma unroll
    for (int s = 0; s < ns; ++s) {
      const int k = k0 + s;
      const bool ok = valid(i, k);
      const int up = k + 1 >= K8 ? kNeg : s + 1 < ns ? sl.H(s + 1) : up_next;
      const bool eq = ok && rp[i - band + k - 1] == qc;
      const int mm = sl.H(s) + (eq ? match : mismatch);
      const int dele = up + gap;
      const int t = ok ? max(max(mm, dele), 0) : 0;
      g = max(g, t - k * gap);
      const int val = ok ? g + k * gap : 0;
      if (kDirs) {
        uint32_t code = eq ? kDiagMatch : kDiagMismatch;
        if (ins >= mm) code = kQueryInsertion;
        if (dele >= max(mm, ins)) code = kQueryDeletion;
        sl.Acc(s) = (r == 0 ? 0u : sl.Acc(s)) | (code << (2 * r));
      }
      if (ok && val > best) {
        best = val;
        best_i = i;
        best_j = i - band + k;
      }
      sl.H(s) = val;
      ins = val + gap;
    }
    if (kDirs && (r == kRowsPerWord - 1 || i == ql)) {
      uint32_t* out =
          dirs + (static_cast<size_t>((i - 1) / kRowsPerWord) * B + b) * K8 +
          k0;
#pragma unroll
      for (int s = 0; s < ns; ++s) {
        if (k0 + s < K8) out[s] = sl.Acc(s);
      }
    }
  }
  // the largest value, then the smallest i, then the smallest j
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ob = __shfl_xor_sync(kFull, best, o);
    const int oi = __shfl_xor_sync(kFull, best_i, o);
    const int oj = __shfl_xor_sync(kFull, best_j, o);
    if (ob > best ||
        (ob == best && (oi < best_i || (oi == best_i && oj < best_j)))) {
      best = ob;
      best_i = oi;
      best_j = oj;
    }
  }
  if (lane == 0) {
    score[b] = best;
    srow[b] = best_i;
    scol[b] = best_j;
  }
}

struct FillArgs {
  const uint8_t* rf;
  const uint8_t* qr;
  const int32_t* rl;
  const int32_t* ql;
  int B, N, M, K8, band, S, match, mismatch, gap;
  int32_t* sc;
  int32_t* sr;
  int32_t* cc;
  uint32_t* dr;
  int32_t* scr;
};

template <int kS, bool kDirs>
cudaError_t launch(cudaStream_t st, const FillArgs& a) {
  auto kernel = banded_fill_kernel<kS, kDirs>;
  const int warps = kS != 0 ? kWarps : 1;
  const size_t smem =
      kS != 0 ? 0 : static_cast<size_t>(warps) * 2 * 32 * a.S * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.B + warps - 1) / warps);
  kernel<<<grid, warps * 32, smem, st>>>(
      a.rf, a.qr, a.rl, a.ql, a.B, a.N, a.M, a.K8, a.band, a.S, a.match,
      a.mismatch, a.gap, a.sc, a.sr, a.cc, a.dr, a.scr);
  return cudaGetLastError();
}

template <bool kDirs>
cudaError_t dispatch(cudaStream_t st, const FillArgs& a) {
  switch (a.S) {
    case 1: return launch<1, kDirs>(st, a);
    case 2: return launch<2, kDirs>(st, a);
    case 4: return launch<4, kDirs>(st, a);
    case 8: return launch<8, kDirs>(st, a);
    default:
      return in_global(a.S) ? launch<-1, kDirs>(st, a)
                            : launch<0, kDirs>(st, a);
  }
}

// S: the least power of two with 32*S >= K8, or ceil(K8/32) past 8
int slots_per_lane(int K8) {
  int S = 1;
  while (32 * S < K8 && S < kMaxRegSlots) S *= 2;
  if (32 * S < K8) S = (K8 + 31) / 32;
  return S;
}

}  // namespace

// The int32 words of global scratch a launch of B pairs over K8 slots
// needs: 0 while a lane's slots fit registers or one warp's shared memory
// (K8 <= 29,056), else B * 2 * 32 * S.
extern "C" long long ta_torch_banded_scratch_words(int B, int K8) {
  const int S = slots_per_lane(K8);
  return in_global(S) ? static_cast<long long>(B) * 2 * 32 * S : 0;
}

// K8 = max(round8(2*band), 8) slots; scratch holds
// ta_torch_banded_scratch_words(B, K8) words (null when that is 0).
extern "C" int ta_torch_banded_fill(
    const void* ref, const void* qry, const void* ref_len,
    const void* qry_len, int B, int N, int M, int K8, int band, int match,
    int mismatch, int gap, int with_dirs, void* score, void* srow,
    void* scol, void* dirs, void* scratch, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (band < 1 || K8 < 8 || K8 % 8 != 0 || K8 < 2 * band) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int S = slots_per_lane(K8);
  if (in_global(S) && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FillArgs a{
      static_cast<const uint8_t*>(ref), static_cast<const uint8_t*>(qry),
      static_cast<const int32_t*>(ref_len),
      static_cast<const int32_t*>(qry_len),
      B, N, M, K8, band, S, match, mismatch, gap,
      static_cast<int32_t*>(score), static_cast<int32_t*>(srow),
      static_cast<int32_t*>(scol), static_cast<uint32_t*>(dirs),
      static_cast<int32_t*>(scratch)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = with_dirs ? dispatch<true>(st, a)
                                  : dispatch<false>(st, a);
  return static_cast<int>(e);
}
