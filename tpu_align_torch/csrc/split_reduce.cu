// Hirschberg split reduction for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces tpu_align/traceback/hirschberg.py::_split_reduce_jit (an XLA
// program on the TPU, no Pallas): the combine that turns one split level's
// last rows into one split column per subproblem, so only 4 ints per
// subproblem cross to the host.  Bound to PyTorch through a plain C entry
// point loaded with ctypes (tpu_align_torch/kernels/_build.py).
//
// What it computes, for subproblem k with nn[k] reference columns, over
// the (n, 2K) last rows (problem 2k the forward top half, 2k+1 the
// reversed bottom half):
//   F(i) = fhb[k] if i == 0 else last[i-1, 2k]
//   B(j) = bhb[k] if j == 0 else last[min(j, n)-1, 2k+1]
//   tot[i] = F(i) + B(nn[k] - i) + extra   for i <= nn[k], else NEG = -2^30
// for i in 0..n, in int32 with two's-complement wraparound as XLA adds
// (an all-sentinel sum then agrees bit for bit), and returns the first
// index of the largest tot (np.argmax's tie rule) and that tot: row 0/1 of
// out (4, K) from hlast with extra = 0, rows 2/3 from flast with extra =
// -go[k] (ANW's bridged gap counts its open once), or copies of rows 0/1
// when flast is null.
//
// Bounds on this card (H100 SXM).  The work is two int32 loads and a few
// operations a (k, i <= nn[k]): bound by bytes.  At the 64 pairs' top
// level (64 subproblems x 16,384 columns, every row read, affine) the
// last rows are 2 x 8.4 MB, 5.0 us at 3.35 TB/s.  The shapes run from a
// few subproblems over long rows (the long pair's top level: K = 1) to
// thousands over short ones.  The design below reaches about two fifths
// of the bound a level (PERF.md): each launch's fixed cost is most of its
// time, and where widths differ the lanes' second rows scatter.
//
// Design: one launch a level, spread over the card whatever its shape.
//   - Pairs of rows.  With m = min(nn[k], n), a thread takes tot[p] and
//     tot[m - p] for p = 0 .. m/2.  When nn[k] <= n their F and B words
//     come from the same two rows, p - 1 and m - p - 1: both words of each
//     row, one sector, and half the steps (past n, B's rows are clipped to
//     the last, as the plain version reads them).  Entries i > nn[k] are
//     NEG, and the first of them, nn[k] + 1, is one candidate.
//   - A block's 256 threads are G lanes of subproblems (G = K up to 32, a
//     power of two) by R = 256 / G pairs.  Lane kl holds subproblem
//     group*G + kl, so a step reads G neighbouring word pairs of one row:
//     one coalesced segment (2G words).  Row m - p - 1 is the same across
//     the lanes when their widths agree (every subproblem of the top
//     level), else those loads scatter, a sector for two words.
//   - The grid is (chunks of p, groups of G subproblems, passes): enough
//     chunks for about two blocks an SM, a chunk R x iters pairs.  A thread
//     issues the loads of its iters (<= 8) pairs together, then keeps the
//     first best of them (first_better); the block reduces its R pairs a
//     subproblem through shared memory, and with one chunk writes out
//     directly.
//   - With more chunks, each block folds its best into one 64-bit key a
//     subproblem (atomicMax; the key orders by tot, then by the lower
//     index) and takes a ticket (atomicInc on a counter of its (pass,
//     group)); the last block to arrive decodes its group's keys into out
//     and sets them back to 0.  atomicInc wraps its counter back to 0, so
//     the state (keys and counters) stays zeroed between launches.
// The rules stay exact: the largest tot, then the lowest i; the sums in
// uint32; -go on the F pass; rows 2/3 copied when flast is null.
//
// The entry point launches on the caller's stream, never synchronises, and
// returns cudaGetLastError() so a refused launch reaches the wrapper.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 32;         // subproblems a block
constexpr int kMaxIters = 8;          // row pairs a thread, loaded together
constexpr int kBlocksWanted = 2 * 132;  // about two blocks an SM
constexpr int kNeg = -(1 << 30);      // hirschberg.py's neg: fill.NEG

__device__ __forceinline__ bool first_better(int v1, int i1, int v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// first_better as one unsigned order: tot's bits with the sign flipped
// above, the index's complement below (0 is below every key of an index
// < 2^31)
__device__ __forceinline__ unsigned long long key_of(int v, int i) {
  return static_cast<unsigned long long>(static_cast<uint32_t>(v) ^
                                         0x80000000u) << 32 |
         ~static_cast<uint32_t>(i);
}

struct Shape {
  int n, K2, K;
  int G;       // subproblem lanes a block (a power of two, <= 32)
  int R;       // row pairs a block step: kThreads / G
  int iters;   // row pairs a thread (<= kMaxIters)
  int chunk;   // row pairs a chunk: R * iters
  int chunks;  // chunks a (pass, group)
  int groups;  // ceil(K / G)
};

// The block's (bv, bi) of each lane kl (threads rr == 0 hold them after):
// a tree over the R rows through shared memory.
__device__ __forceinline__ void block_reduce(int& bv, int& bi, int G, int R,
                                             int* sv, int* si) {
  const int t = threadIdx.x;
  sv[t] = bv;
  si[t] = bi;
  __syncthreads();
  for (int s = R / 2; s > 0; s >>= 1) {
    if (t < s * G) {
      const int v = sv[t + s * G], i = si[t + s * G];
      if (first_better(v, i, bv, bi)) {
        bv = v;
        bi = i;
        sv[t] = v;
        si[t] = i;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
split_reduce_kernel(const int32_t* __restrict__ hlast,  // (n, K2)
                    const int32_t* __restrict__ flast,  // (n, K2) or null
                    const int32_t* __restrict__ fhb,    // (K,)
                    const int32_t* __restrict__ bhb,    // (K,)
                    const int32_t* __restrict__ nn,     // (K,)
                    const int32_t* __restrict__ go,     // (K,)
                    const Shape sh,
                    unsigned long long* __restrict__ keys,  // (passes, K)
                    unsigned* __restrict__ tickets,     // (passes, groups)
                    int32_t* __restrict__ out) {        // (4, K)
  __shared__ int sv[kThreads], si[kThreads];
  __shared__ bool last_block;
  const int pass = blockIdx.z;
  const int passes = gridDim.z;
  const int chunk = blockIdx.x;
  const int kl = threadIdx.x % sh.G;
  const int rr = threadIdx.x / sh.G;
  const int k = blockIdx.y * sh.G + kl;
  const bool live = k < sh.K;
  const int32_t* last = pass ? flast : hlast;

  int bv = INT_MIN, bi = INT_MAX;
  if (live) {
    const int w = nn[k];
    const int m = min(w, sh.n);
    const uint32_t extra = pass ? 0u - static_cast<uint32_t>(go[k]) : 0u;
    const int f0 = fhb[k], b0 = bhb[k];
    const int32_t* col = last + 2 * k;  // F at [r*K2], B at [r*K2 + 1]
    const int p0 = chunk * sh.chunk + rr;
    if (p0 == 0 && w < sh.n) {  // i = nn[k] + 1, the first NEG entry
      bv = kNeg;
      bi = max(w + 1, 0);
    }
    auto word = [&](int row, int odd, int border) {
      return row == 0 ? border
                      : col[static_cast<size_t>(row - 1) * sh.K2 + odd];
    };
    // every load of the thread's pairs first, so they are in flight
    // together (F of p and B of m - p share row p - 1, and the other two
    // row m - p - 1), then the sums
    int f1[kMaxIters], b1[kMaxIters], f2[kMaxIters], b2[kMaxIters];
#pragma unroll
    for (int t = 0; t < kMaxIters; ++t) {
      const int p = p0 + t * sh.R;
      const int i2 = m - p;
      f1[t] = b1[t] = f2[t] = b2[t] = 0;
      if (t < sh.iters && p <= i2) {
        f1[t] = word(p, 0, f0);
        b2[t] = word(min(w - i2, sh.n), 1, b0);
        f2[t] = word(i2, 0, f0);
        b1[t] = word(min(w - p, sh.n), 1, b0);
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxIters; ++t) {
      const int p = p0 + t * sh.R;
      const int i2 = m - p;
      if (t < sh.iters && p <= i2) {
        const int v1 = static_cast<int>(static_cast<uint32_t>(f1[t]) +
                                        static_cast<uint32_t>(b1[t]) + extra);
        const int v2 = static_cast<int>(static_cast<uint32_t>(f2[t]) +
                                        static_cast<uint32_t>(b2[t]) + extra);
        if (first_better(v1, p, bv, bi)) {
          bv = v1;
          bi = p;
        }
        if (first_better(v2, i2, bv, bi)) {
          bv = v2;
          bi = i2;
        }
      }
    }
  }
  block_reduce(bv, bi, sh.G, sh.R, sv, si);

  if (sh.chunks > 1) {
    // this chunk's best into the subproblem's key, then a ticket; the last
    // block of the (pass, group) decodes the keys
    unsigned long long* key = keys + static_cast<size_t>(pass) * sh.K + k;
    if (rr == 0 && live) atomicMax(key, key_of(bv, bi));
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned got =
          atomicInc(tickets + pass * sh.groups + blockIdx.y, sh.chunks - 1);
      last_block = got == static_cast<unsigned>(sh.chunks - 1);
    }
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    if (rr == 0 && live) {
      const unsigned long long best = __ldcg(key);
      *key = 0;
      bv = static_cast<int>(static_cast<uint32_t>(best >> 32) ^ 0x80000000u);
      bi = static_cast<int>(~static_cast<uint32_t>(best));
    }
  }
  if (rr == 0 && live) {
    out[(2 * pass) * sh.K + k] = bi;
    out[(2 * pass + 1) * sh.K + k] = bv;
    if (passes == 1) {
      out[2 * sh.K + k] = bi;
      out[3 * sh.K + k] = bv;
    }
  }
}

Shape shape_of(int n, int K2, int K, int passes) {
  Shape s{n, K2, K, 1, kThreads, 1, 0, 0, 0};
  while (s.G < K && s.G < kMaxGroup) s.G *= 2;
  s.R = kThreads / s.G;
  s.groups = (K + s.G - 1) / s.G;
  const int rows = n / 2 + 1;  // row pairs p = 0 .. n/2
  const int per = s.groups * passes;
  const int want = per >= kBlocksWanted ? 1 : (kBlocksWanted + per - 1) / per;
  const int steps = (rows + s.R - 1) / s.R;  // block steps over all pairs
  const int iters = (steps + want - 1) / want;
  s.iters = iters < kMaxIters ? iters : kMaxIters;
  s.chunk = s.R * s.iters;
  s.chunks = (rows + s.chunk - 1) / s.chunk;
  return s;
}

}  // namespace

// The int32 words of state a launch needs: 64-bit keys (passes, K), then
// ticket counters (passes, groups).  The state must be 0 before the first
// launch and is 0 again after each.
extern "C" long long ta_torch_split_reduce_state_words(int n, int K2, int K,
                                                       int affine) {
  const int passes = affine ? 2 : 1;
  const Shape s = shape_of(n, K2, K, passes);
  return 2LL * passes * K + static_cast<long long>(passes) * s.groups;
}

// hlast, flast (n, K2) int32 (flast may be null: LNW); fhb, bhb, nn, go
// (K,) int32 with 2K <= K2; out (4, K) int32; state holds
// ta_torch_split_reduce_state_words zeroed words, 8-byte aligned.
extern "C" int ta_torch_split_reduce(const void* hlast, const void* flast,
                                     const void* fhb, const void* bhb,
                                     const void* nn, const void* go, int n,
                                     int K2, int K, void* state, void* out,
                                     void* stream) {
  if (K <= 0) return static_cast<int>(cudaGetLastError());
  if (n < 0 || K2 < 2 * K || state == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int passes = flast != nullptr ? 2 : 1;
  const Shape s = shape_of(n, K2, K, passes);
  auto* keys = static_cast<unsigned long long*>(state);
  const dim3 grid(s.chunks, s.groups, passes);
  split_reduce_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hlast), static_cast<const int32_t*>(flast),
      static_cast<const int32_t*>(fhb), static_cast<const int32_t*>(bhb),
      static_cast<const int32_t*>(nn), static_cast<const int32_t*>(go), s,
      keys, reinterpret_cast<unsigned*>(keys + static_cast<size_t>(passes) * K),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
