// The score pass of the multi loop's sum-of-pairs chain DP, one launch a
// level.
//
// For every live segment row r of the level's (R, W + 1) planes and every
// column j < W, in order (index/chain_score.py, chain_scores_plain):
//
//   mx = max over i < j of (compat(i, j) ? score[i] - wp * pen(i, j) : NEG)
//        (NEG at j = 0),
//   compat = dalb[r, i] && all_d(dS[d, r, j] - dE[d, r, i] >= 0),
//   pen = sum over path pairs p = (a, b) with hbp[p, r] of
//         |delta_a - delta_b|, delta_d = dS[d, r, j] - dE[d, r, i],
//   score[r, j] = dalb[r, j] ? max(dwl[r, j], mx > NEG // 2
//                                  ? mx + dL[r, j] * mulr[r] : NEG) : NEG,
//
// and the pseudo column W stays NEG.  Every sum, difference and product
// wraps as torch's int32 does: the kernel computes in unsigned and casts
// back.  NEG // 2 is Python's floor division, -1,073,741,824.  A maximum
// is exact in any order, so the kernel gives the plain loop's bits for
// any input.
//
// It replaces no Pallas kernel: the JAX chain (reveal_tpu/index/
// devloop.py, _build_kernel_multi) is XLA-level code.  It was added
// because the card showed the torch loop is the cost: one Python step a
// column, about 20 launches a step, 95% of chain_dense_multi's launches
// and about 2.3-2.5 s of a 2.64 s multi.chain on the 6 x 80 kbp panel
// (NVIDIA H100 80GB HBM3).
//
// Design: one block a segment row, the column loop inside the block.
// The row's scores, its dE columns and its live flags sit in dynamic
// shared memory when (1 + D) * (W + 1) words and W + 1 bytes fit in the
// SM's 227 KB (W up to about 6,200 at D = 8); otherwise the block works
// on the output row and the planes in device memory, for any W.  A row
// walks its columns up to its last live one.  Per column the block's
// threads stride over i < j (thread t owns the columns i = t mod B, so
// the score it reads is one it wrote itself), a warp max
// (__reduce_max_sync) goes to one of two slot arrays in turn, and after
// one barrier every thread takes the maximum of the warps' slots; the
// owner of column j writes score[j].  One barrier a live column.
//
// Bound: the column loop is a chain of dependent steps.  The widest row
// takes one step a live column, each a block reduction and a barrier on
// one SM (about 250 clocks at 1.98 GHz, published latencies, not
// measured: the panel root's 1,322 steps about 0.17 ms).  The work is
// 2D + 1 integer operations for each pair i < j of live columns of a
// row, 2 more for a compatible pair and 4 for each path pair present in
// it, over 132 SMs x 64 int32 lanes a clock; a row is one block, so a
// level of few rows (the root is one) counts against one SM's lanes.
// chip_smoke.py reckons both floors per level.
//
// Launches on the caller's stream, allocates nothing, does not
// synchronise; returns cudaGetLastError() (cudaErrorInvalidValue for a
// shape it does not take).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -2147483647;       // devloop.NEG = -(2^31) + 1
constexpr int kNegHalf = -1073741824;   // NEG // 2 (floor), not NEG / 2
constexpr int kMaxThreads = 512;
constexpr int kSlots = kMaxThreads / 32;
constexpr int kSharedLimit = 232448;    // bytes of shared memory a block

__device__ __forceinline__ unsigned uabs(unsigned x) {
  return (int)x < 0 ? 0u - x : x;
}

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
chain_score_kernel(const int* __restrict__ dS, const int* __restrict__ dE,
                   const unsigned char* __restrict__ dalb,
                   const int* __restrict__ dL, const int* __restrict__ dwl,
                   const int* __restrict__ mulr,
                   const unsigned char* __restrict__ hbp,
                   const int64_t* __restrict__ ia,
                   const int64_t* __restrict__ ib, int* __restrict__ score,
                   int R, int W, int npair, int wp, int on_chip) {
  extern __shared__ int smem[];
  int* slots = smem;                      // 2 x kSlots warp maxima
  const int r = blockIdx.x;
  const int W1 = W + 1;
  const int B = blockDim.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = B >> 5;
  const size_t row = (size_t)r * W1;
  const size_t plane = (size_t)R * W1;

  int* sc;
  const int* E;
  const unsigned char* alb;
  size_t es;
  if (on_chip) {
    int* s = smem + 2 * kSlots;
    int* e = s + W1;
    unsigned char* a = reinterpret_cast<unsigned char*>(e + (size_t)D * W1);
    for (int i = t; i < W1; i += B) {
#pragma unroll
      for (int d = 0; d < D; ++d) e[d * W1 + i] = dE[d * plane + row + i];
      a[i] = dalb[row + i];
    }
    sc = s;
    E = e;
    alb = a;
    es = W1;
  } else {
    sc = score + row;
    E = dE + row;
    alb = dalb + row;
    es = plane;
  }

  // the row's path pairs as bits a * 8 + b, and its last live column
  uint64_t pm = 0;
  for (int p = 0; p < npair; ++p)
    if (hbp[(size_t)p * R + r]) {
      const int a = (int)ia[p], b = (int)ib[p];
      pm |= 1ull << (a < b ? a * 8 + b : b * 8 + a);
    }
  int last = -1;
  for (int i = t; i < W; i += B)
    if (dalb[row + i]) last = i;
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) slots[kSlots + warp] = last;
  __syncthreads();
  int n = -1;
  for (int w = 0; w < nwarps; ++w) n = max(n, slots[kSlots + w]);
  n += 1;

  const unsigned wpu = (unsigned)wp;
  const unsigned mul = (unsigned)mulr[r];
  int par = 0;
  for (int j = 0; j < n; ++j) {
    if (!alb[j]) {                        // the same branch in every thread
      if (j % B == t) sc[j] = kNeg;
      continue;
    }
    unsigned s[D];
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] = (unsigned)dS[d * plane + row + j];
    int m = INT_MIN;
    for (int i = t; i < j; i += B) {
      int v = kNeg;
      if (alb[i]) {
        unsigned dl[D];
        bool ok = true;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dl[d] = s[d] - (unsigned)E[d * es + i];
          ok = ok && (int)dl[d] >= 0;
        }
        if (ok) {
          unsigned pen = 0;
#pragma unroll
          for (int a = 0; a < D; ++a)
#pragma unroll
            for (int b = a + 1; b < D; ++b)
              if ((pm >> (a * 8 + b)) & 1) pen += uabs(dl[a] - dl[b]);
          v = (int)((unsigned)sc[i] - wpu * pen);
        }
      }
      m = max(m, v);
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) slots[par * kSlots + warp] = m;
    __syncthreads();
    if (j % B == t) {
      int mx = INT_MIN;
      for (int w = 0; w < nwarps; ++w) mx = max(mx, slots[par * kSlots + w]);
      const int link = mx > kNegHalf
          ? (int)((unsigned)mx + (unsigned)dL[row + j] * mul) : kNeg;
      sc[j] = max(dwl[row + j], link);
    }
    par ^= 1;
  }

  // every thread writes the columns it owns: its scores, NEG past the walk
  for (int i = t; i < W1; i += B)
    if (on_chip || i >= n) score[row + i] = i < n ? sc[i] : kNeg;
}

size_t shared_bytes(int D, int W1, bool on_chip) {
  size_t b = 2 * kSlots * sizeof(int);
  if (on_chip) b += (size_t)(1 + D) * W1 * sizeof(int) + W1;
  return b;
}

template <int D>
int launch(const int* dS, const int* dE, const unsigned char* dalb,
           const int* dL, const int* dwl, const int* mulr,
           const unsigned char* hbp, const int64_t* ia, const int64_t* ib,
           int* score, int R, int W, int npair, int wp, int threads,
           cudaStream_t st) {
  static size_t opted = 48 * 1024;        // dynamic shared memory allowed
  const bool on_chip = shared_bytes(D, W + 1, true) <= kSharedLimit;
  const size_t smem = shared_bytes(D, W + 1, on_chip);
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        chain_score_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  chain_score_kernel<D><<<R, threads, smem, st>>>(
      dS, dE, dalb, dL, dwl, mulr, hbp, ia, ib, score, R, W, npair, wp,
      on_chip ? 1 : 0);
  return (int)cudaGetLastError();
}

// Threads a block for rows of W columns: a multiple of 32 that gives a
// thread at most two earlier columns a step up to W = 1,024, at most 512.
int threads_for(int W) {
  const int t = ((W + 1) / 2 + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

}  // namespace

// Whether the level's rows take the shared-memory layout (1) or work in
// device memory (0).
extern "C" int rtt_chain_score_on_chip(int D, int W) {
  return shared_bytes(D, W + 1, true) <= kSharedLimit ? 1 : 0;
}

// dS, dE: (D, R, W + 1) int32; dalb: (R, W + 1) bool; dL, dwl: (R, W + 1)
// int32; mulr: (R,) int32; hbp: (npair, R) bool; ia, ib: (npair,) int64,
// the path pairs (a, b), a != b, each pair once; score: (R, W + 1) int32,
// written whole.  All contiguous.  2 <= D <= 8, R >= 1, W >= 1.
extern "C" int rtt_chain_score_multi_i32(
    const void* dS, const void* dE, const void* dalb, const void* dL,
    const void* dwl, const void* mulr, const void* hbp, const void* ia,
    const void* ib, void* score, int D, int R, int W, int npair, int wp,
    void* stream) {
  if (R < 1 || W < 1 || W >= INT_MAX / 9 || D < 2 || D > 8 || npair < 0 ||
      npair > D * (D - 1) / 2)
    return (int)cudaErrorInvalidValue;
  const int threads = threads_for(W);
  cudaStream_t st = (cudaStream_t)stream;
#define RTT_CHAIN_ARGS                                                     \
  (const int*)dS, (const int*)dE, (const unsigned char*)dalb,              \
      (const int*)dL, (const int*)dwl, (const int*)mulr,                   \
      (const unsigned char*)hbp, (const int64_t*)ia, (const int64_t*)ib,   \
      (int*)score, R, W, npair, wp, threads, st
  switch (D) {
    case 2: return launch<2>(RTT_CHAIN_ARGS);
    case 3: return launch<3>(RTT_CHAIN_ARGS);
    case 4: return launch<4>(RTT_CHAIN_ARGS);
    case 5: return launch<5>(RTT_CHAIN_ARGS);
    case 6: return launch<6>(RTT_CHAIN_ARGS);
    case 7: return launch<7>(RTT_CHAIN_ARGS);
    case 8: return launch<8>(RTT_CHAIN_ARGS);
  }
#undef RTT_CHAIN_ARGS
  return (int)cudaErrorInvalidValue;
}
