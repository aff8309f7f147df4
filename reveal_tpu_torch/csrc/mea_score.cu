// The MEA-score row scan of a batch of dense posteriors.
//
// For each pair b of p (B, L1p, L2p) float32 the kernel runs, over rows
// r = 1..nrows, the recurrence of the expected-accuracy alignment score
// (DoAlign, probcons/Probcons.cc:384-400):
//
//   c[j]   = max(p[r, j] + old[j-1], old[j])   for j = 1..L2p-1,
//   new[0] = 0,  new[j] = max(c[1..j]),
//
// from old = 0, and writes old[L2p-1] of the last row.  It is the cut's
// row scan of reveal_tpu_torch/hmm/pairhmm.py (the port of the JAX
// chain's lax.scan of cummax, reveal_tpu/hmm/msa.py:600-615, XLA-level
// code with no Pallas kernel), which launched about four small torch
// operations a row; mea_score_plain in hmm/mea_score.py is that loop.
// The arithmetic is one float32 add a cell and maxima, and a maximum is
// exact in any order, so the kernel gives the plain loop's bits for any
// finite input: the running maximum starts from -inf, not from new[0].
//
// Design: one block a pair, the row loop inside the kernel.  The row
// state is two buffers of L2p floats in shared memory (dynamic, up to
// 227 KB: L2p up to 29,040), read from one and written to the other in
// turns.  A thread owns a chunk of 4 * K4 consecutive columns (float4
// loads and stores; at most 512 threads a block), computes its c and
// their running maximum, and the block scans the chunks' maxima (warp
// shuffles, then the maxima of the warps before it from shared memory):
// two barriers a row.  The thread's slice of the next row of p is loaded
// into registers while the current row is scanned.
//
// Bound: every row is a chain of dependent steps (the block scan and two
// barriers) on one SM, so one pair takes nrows such steps whatever its
// width; the bytes (the grid read once) bound a launch only when many
// more pairs than SMs are resident.  Rows of p beyond a pair's length
// are zero and leave the state unchanged, as in the plain loop.
//
// Launches on the caller's stream, allocates nothing, does not
// synchronise; returns cudaGetLastError() (cudaErrorInvalidValue for a
// shape it does not take).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxK4 = 16;
constexpr int kSharedLimit = 232448;  // bytes of shared memory a block

__device__ __forceinline__ float4 ld4(const float* ptr) {
  return __ldg(reinterpret_cast<const float4*>(ptr));
}

template <int K4>
__global__ void __launch_bounds__(kMaxThreads)
mea_score_kernel(const float* __restrict__ p, float* __restrict__ out,
                 int L1p, int L2p, int nrows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* bufa = smem;
  float* bufb = smem + L2p;
  float* wmax = smem + 2 * L2p;  // one maximum a warp
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int W4 = L2p >> 2;       // float4s a row
  const int q0 = t * K4;         // this thread's first float4
  const float* pb = p + (size_t)blockIdx.x * L1p * L2p;

  for (int j = t; j < L2p; j += blockDim.x) bufa[j] = 0.f;

  float4 nxt[K4];
  if (nrows >= 1) {
#pragma unroll
    for (int q = 0; q < K4; ++q)
      if (q0 + q < W4) nxt[q] = ld4(pb + (size_t)L2p + 4 * (q0 + q));
  }
  __syncthreads();

  float* oldb = bufa;
  float* newb = bufb;
  for (int r = 1; r <= nrows; ++r) {
    float4 cur[K4];
#pragma unroll
    for (int q = 0; q < K4; ++q) cur[q] = nxt[q];
    if (r < nrows) {
      const float* row = pb + (size_t)(r + 1) * L2p;
#pragma unroll
      for (int q = 0; q < K4; ++q)
        if (q0 + q < W4) nxt[q] = ld4(row + 4 * (q0 + q));
    }

    // c and the running maximum over this thread's chunk, into newb
    float prev = q0 > 0 && q0 < W4 ? oldb[4 * q0 - 1] : 0.f;
    float run = -INFINITY;
    const float4* old4 = reinterpret_cast<const float4*>(oldb);
    float4* new4 = reinterpret_cast<float4*>(newb);
#pragma unroll
    for (int q = 0; q < K4; ++q) {
      const int j4 = q0 + q;
      if (j4 < W4) {
        const float4 o = old4[j4];
        const float4 v = cur[q];
        float4 w;
        run = fmaxf(run, j4 == 0 ? -INFINITY : fmaxf(v.x + prev, o.x));
        w.x = run;
        run = fmaxf(run, fmaxf(v.y + o.x, o.y));
        w.y = run;
        run = fmaxf(run, fmaxf(v.z + o.y, o.z));
        w.z = run;
        run = fmaxf(run, fmaxf(v.w + o.z, o.w));
        w.w = run;
        prev = o.w;
        new4[j4] = w;
      }
    }

    // the maximum of the chunks before this one: warp scan, then the
    // warps before this one
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = fmaxf(incl, y);
    }
    float ex = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) ex = -INFINITY;
    if (lane == 31) wmax[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) ex = fmaxf(ex, wmax[w]);

#pragma unroll
    for (int q = 0; q < K4; ++q) {
      const int j4 = q0 + q;
      if (j4 < W4) {
        float4 w = new4[j4];
        w.x = j4 == 0 ? 0.f : fmaxf(ex, w.x);
        w.y = fmaxf(ex, w.y);
        w.z = fmaxf(ex, w.z);
        w.w = fmaxf(ex, w.w);
        new4[j4] = w;
      }
    }
    __syncthreads();
    float* tmp = oldb;
    oldb = newb;
    newb = tmp;
  }
  if (t == 0) out[blockIdx.x] = oldb[L2p - 1];
}

template <int K4>
int launch(const float* p, float* out, int B, int L1p, int L2p, int nrows,
           int threads, cudaStream_t st) {
  const int smem = (2 * L2p + 32) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mea_score_kernel<K4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  mea_score_kernel<K4><<<B, threads, smem, st>>>(p, out, L1p, L2p, nrows);
  return (int)cudaGetLastError();
}

}  // namespace

// Threads a block and float4s a thread for rows of L2p columns, as
// hmm/mea_score.py's plan reckons them: K4 the power of two that keeps
// the block at most 512 threads, the threads a multiple of 32 that
// covers the row.  Returns 0 for a width the kernel does not take.
extern "C" int rtt_mea_score_plan(int L2p, int* threads, int* k4) {
  if (L2p < 4 || (L2p & 3) || (2 * L2p + 32) * 4 > kSharedLimit) return 0;
  const int w4 = L2p >> 2;
  int k = 1;
  while (k * kMaxThreads < w4) k <<= 1;
  if (k > kMaxK4) return 0;
  const int t = ((w4 + k - 1) / k + 31) / 32 * 32;
  *threads = t;
  *k4 = k;
  return 1;
}

// p: (B, L1p, L2p) float32, contiguous, 16-byte aligned; out: (B,)
// float32; rows 1..nrows are scanned (nrows <= L1p - 1).
extern "C" int rtt_mea_score_f32(const void* p, void* out, int B, int L1p,
                                 int L2p, int nrows, void* stream) {
  int threads = 0, k4 = 0;
  if (B < 1 || nrows < 0 || nrows >= L1p ||
      !rtt_mea_score_plan(L2p, &threads, &k4) ||
      ((uintptr_t)p & 15))
    return (int)cudaErrorInvalidValue;
  const float* pf = (const float*)p;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k4) {
    case 1: return launch<1>(pf, of, B, L1p, L2p, nrows, threads, st);
    case 2: return launch<2>(pf, of, B, L1p, L2p, nrows, threads, st);
    case 4: return launch<4>(pf, of, B, L1p, L2p, nrows, threads, st);
    case 8: return launch<8>(pf, of, B, L1p, L2p, nrows, threads, st);
    case 16: return launch<16>(pf, of, B, L1p, L2p, nrows, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}
