// Repair insertion-point search of the pairwise device forest.
//
//   y[r] = max{ j in [q[r] - wrv, q[r]) : j >= 0, lcp[j] < thr[r] }, or -1.
//
// Replaces the Pallas TPU kernel reveal_tpu/index/devloop.py:
// _make_window_resolve (inner `kernel`), which fetched each window as
// wrv/128+1 aligned 128-lane row blocks by DMA.  Here one block of
// threads serves one candidate r: thread t tests j = q[r]-1-t (striding
// by blockDim when wrv > blockDim), neighbouring threads read neighbouring
// LCP words, and the block max-reduces j with __reduce_max_sync per warp
// and then shared memory across warps.
//
// Bound: neither bandwidth nor arithmetic.  One repair round reads
// rbv * wrv * 4 bytes (1 MiB at rbv = 1024, wrv = 256) and does one
// compare per word, so the call costs about one kernel launch; the
// design keeps it to exactly one launch per round and no host sync.
//
// Any npad >= 1: j is also masked against npad (the TPU kernel's
// npad % 128 == 0 and npad >= 384 were layout artefacts).  Launches on
// the caller's stream, allocates nothing, does not synchronise; returns
// cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_resolve_kernel(const int* __restrict__ lcp, int npad,
                      const int* __restrict__ q, const int* __restrict__ thr,
                      int* __restrict__ out, int wrv) {
  __shared__ int warp_max[kThreads / 32];
  const int r = blockIdx.x;
  const int qr = q[r];
  const int tr = thr[r];
  int best = -1;
  for (int k = threadIdx.x; k < wrv; k += blockDim.x) {
    const int j = qr - 1 - k;
    if (j >= 0 && j < npad && lcp[j] < tr) best = max(best, j);
  }
  best = __reduce_max_sync(0xffffffffu, best);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_max[warp] = best;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    int v = threadIdx.x < nwarps ? warp_max[threadIdx.x] : -1;
    v = __reduce_max_sync(0xffffffffu, v);
    if (threadIdx.x == 0) out[r] = v;
  }
}

}  // namespace

extern "C" int rtt_window_resolve_i32(const void* lcp, int npad,
                                      const void* q, const void* thr,
                                      void* out, int rbv, int wrv,
                                      void* stream) {
  if (rbv > 0) {
    window_resolve_kernel<<<rbv, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lcp), npad, static_cast<const int*>(q),
        static_cast<const int*>(thr), static_cast<int*>(out), wrv);
  }
  return static_cast<int>(cudaGetLastError());
}
