// Repair insertion-point search of the pairwise device forest.
//
//   y[r] = max{ j in [q[r] - wrv, q[r]) : j >= 0, lcp[j] < thr[r] }, or -1.
//
// Replaces the Pallas TPU kernel reveal_tpu/index/devloop.py:
// _make_window_resolve (inner `kernel`), which fetched each window as
// wrv/128+1 aligned 128-lane row blocks by DMA.  Here one block of
// threads serves one candidate r with block_last_below
// (window_resolve.cuh, the search repair_pass.cu runs too): thread t
// tests j = q[r]-1-t, a chunk of blockDim slots at a time from the top,
// neighbouring threads read neighbouring LCP words, and the block
// max-reduces j with __reduce_max_sync per warp and then shared memory
// across warps.
//
// Bound: neither bandwidth nor arithmetic.  One call reads
// rbv * wrv * 4 bytes (1 MiB at rbv = 1024, wrv = 256) and does one
// compare per word, so the call costs about one kernel launch.  The
// repair pass of the pairwise forest no longer calls it (repair_pass.cu
// searches inside its own kernel); it is kept for the batched rounds of
// the multi-genome loop.
//
// Any npad >= 1: j is also masked against npad (the TPU kernel's
// npad % 128 == 0 and npad >= 384 were layout artefacts).  Launches on
// the caller's stream, allocates nothing, does not synchronise; returns
// cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_runtime.h>

#include "window_resolve.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_resolve_kernel(const int* __restrict__ lcp, int npad,
                      const int* __restrict__ q, const int* __restrict__ thr,
                      int* __restrict__ out, int wrv) {
  __shared__ int scratch[64];
  const int r = blockIdx.x;
  const int qr = q[r];
  const int lo = qr > wrv ? qr - wrv : 0;
  const int hi = qr < npad ? qr : npad;
  const int y = block_last_below(lcp, lo, hi, thr[r], scratch);
  if (threadIdx.x == 0) out[r] = y;
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
