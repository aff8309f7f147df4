// The repair insertion-point search, shared by window_resolve.cu (a
// window of wrv slots a candidate) and repair_pass.cu (the whole array
// below the candidate, one candidate after another).
//
//   block_last_below(lcp, lo, hi, thr) = max{ j in [lo, hi) : lcp[j] < thr }
//                                        or -1.
//
// The whole block scans down from hi, blockDim.x slots at a time (thread
// t tests j = top - 1 - t, so neighbouring threads read neighbouring
// words), reduces each chunk's largest hit with __reduce_max_sync per
// warp and then across warps through shared memory, and stops at the
// first chunk that holds a hit: that hit is the largest j.  Every thread
// of the block calls it with the same arguments and gets the same result.
//
// `scratch` is 64 ints of shared memory, used in turns by two successive
// chunks, so a chunk costs one __syncthreads(); the caller separates two
// calls by a __syncthreads() of its own.  blockDim.x is a multiple of 32
// and at most 1024.  `lcp` is read with plain loads (no __restrict__, no
// read-only cache): repair_pass.cu writes it between two calls.

#pragma once

__device__ __forceinline__ int block_last_below(const int* lcp, int lo,
                                                int hi, int thr,
                                                int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int step = blockDim.x;
  int* turn = scratch;
  for (int top = hi; top > lo; top -= step) {
    const int j = top - 1 - static_cast<int>(threadIdx.x);
    int best = (j >= lo && lcp[j] < thr) ? j : -1;
    best = __reduce_max_sync(0xffffffffu, best);
    if (lane == 0) turn[warp] = best;
    __syncthreads();
    int v = lane < nwarps ? turn[lane] : -1;
    v = __reduce_max_sync(0xffffffffu, v);
    if (v >= 0) return v;
    turn = (turn == scratch) ? scratch + 32 : scratch;
  }
  return -1;
}
