// One whole boundary-repair pass of the pairwise device forest in one
// launch.
//
// Replaces, on the card, the host loop of batched repair rounds of
// reveal_tpu_torch/index/devloop.py (repair_rounds_plain), the port of
// the JAX kernel's `rbody` (reveal_tpu/index/devloop.py, `vec_branch`
// and `seq_branch`), whose insertion-point search is the Pallas TPU
// kernel _make_window_resolve (window_resolve.cu on this card).  The TPU
// resolves batches of candidates because it cannot run a serial search
// cheaply; the batched rounds reduce to "each segment's candidates in
// ascending slot order, each against the state its predecessors left",
// and that is what this kernel runs:
//
//  - a candidate's insertion point lies inside its own segment (the
//    segment's first slot has LCP 0 and a mover's threshold is > 0), and
//    its LCP[q+1] update at a segment's last slot is a no-op (the next
//    slot is a segment start, LCP 0), so segments are independent;
//  - within a segment the order is all that makes the result exact, so a
//    segment's candidates run one after another in one block.
//
// Blocks take tickets j = 0, 1, ... over the candidates; a block whose
// ticket starts a run of equal SEG[cq[j]] applies that whole run, and a
// block whose ticket is past the last candidate exits.  Per candidate q
// (the whole block, 256 threads):
//
//   b = beg[q], saq = SA[q], lcq = LCP[q], thr = b - saq,
//   move = saq < b && saq + lcq > b;
//   mover: x = max{y < q : LCP[y] < thr} (0 if none) by
//          block_last_below (window_resolve.cuh), no window cap; rotate
//          (x, q] right by one in SA, BWT and LCP a chunk of 256 slots at
//          a time from the top (read, barrier, write); SA[x] = saq,
//          BWT[x] = BWT[q] (read before the rotation), LCP[x+1] = thr;
//   then LCP[q+1] as devloop.apply_one sets it; a non-mover's branch
//   reads centry_next[j], LCP[q+1] at the start of the pass.
//
// Bound: the pass moves sum(q - x) slots of three int32 arrays (read and
// written once: 24 bytes a slot) and searches as many LCP words, a few
// MB at most, microseconds at 3.35 TB/s; but the longest run is a chain
// of dependent steps, each a few barriers and global round trips, so the
// pass is bound by that chain's latency, not by bytes.  The design keeps
// the pass to one launch and no host sync; runs of different segments go
// on in parallel in the blocks of the grid.
//
// Counters (stats, int64, accumulated over the launches of a dispatch):
// [0] candidates applied, [1] the longest run in one block, [2] the sum
// of q - x over the movers.  `ticket` is one int32, zero at the launch.
// Launches on the caller's stream, allocates nothing, does not
// synchronise; returns cudaGetLastError() so a refused launch is
// reported to the caller.

#include <cuda_runtime.h>

#include "window_resolve.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
repair_pass_kernel(int* sa, int* lcp, int* bwt,
                   const int* __restrict__ seg, const int* __restrict__ beg,
                   const int* __restrict__ cq,
                   const int* __restrict__ centry_next,
                   const int* __restrict__ rc, int* ticket,
                   unsigned long long* stats, int npad, int ccap) {
  __shared__ int scratch[64];
  __shared__ int run_start;
  const int n = min(*rc, ccap);
  for (;;) {
    if (threadIdx.x == 0) {
      int start = -1;
      for (int j = atomicAdd(ticket, 1); j < n; j = atomicAdd(ticket, 1)) {
        if (j == 0 || seg[cq[j]] != seg[cq[j - 1]]) {
          start = j;
          break;
        }
      }
      run_start = start;
    }
    __syncthreads();
    const int start = run_start;
    __syncthreads();
    if (start < 0) return;

    const int sid = seg[cq[start]];
    long long moved = 0;
    int j = start;
    for (; j < n; ++j) {
      const int q = cq[j];
      if (j > start && seg[q] != sid) break;
      const int b = beg[q];
      const int saq = sa[q];
      const int lcq = lcp[q];
      const int thr = b - saq;
      const bool move = saq < b && saq + lcq > b;
      if (move) {
        const int x = max(block_last_below(lcp, 0, q, thr, scratch), 0);
        const int bwq = bwt[q];
        for (int top = q; top > x; top -= kThreads) {
          const int d = top - static_cast<int>(threadIdx.x);
          int s = 0, w = 0, l = 0;
          if (d > x) {
            s = sa[d - 1];
            w = bwt[d - 1];
            l = lcp[d - 1];
          }
          __syncthreads();
          if (d > x) {
            sa[d] = s;
            bwt[d] = w;
            lcp[d] = l;
          }
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          sa[x] = saq;
          bwt[x] = bwq;
          lcp[x + 1] = thr;
        }
        moved += q - x;
      }
      if (threadIdx.x == 0) {
        const int qn = min(q + 1, npad - 1);
        const int lcp_qn = lcp[qn];
        if (move && q < npad - 1 && lcq < lcp_qn) {
          lcp[qn] = lcq;
        } else if (!move && q < npad - 1 && saq < b &&
                   saq + centry_next[j] > b && lcp_qn > lcp[q]) {
          lcp[qn] = b - saq;
        }
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const unsigned long long len = j - start;
      atomicAdd(&stats[0], len);
      atomicMax(&stats[1], len);
      atomicAdd(&stats[2], static_cast<unsigned long long>(moved));
    }
  }
}

}  // namespace

extern "C" int rtt_repair_pass_i32(void* sa, void* lcp, void* bwt,
                                   const void* seg, const void* beg,
                                   const void* cq, const void* centry_next,
                                   const void* rc, void* ticket, void* stats,
                                   int npad, int ccap, int grid,
                                   void* stream) {
  if (grid > 0 && ccap > 0) {
    repair_pass_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(sa), static_cast<int*>(lcp),
        static_cast<int*>(bwt), static_cast<const int*>(seg),
        static_cast<const int*>(beg), static_cast<const int*>(cq),
        static_cast<const int*>(centry_next), static_cast<const int*>(rc),
        static_cast<int*>(ticket),
        static_cast<unsigned long long*>(stats), npad, ccap);
  }
  return static_cast<int>(cudaGetLastError());
}
