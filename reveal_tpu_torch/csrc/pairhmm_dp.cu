// Pair-HMM forward and backward DP, one launch per direction and batch.
//
// Replaces the Pallas TPU kernels fwd_kernel and bwd_kernel of
// reveal_tpu/hmm/pallas_pairhmm.py (run_dp): the 5-state (M, Ix1, Iy1, Ix2,
// Iy2) log-space DP of B sequence pairs.  Only the semantics are kept.  The
// TPU version keeps the whole batch in VMEM and takes one grid step per DP
// row; here one thread block owns one pair, its threads split the columns
// into contiguous chunks of C, and the loop over rows runs inside the
// kernel, so a batch is one launch whatever its number of rows.
//
// Per row: M and Ix depend on the previous row only (elementwise, with a
// shift by one column for M).  Iy is the in-row recurrence
//     Z[j] = lse(a[j], Z[j-1] + c[j]),
// a composition of log-space affine maps (m, b): Z -> lse(b, Z + m) with
//     (m, b) o (m', b') = (m + m', lse(b', b + m')).
// Each thread folds its chunk, a block-wide scan (warp shuffles, then the
// warp totals through shared memory) gives each thread its incoming Z, and
// the thread replays its chunk.  The association order differs from the
// TPU kernel's doubling and from the plain torch version's, so results
// agree to float32 rounding, not bit for bit.
//
// The two live rows of the five states (2 x 5 x L2p floats) sit in dynamic
// shared memory when they fit (L2p <= 5632) and in a global scratch buffer,
// which the L2 cache holds, for wider rows; the code is the same.
//
// LOG_ZERO is -2e20, not -inf: lse5 returns it when its maximum is at or
// below half of it, lse2 needs no guard because LOG_ZERO + log 2 rounds
// back to LOG_ZERO in float32.  expf, logf and log1pf are the accurate
// versions (no -use_fast_math).
//
// Bound on this card: the special-function units.  A cell needs 9 exp and
// 5 log in each direction (the 5-way lse, two 2-way lse for the x inserts,
// two for the y recurrence; the seeds of the y inserts are selects, not
// lse) against 4 bytes written, so the exp/log rate, not the memory, is
// the floor; rows are sequential, so the launch also pays three block
// barriers per row.  The fold-scan-replay spends more than that floor: it
// evaluates the recurrence twice and composes maps across the block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -2e20f;
constexpr int NPAR = 102;  // init 5, trans 25, single 8, pair 64
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float lse2(float x, float y) {
  float m = fmaxf(x, y);
  return m + log1pf(expf(fminf(x, y) - m));
}

__device__ __forceinline__ float lse5(float a, float b, float c, float d,
                                      float e) {
  float m = fmaxf(fmaxf(fmaxf(fmaxf(a, b), c), d), e);
  if (m <= 0.5f * NEG) return NEG;
  float s = expf(a - m) + expf(b - m) + expf(c - m) + expf(d - m) +
            expf(e - m);
  return m + logf(s);
}

// Two affine maps side by side (the short and the long insert state).
struct Map2 {
  float m1, b1, m2, b2;
};

__device__ __forceinline__ Map2 identity_map() { return {0.f, NEG, 0.f, NEG}; }

// left o right: left covers the earlier columns.
__device__ __forceinline__ Map2 compose(const Map2& l, const Map2& r) {
  Map2 o;
  o.b1 = lse2(r.b1, l.b1 + r.m1);
  o.m1 = l.m1 + r.m1;
  o.b2 = lse2(r.b2, l.b2 + r.m2);
  o.m2 = l.m2 + r.m2;
  return o;
}

__device__ __forceinline__ Map2 shfl_up(const Map2& v, int d) {
  return {__shfl_up_sync(FULL, v.m1, d), __shfl_up_sync(FULL, v.b1, d),
          __shfl_up_sync(FULL, v.m2, d), __shfl_up_sync(FULL, v.b2, d)};
}

__device__ __forceinline__ Map2 shfl_idx(const Map2& v, int src) {
  return {__shfl_sync(FULL, v.m1, src), __shfl_sync(FULL, v.b1, src),
          __shfl_sync(FULL, v.m2, src), __shfl_sync(FULL, v.b2, src)};
}

__device__ __forceinline__ Map2 warp_inclusive(Map2 v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Map2 p = shfl_up(v, d);
    if (lane >= d) v = compose(p, v);
  }
  return v;
}

// Block-wide exclusive scan of each thread's map; returns (Z1, Z2), the
// value of the two recurrences just left of the thread's chunk (LOG_ZERO
// before the first column).  Contains one __syncthreads; s_w (4 x 32
// floats) must not be written again before every thread has passed the
// caller's next barrier.
__device__ __forceinline__ float2 block_carry_in(const Map2& mine, float* s_w,
                                                 int nwarps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Map2 inc = warp_inclusive(mine, lane);
  if (lane == 31) {
    s_w[warp] = inc.m1;
    s_w[32 + warp] = inc.b1;
    s_w[64 + warp] = inc.m2;
    s_w[96 + warp] = inc.b2;
  }
  __syncthreads();
  Map2 w = identity_map();
  if (lane < nwarps) w = {s_w[lane], s_w[32 + lane], s_w[64 + lane],
                          s_w[96 + lane]};
  w = warp_inclusive(w, lane);
  Map2 wprev = shfl_idx(w, (warp + 31) & 31);
  if (warp == 0) wprev = identity_map();
  Map2 tprev = shfl_up(inc, 1);
  if (lane == 0) tprev = identity_map();
  Map2 ex = compose(wprev, tprev);
  return make_float2(ex.b1, ex.b2);
}

// xcls (B, L1p), ycls (B, L2p): sequence classes 0..5 with the dummy at
// index 0; lx (B): true x lengths; m_out (B, L1p, L2p): the M row of every
// i; snap (B, 5, L2p): all five states at row lx[b]; gstate: (B, 10, L2p)
// scratch when the rows do not fit shared memory, else null.
__global__ void __launch_bounds__(1024)
pairhmm_fwd_kernel(const uint8_t* __restrict__ xcls,
                   const uint8_t* __restrict__ ycls,
                   const int* __restrict__ lx,
                   const float* __restrict__ params,
                   float* __restrict__ m_out, float* __restrict__ snap,
                   float* gstate, int L1p, int L2p, int C) {
  extern __shared__ float smem[];
  __shared__ float s_par[NPAR];
  __shared__ float s_w[128];
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int nwarps = T >> 5;
  for (int k = tid; k < NPAR; k += T) s_par[k] = params[k];
  float* st = gstate ? gstate + (size_t)b * 10 * L2p : smem;
  for (int k = tid; k < 5 * L2p; k += T) st[k] = NEG;
  __syncthreads();
  const float* li = s_par;
  const float* lt = s_par + 5;
  const float* single = s_par + 30;
  const float* pair = s_par + 38;
  const uint8_t* yc = ycls + (size_t)b * L2p;
  const uint8_t* xc_row = xcls + (size_t)b * L1p;
  const int mylx = lx[b];
  const int j0 = min(tid * C, L2p), j1 = min(j0 + C, L2p);
  const size_t W = (size_t)L2p;
  int cur = 1;
  for (int i = 0; i < L1p; ++i) {
    const float* prev = st + (size_t)(cur ^ 1) * 5 * W;
    float* now = st + (size_t)cur * 5 * W;
    const int xc = xc_row[i];
    const float e1 = single[xc];
    const float* prow = pair + xc * 8;
    // M and Ix: previous row only
    for (int j = j0; j < j1; ++j) {
      float m = NEG, ix1 = NEG, ix2 = NEG;
      if (i > 0) {
        const float em = prow[yc[j]];
        if (j == 0) {
          m = NEG;
        } else if (i == 1 && j == 1) {
          m = li[0] + em;
        } else {
          m = em + lse5(prev[j - 1] + lt[0], prev[W + j - 1] + lt[5],
                        prev[2 * W + j - 1] + lt[10],
                        prev[3 * W + j - 1] + lt[15],
                        prev[4 * W + j - 1] + lt[20]);
        }
        if (i == 1 && j == 0) {
          ix1 = li[1] + e1;
          ix2 = li[3] + e1;
        } else {
          ix1 = e1 + lse2(prev[j] + lt[1], prev[W + j] + lt[6]);
          ix2 = e1 + lse2(prev[j] + lt[3], prev[3 * W + j] + lt[18]);
        }
      }
      now[j] = m;
      now[W + j] = ix1;
      now[3 * W + j] = ix2;
    }
    __syncthreads();
    {
      float* mo = m_out + ((size_t)b * L1p + i) * W;
      for (int k = tid; k < L2p; k += T) mo[k] = now[k];
    }
    // Iy: fold the chunk, scan the block, replay the chunk
    Map2 acc = identity_map();
    for (int j = j0; j < j1; ++j) {
      const float e2 = single[yc[j]];
      const float ms = j > 0 ? now[j - 1] : NEG;
      const bool seed = (i == 0 && j == 1);
      Map2 r;
      // the seed cell (0, 1) has M[0] = LOG_ZERO: the lse is a select
      r.b1 = (seed ? li[2] : ms + lt[2]) + e2;
      r.b2 = (seed ? li[4] : ms + lt[4]) + e2;
      r.m1 = e2 + lt[12];
      r.m2 = e2 + lt[24];
      acc = compose(acc, r);
    }
    float2 z = block_carry_in(acc, s_w, nwarps);
    for (int j = j0; j < j1; ++j) {
      const float e2 = single[yc[j]];
      const float ms = j > 0 ? now[j - 1] : NEG;
      const bool seed = (i == 0 && j == 1);
      const float a1 = (seed ? li[2] : ms + lt[2]) + e2;
      const float a2 = (seed ? li[4] : ms + lt[4]) + e2;
      z.x = lse2(a1, z.x + (e2 + lt[12]));
      z.y = lse2(a2, z.y + (e2 + lt[24]));
      if (j == 0) z = make_float2(NEG, NEG);
      now[2 * W + j] = z.x;
      now[4 * W + j] = z.y;
    }
    __syncthreads();
    if (i == mylx) {
      float* sn = snap + (size_t)b * 5 * W;
      for (int k = tid; k < 5 * L2p; k += T) sn[k] = now[k];
    }
    cur ^= 1;
  }
}

// The matching backward DP over sequences already reversed within their
// lengths.  out (B, L1p, L2p): the backward matrix in forward coordinates,
// out[b, i, j] = G0[b, lx - i, ly - j] for i <= lx and j <= ly and
// LOG_ZERO elsewhere (rows of G0 beyond lx[b] are not computed).
__global__ void __launch_bounds__(1024)
pairhmm_bwd_kernel(const uint8_t* __restrict__ xcls,
                   const uint8_t* __restrict__ ycls,
                   const int* __restrict__ lx, const int* __restrict__ ly,
                   const float* __restrict__ params, float* __restrict__ out,
                   float* gstate, int L1p, int L2p, int C) {
  extern __shared__ float smem[];
  __shared__ float s_par[NPAR];
  __shared__ float s_w[128];
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int nwarps = T >> 5;
  for (int k = tid; k < NPAR; k += T) s_par[k] = params[k];
  float* st = gstate ? gstate + (size_t)b * 10 * L2p : smem;
  for (int k = tid; k < 5 * L2p; k += T) st[k] = NEG;
  __syncthreads();
  const float* li = s_par;
  const float* lt = s_par + 5;
  const float* single = s_par + 30;
  const float* pair = s_par + 38;
  const uint8_t* yc = ycls + (size_t)b * L2p;
  const uint8_t* xc_row = xcls + (size_t)b * L1p;
  const int mylx = lx[b], myly = ly[b];
  const int j0 = min(tid * C, L2p), j1 = min(j0 + C, L2p);
  const size_t W = (size_t)L2p;
  const int nrows = min(mylx + 1, L1p);
  int cur = 1;
  for (int ip = 0; ip < nrows; ++ip) {
    const float* prev = st + (size_t)(cur ^ 1) * 5 * W;
    float* now = st + (size_t)cur * 5 * W;
    const int xc = xc_row[ip];
    const float e1 = single[xc];
    const float* prow = pair + xc * 8;
    // Gx, and the fold of the Gy maps: previous row only
    Map2 acc = identity_map();
    for (int j = j0; j < j1; ++j) {
      const float e2 = single[yc[j]];
      const float H = prow[yc[j]] + (j > 0 ? prev[j - 1] : NEG);
      float gx1 = lse2(lt[5] + H, lt[6] + e1 + prev[W + j]);
      float gx2 = lse2(lt[15] + H, lt[18] + e1 + prev[3 * W + j]);
      const bool origin = (ip == 0 && j == 0);
      if (origin) {
        gx1 = li[1];
        gx2 = li[3];
      }
      now[W + j] = gx1;
      now[3 * W + j] = gx2;
      Map2 r;
      // the seeds sit at the origin only: column 0 is a select
      const float s1 = origin ? li[2] : NEG, s2 = origin ? li[4] : NEG;
      r.b1 = j == 0 ? s1 : lt[10] + H;
      r.b2 = j == 0 ? s2 : lt[20] + H;
      r.m1 = e2 + lt[12];
      r.m2 = e2 + lt[24];
      acc = compose(acc, r);
    }
    float2 z = block_carry_in(acc, s_w, nwarps);
    for (int j = j0; j < j1; ++j) {
      const float e2 = single[yc[j]];
      const float H = prow[yc[j]] + (j > 0 ? prev[j - 1] : NEG);
      const bool origin = (ip == 0 && j == 0);
      const float s1 = origin ? li[2] : NEG, s2 = origin ? li[4] : NEG;
      const float a1 = j == 0 ? s1 : lt[10] + H;
      const float a2 = j == 0 ? s2 : lt[20] + H;
      z.x = lse2(a1, z.x + (e2 + lt[12]));
      z.y = lse2(a2, z.y + (e2 + lt[24]));
      now[2 * W + j] = z.x;
      now[4 * W + j] = z.y;
    }
    __syncthreads();
    // G0: every move that leaves the match state
    for (int j = j0; j < j1; ++j) {
      const float e2 = single[yc[j]];
      const float H = prow[yc[j]] + (j > 0 ? prev[j - 1] : NEG);
      float g0 = lse5(lt[0] + H, lt[1] + e1 + prev[W + j],
                      lt[3] + e1 + prev[3 * W + j],
                      lt[2] + e2 + (j > 0 ? now[2 * W + j - 1] : NEG),
                      lt[4] + e2 + (j > 0 ? now[4 * W + j - 1] : NEG));
      if (ip == 0 && j == 0) g0 = li[0];
      now[j] = g0;
    }
    __syncthreads();
    {
      float* o = out + ((size_t)b * L1p + (mylx - ip)) * W;
      for (int k = tid; k < L2p; k += T) o[k] = k <= myly ? now[myly - k] : NEG;
    }
    cur ^= 1;
  }
  for (int r = nrows; r < L1p; ++r) {
    float* o = out + ((size_t)b * L1p + r) * W;
    for (int k = tid; k < L2p; k += T) o[k] = NEG;
  }
}

// Threads and columns per thread for a row of L2p columns.
inline void row_split(int L2p, int* threads, int* chunk) {
  int C = (L2p + 1023) / 1024;
  int T = (L2p + C - 1) / C;
  T = ((T + 31) / 32) * 32;
  *threads = T;
  *chunk = C;
}

}  // namespace

// Bytes of dynamic shared memory the kernels need for rows of L2p columns;
// beyond max_shared the caller passes a (B, 10, L2p) float scratch buffer.
extern "C" int rtt_pairhmm_state_bytes(int L2p) { return 10 * L2p * 4; }

extern "C" int rtt_pairhmm_fwd_f32(const void* xcls, const void* ycls,
                                   const void* lx, const void* params,
                                   void* m_out, void* snap, void* gstate,
                                   int B, int L1p, int L2p, void* stream) {
  int T, C;
  row_split(L2p, &T, &C);
  size_t smem = gstate ? 0 : (size_t)rtt_pairhmm_state_bytes(L2p);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pairhmm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pairhmm_fwd_kernel<<<B, T, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)xcls, (const uint8_t*)ycls, (const int*)lx,
      (const float*)params, (float*)m_out, (float*)snap, (float*)gstate, L1p,
      L2p, C);
  return (int)cudaGetLastError();
}

extern "C" int rtt_pairhmm_bwd_f32(const void* xcls, const void* ycls,
                                   const void* lx, const void* ly,
                                   const void* params, void* out,
                                   void* gstate, int B, int L1p, int L2p,
                                   void* stream) {
  int T, C;
  row_split(L2p, &T, &C);
  size_t smem = gstate ? 0 : (size_t)rtt_pairhmm_state_bytes(L2p);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pairhmm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pairhmm_bwd_kernel<<<B, T, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)xcls, (const uint8_t*)ycls, (const int*)lx,
      (const int*)ly, (const float*)params, (float*)out, (float*)gstate, L1p,
      L2p, C);
  return (int)cudaGetLastError();
}
