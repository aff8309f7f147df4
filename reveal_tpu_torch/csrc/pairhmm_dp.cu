// Pair-HMM forward and backward DP, one launch per direction and batch.
//
// Replaces the Pallas TPU kernels fwd_kernel and bwd_kernel of
// reveal_tpu/hmm/pallas_pairhmm.py (run_dp): the 5-state (M, Ix1, Iy1, Ix2,
// Iy2) log-space DP of B sequence pairs.  Only the semantics are kept.  The
// TPU version keeps the whole batch in VMEM, takes one grid step per DP row
// and solves the in-row recurrence of the y inserts by a doubling scan.
//
// Layout here: a skewed wavefront over column strips held in registers.
// A cell (i, j) needs (i-1, j-1), (i-1, j) and (i, j-1) only.  A lane owns
// C consecutive columns (a strip) and keeps the states of its strip's
// previous row in registers.  At step s lane t computes row s - t, its
// strip left to right with the recurrence
//     Z[j] = lse(a[j], Z[j-1] + c[j])
// evaluated in sequence (two 2-way lse a cell, nothing replayed).  What it
// needs from column j0 - 1 its left neighbour computed one step earlier:
// the neighbour's last column of the same row comes by __shfl_up_sync, and
// the same record, kept for one step, is the diagonal of the next row.
// There is no shared-memory state and no block barrier in the row loop.
//
// G lanes (a power of two) times C columns make a panel.  A row of at most
// G * C columns is one panel and 32 / G pairs share a warp (narrow rows).
// A wider row is P panels of 32 * C columns, one warp each.  A block is one
// warp.  The right edge of a panel's row goes to the next panel through a
// record in global memory that the L2 cache holds: every aligned 8-byte
// word is (value, row + 1), so a word that is seen whole carries its own
// flag.  The reader asks for a row's record a step ahead (cp.async into
// shared memory) and asks again while the tags are not the row's; the
// caller zeroes the buffer.  What is guaranteed there and what is relied
// on stands at st_words below.  A record is written once and never reused,
// so a writer never waits for a reader, and a warp only ever waits for a
// warp of a lower number.  Warp numbers follow a ticket taken when a block
// starts, so the warp waited for is running or done, wherever the warps of
// one pair lie: that is how a small batch of long pairs fills the card.
// Walking a row's panels in passes by the warps of one block was built and
// measured too: it was slower at every shape, few rows under 8,320 columns
// included (PERF.md), and is gone.
//
// The Python wrapper chooses (C, G, P) from (B, L1p, L2p):
// pairhmm_dp.launch_plan.  C is a template parameter, 4 or 8 columns: the
// strip's states are 5 C (forward) or 3 C (backward) registers (97-100
// and 128 registers a thread, ptxas -v; strips of 16 columns took 247 and
// won at no shape measured, so they are not built).
//
// Rows beyond lx[b] are not computed in either direction, nor, in the
// backward, columns beyond ly[b]: those cells are written as LOG_ZERO.
//
// LOG_ZERO is -2e20, not -inf: lse5 returns it when its maximum is at or
// below half of it, lse2 needs no guard because LOG_ZERO + log 2 rounds
// back to LOG_ZERO in float32.
//
// Special functions.  exp and log are the hardware's ex2/lg2
// approximations (what __expf and __logf are, flushing denormals), per
// call, never -use_fast_math.  Built once with expf, logf and log1pf
// instead, the kernels had the same grid errors against the plain versions
// and took 1.7 to 2 times as long (PERF.md), so there is one build.  In
// lse2 = max + log(1 + exp(d)), d <= 0: the fast exp errs by about 2 ulp of a value in
// (0, 1], so 1 + exp(d) in (1, 2] is off by at most 2^-22 absolute beyond
// its own rounding, and the fast log on [1, 2] errs by about 2^-21.4
// absolute (NVIDIA's table of the intrinsic functions): the result in
// (0, 0.70] is within about 1e-6, three orders under one ulp of the
// magnitudes the DP reaches (2.4e-4 at -2,800).  In lse5 the sum of five
// such terms lies in [1, 5] and its log in [0, 1.61], the same absolute
// error.  What the DP returns is max + that term, and the rounding of that
// sum dominates both.
//
// Bound on this card: a cell needs 9 exp and 5 log in each direction (the
// 5-way lse, two 2-way lse for the x inserts, two for the y recurrence;
// the seeds of the y inserts are selects) against 4 bytes written, so the
// exp/log rate and the instructions executed around them, not the memory,
// are the floor.  The design spends exactly those 14 a cell and fills the
// schedulers by splitting pairs over warps when the batch is small.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -2e20f;
constexpr int NPAR = 102;  // init 5, trans 25, single 8, pair 64
constexpr unsigned FULL = 0xffffffffu;
constexpr int FWD_REC = 16;  // 32-bit words of a forward edge record
constexpr int BWD_REC = 12;  // and of a backward one
constexpr int SCRATCH_HEAD = 4;  // words before the first record (ticket)
constexpr int EDGE_SLOT_VECTORS = 8;  // two 64-byte slots
// A record that does not come within this many polls is a fault of the
// plan, and the launch fails loudly instead of hanging the card.  A poll is
// a round trip to the L2 cache and a short sleep, so the limit is a second
// or more, where a sound wait is microseconds: the warp waited for has a
// lower ticket, so it is resident or done, and the warps of a kernel stop
// and resume together when the card is time-sliced between processes (a
// context is switched as a whole), so time away from the card is no poll.
constexpr unsigned SPIN_LIMIT = 1u << 22;

// exp of d <= 0 and log of s in [1, 5].  They are what __expf
// and __logf are, with denormals flushed (.ftz): one special-function
// instruction and one multiply each, where the non-flushing intrinsics
// add a range check and two scalings around it.  A flushed exp is below
// 1.2e-38 and is added to a term of at least 1; s is never denormal.
__device__ __forceinline__ float exp_le0(float d) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d * 1.4426950408889634f));
  return r;
}

__device__ __forceinline__ float log_ge1(float s) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(s));
  return r * 0.6931471805599453f;
}

__device__ __forceinline__ float lse2(float x, float y) {
  float m = fmaxf(x, y);
  float e = exp_le0(fminf(x, y) - m);
  return m + log_ge1(1.0f + e);
}

// One step Z = lse(a, Z + c) of the in-row recurrence, Z carried as
// zhi + zlo.  Taken in sequence a run of y inserts adds the same constant
// c a thousand times at a magnitude of thousands, and the roundings of
// those sums share their sign: plain float32 drifts by 0.23 at 2,176
// columns against the doubling scan of the plain version (measured on the
// card), which rounds log2 of that many times.  So the roundings of Z + c
// and of max + log1p(.) are kept in zlo (Fast2Sum: the first addend is the
// larger in magnitude) and go into the next step.  zhi alone is the state
// other cells read.
__device__ __forceinline__ void chain(float a, float c, float& zhi,
                                      float& zlo) {
  const float th = zhi + c;
  const float tl = (c - (th - zhi)) + zlo;
  const float m = fmaxf(a, th);
  const float e = exp_le0(fminf(a, th) - m);
  const float q = log_ge1(1.0f + e) + (th >= a ? tl : 0.f);
  const float r = m + q;
  zlo = q - (r - m);
  zhi = r;
}

__device__ __forceinline__ float lse5(float a, float b, float c, float d,
                                      float e) {
  float m = fmaxf(fmaxf(fmaxf(fmaxf(a, b), c), d), e);
  float s = exp_le0(a - m) + exp_le0(b - m) + exp_le0(c - m) +
            exp_le0(d - m) + exp_le0(e - m);
  // a select, not a branch: the strip's cells stay one basic block
  const float r = m + log_ge1(s);
  return m <= 0.5f * NEG ? NEG : r;
}

// Two (value, tag) words of an edge record.  Guaranteed (PTX memory
// model): a vector access counts as its scalar elements in no stated
// order, so each word is one 64-bit element, and an aligned 64-bit strong
// (relaxed, gpu scope) store is single-copy atomic: no observer sees a tag
// of this store beside a value of another.  The order of the two words, and
// of a record's stores, is not relied on: the reader wants every tag.
// Relied on beyond that contract: the reader copies the record with
// cp.async.cg, which the model counts as a weak access with no atomicity of
// its own; on this card it is served from the L2 cache in aligned 32-byte
// sectors, so an aligned 8-byte word arrives whole.  The comparisons of
// chip_smoke.py against the plain version run through these records at
// the shapes the main path launches.
__device__ __forceinline__ void st_words(uint32_t* p, float a, float b,
                                         uint32_t tag) {
  const uint64_t w0 = ((uint64_t)tag << 32) | __float_as_uint(a);
  const uint64_t w1 = ((uint64_t)tag << 32) | __float_as_uint(b);
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" ::"l"(p),
               "l"(w0), "l"(w1)
               : "memory");
}

__device__ __forceinline__ bool tagged(const uint4& v, uint32_t tag) {
  return v.y == tag && v.w == tag;
}

// A record is read through an asynchronous copy (cp.async, past L1) into
// two 64-byte slots of shared memory a warp, asked for one step ahead: the
// L2 cache's latency then lies beside a step's arithmetic.  A load into
// registers a step ahead does not do that: measured, it stalled the step
// by a full L2 round trip all the same (an outstanding load shares its
// scoreboard with the step's special-function results).  NV is the number
// of 16-byte vectors of a record; lanes 0..NV-1 copy one each.
template <int NV>
__device__ __forceinline__ void edge_request(const uint32_t* base,
                                             uint32_t slots, int lane,
                                             int row) {
  if (lane < NV)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     slots + (row & 1) * 64 + lane * 16),
                 "l"(base + (size_t)row * (NV * 4) + lane * 4));
  asm volatile("cp.async.commit_group;");
}

// Wait for the record of ``row`` asked for earlier and return its vectors;
// while its tags are not the row's, ask again.
template <int NV>
__device__ __forceinline__ void edge_take(const uint32_t* base, uint32_t slots,
                                          const uint4* slot, int lane, int row,
                                          uint4 (&q)[NV]) {
  const uint32_t tag = (uint32_t)row + 1u;
  unsigned spins = 0;
  for (;;) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncwarp();
    bool ok = true;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      q[v] = slot[(row & 1) * 4 + v];
      ok = ok && tagged(q[v], tag);
    }
    if (ok) return;
    if (++spins > SPIN_LIMIT) __trap();
    __nanosleep(32);
    __syncwarp();
    edge_request<NV>(base, slots, lane, row);
  }
}

// Which pair and which panel this warp (one block) has.  Takes a ticket
// when pairs are split over warps (scratch given), else the block index.
struct WarpJob {
  int b;      // pair of this lane (may be >= B: nothing to do)
  int w;      // panel of this warp
  int t;      // lane within the pair's group of G lanes
  int group;  // lanes that share the pair: G, or 32 * P
  int member; // this lane's number among them
};

__device__ __forceinline__ WarpJob take_job(const float* params, float* s_par,
                                            uint32_t* scratch, int logG,
                                            int P) {
  const int lane = threadIdx.x;
  for (int k = lane; k < NPAR; k += 32) s_par[k] = params[k];
  int v = (int)blockIdx.x;
  if (scratch && lane == 0) v = (int)atomicAdd(scratch, 1u);
  v = __shfl_sync(FULL, v, 0);
  __syncwarp();  // s_par is the whole warp's from here
  WarpJob j;
  j.t = lane & ((1 << logG) - 1);
  if (logG < 5) {
    j.b = (v << (5 - logG)) + (lane >> logG);
    j.w = 0;
    j.group = 1 << logG;
    j.member = j.t;
  } else {
    j.b = v / P;
    j.w = v - j.b * P;
    j.group = 32 * P;
    j.member = j.w * 32 + lane;
  }
  return j;
}

// The x classes of a pair's rows, G at a time: lane t of the pair's group
// holds the class of row base + t, for the block of G rows the wavefront's
// head is in (cur), the block before (prev) and the block after (next,
// loaded a block ahead).  Lane t at step s wants row s - t, which lies in
// cur or prev: two shuffles and a select a step, and one load every G
// steps in place of one a step.
struct XClasses {
  const uint8_t* row;
  int prev, cur, next, t, nrows, logG;

  __device__ __forceinline__ int load(int block) const {
    const int i = (block << logG) + t;
    return i < nrows ? (int)__ldg(row + i) : 0;
  }
  __device__ __forceinline__ void start(const uint8_t* r, int lane_t, int n,
                                        int lg) {
    row = r, t = lane_t, nrows = n, logG = lg;
    prev = 0, cur = load(0), next = load(1);
  }
  // the class of row s - t (any value when that row is not the lane's)
  __device__ __forceinline__ int at(int s) const {
    const int G = 1 << logG, i = s - t;
    const int a = __shfl_sync(FULL, cur, i & (G - 1), G);
    const int b = __shfl_sync(FULL, prev, i & (G - 1), G);
    return (i >> logG) == (s >> logG) ? a : b;
  }
  // after step s
  __device__ __forceinline__ void advance(int s) {
    if (((s + 1) & ((1 << logG) - 1)) == 0) {
      prev = cur, cur = next;
      next = load(((s + 1) >> logG) + 1);
    }
  }
};

// n floats from p (16-byte aligned, n a multiple of 4) become LOG_ZERO.
__device__ __forceinline__ void fill_neg4(float* p, size_t n, int member,
                                          int group) {
  const float4 v = make_float4(NEG, NEG, NEG, NEG);
  float4* q = reinterpret_cast<float4*>(p);
  for (size_t k = member; k < n / 4; k += group) q[k] = v;
}

// xcls (B, L1p), ycls (B, L2p): sequence classes 0..5 with the dummy at
// index 0; lx (B): true x lengths; m_out (B, L1p, L2p): the M row of every
// i <= lx[b], LOG_ZERO in the rows beyond; snap (B, 5, L2p): all five
// states at row lx[b]; scratch: the ticket and (B, P - 1, L1p) zeroed edge
// records when P > 1, else null.  L2p is a multiple of 4.
template <int C>
__global__ void __launch_bounds__(32, 16)
pairhmm_fwd_kernel(const uint8_t* __restrict__ xcls,
                   const uint8_t* __restrict__ ycls,
                   const int* __restrict__ lx,
                   const float* __restrict__ params,
                   float* __restrict__ m_out, float* __restrict__ snap,
                   uint32_t* scratch, int B, int L1p, int L2p, int logG,
                   int P) {
  __shared__ float s_par[NPAR];
  __shared__ uint4 my_slots[EDGE_SLOT_VECTORS];
  const WarpJob job = take_job(params, s_par, scratch, logG, P);
  const int lane = threadIdx.x;
  const uint32_t slots = (uint32_t)__cvta_generic_to_shared(my_slots);
  const float* li = s_par;
  const float* lt = s_par + 5;
  const float* single = s_par + 30;
  const float* pair = s_par + 38;
  const int G = 1 << logG, t = job.t, b = job.b;
  const bool live = b < B;
  const int bs = live ? b : 0;
  const int mylx = lx[bs];
  const int nrows = live ? max(0, min(mylx + 1, L1p)) : 0;
  int maxrows = nrows;
  for (int d = 16; d > 0; d >>= 1)
    maxrows = max(maxrows, __shfl_xor_sync(FULL, maxrows, d));
  const uint8_t* yc = ycls + (size_t)bs * L2p;
  const uint8_t* xc_row = xcls + (size_t)bs * L1p;
  float* mrow = m_out + (size_t)bs * L1p * L2p;
  float* sn = snap + (size_t)bs * 5 * L2p;
  const int nsteps = maxrows + G - 1;

  {
    const int p = job.w;
    const int j0 = (p * G + t) * C;
    // the strip's column classes (bytes packed four a register) and e2
    uint32_t ycw[C / 4];
    float e2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const uint32_t cls = j < L2p ? yc[j] : 5u;
      if ((c & 3) == 0) ycw[c >> 2] = 0u;
      ycw[c >> 2] |= cls << ((c & 3) * 8);
      e2[c] = single[cls];
    }
    float sm[C], sx1[C], sy1[C], sx2[C], sy2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) sm[c] = sx1[c] = sy1[c] = sx2[c] = sy2[c] = NEG;
    // the record of column j0 - 1 received at the step before: the
    // diagonal of this step's first column
    float dm = NEG, dx1 = NEG, dy1 = NEG, dx2 = NEG, dy2 = NEG;
    float zl1 = 0.f, zl2 = 0.f;  // lo parts of Iy of the last column
    const uint32_t* edge_in =
        p > 0 ? scratch + SCRATCH_HEAD +
                    ((size_t)bs * (P - 1) + (p - 1)) * L1p * FWD_REC
              : nullptr;
    uint32_t* edge_out =
        p < P - 1 ? scratch + SCRATCH_HEAD +
                        ((size_t)bs * (P - 1) + p) * L1p * FWD_REC
                  : nullptr;
    __syncwarp();
    if (edge_in != nullptr && nrows > 0)
      edge_request<4>(edge_in, slots, lane, 0);
    XClasses xs;
    xs.start(xc_row, t, nrows, logG);
    for (int s = 0; s < nsteps; ++s) {
      const int i = s - t;
      const bool active = i >= 0 && i < nrows;
      const int xc = xs.at(s);
      // column j0 - 1 of row i
      float lm = __shfl_up_sync(FULL, sm[C - 1], 1, G);
      float lx1 = __shfl_up_sync(FULL, sx1[C - 1], 1, G);
      float ly1 = __shfl_up_sync(FULL, sy1[C - 1], 1, G);
      float lx2 = __shfl_up_sync(FULL, sx2[C - 1], 1, G);
      float ly2 = __shfl_up_sync(FULL, sy2[C - 1], 1, G);
      float ll1 = __shfl_up_sync(FULL, zl1, 1, G);
      float ll2 = __shfl_up_sync(FULL, zl2, 1, G);
      if (edge_in != nullptr && s < nrows) {
        // all lanes read the one record of row s (lane 0 uses it)
        uint4 q[4];
        edge_take<4>(edge_in, slots, my_slots, lane, s, q);
        if (t == 0) {
          lm = __uint_as_float(q[0].x), lx1 = __uint_as_float(q[0].z);
          ly1 = __uint_as_float(q[1].x), lx2 = __uint_as_float(q[1].z);
          ly2 = __uint_as_float(q[2].x), ll1 = __uint_as_float(q[2].z);
          ll2 = __uint_as_float(q[3].x);
        }
        if (s + 1 < nrows) edge_request<4>(edge_in, slots, lane, s + 1);
      } else if (t == 0) {
        lm = lx1 = ly1 = lx2 = ly2 = NEG;
        ll1 = ll2 = 0.f;
      }
      if (active) {
        const float e1 = single[xc];
        const float* prow = pair + xc * 8;
        float cm = dm, cx1 = dx1, cy1 = dy1, cx2 = dx2, cy2 = dy2;  // diagonal
        float wm = lm, wy1 = ly1, wy2 = ly2, wl1 = ll1, wl2 = ll2;  // left
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = j0 + c;
          const float um = sm[c], ux1 = sx1[c], uy1 = sy1[c], ux2 = sx2[c],
                      uy2 = sy2[c];
          const float em = prow[(ycw[c >> 2] >> ((c & 3) * 8)) & 7u];
          // row 0 needs no case of its own: the states above it are
          // LOG_ZERO, and so are M and Ix computed from them
          float m = em + lse5(cm + lt[0], cx1 + lt[5], cy1 + lt[10],
                              cx2 + lt[15], cy2 + lt[20]);
          float ix1 = e1 + lse2(um + lt[1], ux1 + lt[6]);
          float ix2 = e1 + lse2(um + lt[3], ux2 + lt[18]);
          if (c < 2) {  // columns 0 and 1 lie in a strip's first two
            if (j == 0) m = NEG;
            if (i == 1 && j == 1) m = li[0] + em;
            if (i == 1 && j == 0) {
              ix1 = li[1] + e1;
              ix2 = li[3] + e1;
            }
          }
          // the seed cell (0, 1) has M[0] = LOG_ZERO: the lse is a select
          const bool seed = c < 2 && i == 0 && j == 1;
          const float a1 = (seed ? li[2] : wm + lt[2]) + e2[c];
          const float a2 = (seed ? li[4] : wm + lt[4]) + e2[c];
          chain(a1, e2[c] + lt[12], wy1, wl1);
          chain(a2, e2[c] + lt[24], wy2, wl2);
          if (c < 1 && j == 0) {
            wy1 = wy2 = NEG;
            wl1 = wl2 = 0.f;
          }
          cm = um, cx1 = ux1, cy1 = uy1, cx2 = ux2, cy2 = uy2;
          sm[c] = m, sx1[c] = ix1, sy1[c] = wy1, sx2[c] = ix2, sy2[c] = wy2;
          wm = m;
        }
        zl1 = wl1, zl2 = wl2;
        float* mo = mrow + (size_t)i * L2p + j0;
#pragma unroll
        for (int c = 0; c < C; c += 4)
          if (j0 + c < L2p)
            *reinterpret_cast<float4*>(mo + c) =
                make_float4(sm[c], sm[c + 1], sm[c + 2], sm[c + 3]);
        if (i == mylx) {
#pragma unroll
          for (int c = 0; c < C; c += 4)
            if (j0 + c < L2p) {
              float* q = sn + j0 + c;
              *reinterpret_cast<float4*>(q) =
                  make_float4(sm[c], sm[c + 1], sm[c + 2], sm[c + 3]);
              *reinterpret_cast<float4*>(q + L2p) =
                  make_float4(sx1[c], sx1[c + 1], sx1[c + 2], sx1[c + 3]);
              *reinterpret_cast<float4*>(q + 2 * (size_t)L2p) =
                  make_float4(sy1[c], sy1[c + 1], sy1[c + 2], sy1[c + 3]);
              *reinterpret_cast<float4*>(q + 3 * (size_t)L2p) =
                  make_float4(sx2[c], sx2[c + 1], sx2[c + 2], sx2[c + 3]);
              *reinterpret_cast<float4*>(q + 4 * (size_t)L2p) =
                  make_float4(sy2[c], sy2[c + 1], sy2[c + 2], sy2[c + 3]);
            }
        }
        if (edge_out != nullptr && t == G - 1) {
          uint32_t* rec = edge_out + (size_t)i * FWD_REC;
          const uint32_t tag = (uint32_t)i + 1u;
          st_words(rec, sm[C - 1], sx1[C - 1], tag);
          st_words(rec + 4, sy1[C - 1], sx2[C - 1], tag);
          st_words(rec + 8, sy2[C - 1], zl1, tag);
          st_words(rec + 12, zl2, 0.f, tag);
        }
      }
      dm = lm, dx1 = lx1, dy1 = ly1, dx2 = lx2, dy2 = ly2;
      xs.advance(s);
    }
  }
  // rows beyond lx: one contiguous range of the pair's grid
  if (live && nrows < L1p)
    fill_neg4(mrow + (size_t)nrows * L2p, (size_t)(L1p - nrows) * L2p,
              job.member, job.group);
}

// The matching backward DP over sequences already reversed within their
// lengths.  out (B, L1p, L2p): the backward matrix in forward coordinates,
// out[b, i, j] = G0[b, lx - i, ly - j] for i <= lx and j <= ly and
// LOG_ZERO elsewhere (rows of G0 beyond lx[b] and columns beyond ly[b] are
// not computed).
template <int C>
__global__ void __launch_bounds__(32, 16)
pairhmm_bwd_kernel(const uint8_t* __restrict__ xcls,
                   const uint8_t* __restrict__ ycls,
                   const int* __restrict__ lx, const int* __restrict__ ly,
                   const float* __restrict__ params, float* __restrict__ out,
                   uint32_t* scratch, int B, int L1p, int L2p, int logG,
                   int P) {
  __shared__ float s_par[NPAR];
  __shared__ uint4 my_slots[EDGE_SLOT_VECTORS];
  const WarpJob job = take_job(params, s_par, scratch, logG, P);
  const int lane = threadIdx.x;
  const uint32_t slots = (uint32_t)__cvta_generic_to_shared(my_slots);
  const float* li = s_par;
  const float* lt = s_par + 5;
  const float* single = s_par + 30;
  const float* pair = s_par + 38;
  const int G = 1 << logG, t = job.t, b = job.b;
  const bool live = b < B;
  const int bs = live ? b : 0;
  const int mylx = min(lx[bs], L1p - 1);
  const int myly = max(0, min(ly[bs], L2p - 1));
  const int nrows = live ? max(0, min(mylx + 1, L1p)) : 0;
  int maxrows = nrows;
  for (int d = 16; d > 0; d >>= 1)
    maxrows = max(maxrows, __shfl_xor_sync(FULL, maxrows, d));
  const uint8_t* yc = ycls + (size_t)bs * L2p;
  const uint8_t* xc_row = xcls + (size_t)bs * L1p;
  float* orow = out + (size_t)bs * L1p * L2p;
  const int nsteps = maxrows + G - 1;
  // The strips are laid over columns shifted right by pad (0..3), so that
  // column ly falls on the last of four: a lane's four results of a row,
  // reversed, are then one aligned float4 of the output.  The pad columns
  // left of column 0 hold LOG_ZERO, as column -1 does.
  const int pad = (4 - ((myly + 1) & 3)) & 3;
  const int top = myly + pad;  // the shifted column of ly

  // a panel wholly beyond ly has nothing to compute; with G < 32 the pairs
  // of a warp differ in ly, and their lanes idle instead
  const int p = job.w;
  if (G < 32 || p * G * C <= top) {
    const int j0 = (p * G + t) * C;
    uint32_t ycw[C / 4];
    float e2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c - pad;
      const uint32_t cls = (j >= 0 && j < L2p) ? yc[j] : 5u;
      if ((c & 3) == 0) ycw[c >> 2] = 0u;
      ycw[c >> 2] |= cls << ((c & 3) * 8);
      e2[c] = single[cls];
    }
    float sg[C], sx1[C], sx2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) sg[c] = sx1[c] = sx2[c] = NEG;
    float zy1 = NEG, zy2 = NEG;  // Gy of the strip's last column, this row
    float zl1 = 0.f, zl2 = 0.f;  // and its lo parts
    float dg = NEG;              // G0 of column j0 - 1, the row before
    const uint32_t* edge_in =
        p > 0 ? scratch + SCRATCH_HEAD +
                    ((size_t)bs * (P - 1) + (p - 1)) * L1p * BWD_REC
              : nullptr;
    uint32_t* edge_out =
        p < P - 1 ? scratch + SCRATCH_HEAD +
                        ((size_t)bs * (P - 1) + p) * L1p * BWD_REC
                  : nullptr;
    const bool cols = j0 <= top;
    __syncwarp();
    if (edge_in != nullptr && nrows > 0)
      edge_request<3>(edge_in, slots, lane, 0);
    XClasses xs;
    xs.start(xc_row, t, nrows, logG);
    for (int s = 0; s < nsteps; ++s) {
      const int ip = s - t;
      const bool active = ip >= 0 && ip < nrows && cols;
      const int xc = xs.at(s);
      float lg = __shfl_up_sync(FULL, sg[C - 1], 1, G);
      float ly1 = __shfl_up_sync(FULL, zy1, 1, G);
      float ly2 = __shfl_up_sync(FULL, zy2, 1, G);
      float ll1 = __shfl_up_sync(FULL, zl1, 1, G);
      float ll2 = __shfl_up_sync(FULL, zl2, 1, G);
      if (edge_in != nullptr && s < nrows) {
        uint4 q[3];
        edge_take<3>(edge_in, slots, my_slots, lane, s, q);
        if (t == 0) {
          lg = __uint_as_float(q[0].x), ly1 = __uint_as_float(q[0].z);
          ly2 = __uint_as_float(q[1].x), ll1 = __uint_as_float(q[1].z);
          ll2 = __uint_as_float(q[2].x);
        }
        if (s + 1 < nrows) edge_request<3>(edge_in, slots, lane, s + 1);
      } else if (t == 0) {
        lg = ly1 = ly2 = NEG;
        ll1 = ll2 = 0.f;
      }
      if (active) {
        const float e1 = single[xc];
        const float* prow = pair + xc * 8;
        float cg = dg;                 // diagonal G0
        float wy1 = ly1, wy2 = ly2, wl1 = ll1, wl2 = ll2;  // left Gy, this row
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = j0 + c - pad;
          const float ug = sg[c], ux1 = sx1[c], ux2 = sx2[c];
          const float em = prow[(ycw[c >> 2] >> ((c & 3) * 8)) & 7u];
          // column -1 is LOG_ZERO, so H of column 0 is too
          const float H = em + cg;
          float gx1 = lse2(lt[5] + H, lt[6] + e1 + ux1);
          float gx2 = lse2(lt[15] + H, lt[18] + e1 + ux2);
          float a1 = lt[10] + H, a2 = lt[20] + H;
          float g0 = lse5(lt[0] + H, lt[1] + e1 + ux1, lt[3] + e1 + ux2,
                          lt[2] + e2[c] + wy1, lt[4] + e2[c] + wy2);
          if (c < 4 && j == 0) {
            // the seeds sit at the origin only: column 0 is a select
            const bool origin = ip == 0;
            a1 = origin ? li[2] : NEG;
            a2 = origin ? li[4] : NEG;
            if (origin) {
              gx1 = li[1];
              gx2 = li[3];
              g0 = li[0];
            }
          }
          chain(a1, e2[c] + lt[12], wy1, wl1);
          chain(a2, e2[c] + lt[24], wy2, wl2);
          if (c < 3 && j < 0) {  // a pad column
            g0 = gx1 = gx2 = wy1 = wy2 = NEG;
            wl1 = wl2 = 0.f;
          }
          cg = ug;
          sg[c] = g0, sx1[c] = gx1, sx2[c] = gx2;
        }
        zy1 = wy1, zy2 = wy2, zl1 = wl1, zl2 = wl2;
        // shifted column j' goes to output column top - j'; a pad column
        // lands beyond ly, where LOG_ZERO belongs anyway
        float* o = orow + (size_t)(mylx - ip) * L2p + (top - j0 - 3);
#pragma unroll
        for (int c = 0; c < C; c += 4)
          if (j0 + c <= top)
            *reinterpret_cast<float4*>(o - c) =
                make_float4(sg[c + 3], sg[c + 2], sg[c + 1], sg[c]);
        if (edge_out != nullptr && t == G - 1) {
          uint32_t* rec = edge_out + (size_t)ip * BWD_REC;
          const uint32_t tag = (uint32_t)ip + 1u;
          st_words(rec, sg[C - 1], zy1, tag);
          st_words(rec + 4, zy2, zl1, tag);
          st_words(rec + 8, zl2, 0.f, tag);
        }
      }
      dg = lg;
      xs.advance(s);
    }
  }
  if (live) {
    // columns beyond ly in the rows computed, then the rows beyond lx
    const int tail = L2p - 1 - myly;
    for (int r = 0; r < nrows; ++r) {
      float* o = orow + (size_t)r * L2p + myly + 1;
      for (int k = job.member; k < tail; k += job.group) o[k] = NEG;
    }
    if (nrows < L1p)
      fill_neg4(orow + (size_t)nrows * L2p, (size_t)(L1p - nrows) * L2p,
                job.member, job.group);
  }
}

int ilog2(int g) {
  int l = 0;
  while ((1 << l) < g) ++l;
  return l;
}

// Blocks (of one warp) of a launch: B * P, or B / (32 / G) when pairs
// share a warp.
int grid_of(int B, int G, int P) {
  return (int)(G < 32 ? ((long)B * G + 31) / 32 : (long)B * P);
}

bool plan_ok(int C, int G, int P, int L2p, const void* scratch) {
  if (C != 4 && C != 8) return false;
  if (G < 1 || G > 32 || (G & (G - 1))) return false;
  if (P < 1 || (G < 32 && P != 1)) return false;
  if (P > 1 && !scratch) return false;
  return (L2p & 3) == 0 && (long)P * G * C >= L2p;
}

}  // namespace

// 32-bit words of zeroed scratch a launch needs (0 when P == 1).
extern "C" long rtt_pairhmm_scratch_words(int forward, int B, int L1p,
                                          int P) {
  if (P <= 1) return 0;
  return SCRATCH_HEAD +
         (long)B * (P - 1) * L1p * (forward ? FWD_REC : BWD_REC);
}

// The plan (C columns a lane, G lanes a panel, P panels a row) is
// pairhmm_dp.launch_plan's; a plan the kernels do not take returns
// cudaErrorInvalidValue.
extern "C" int rtt_pairhmm_fwd_f32(const void* xcls, const void* ycls,
                                   const void* lx, const void* params,
                                   void* m_out, void* snap, void* scratch,
                                   int B, int L1p, int L2p, int C, int G,
                                   int P, void* stream) {
  if (!plan_ok(C, G, P, L2p, scratch)) return (int)cudaErrorInvalidValue;
  const int grid = grid_of(B, G, P), lg = ilog2(G);
  cudaStream_t st = (cudaStream_t)stream;
#define RTT_LAUNCH(CC)                                                      \
  pairhmm_fwd_kernel<CC><<<grid, 32, 0, st>>>(                              \
      (const uint8_t*)xcls, (const uint8_t*)ycls, (const int*)lx,           \
      (const float*)params, (float*)m_out, (float*)snap, (uint32_t*)scratch, \
      B, L1p, L2p, lg, P)
  if (C == 4) RTT_LAUNCH(4);
  else RTT_LAUNCH(8);
#undef RTT_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int rtt_pairhmm_bwd_f32(const void* xcls, const void* ycls,
                                   const void* lx, const void* ly,
                                   const void* params, void* out,
                                   void* scratch, int B, int L1p, int L2p,
                                   int C, int G, int P, void* stream) {
  if (!plan_ok(C, G, P, L2p, scratch)) return (int)cudaErrorInvalidValue;
  const int grid = grid_of(B, G, P), lg = ilog2(G);
  cudaStream_t st = (cudaStream_t)stream;
#define RTT_LAUNCH(CC)                                                     \
  pairhmm_bwd_kernel<CC><<<grid, 32, 0, st>>>(                             \
      (const uint8_t*)xcls, (const uint8_t*)ycls, (const int*)lx,          \
      (const int*)ly, (const float*)params, (float*)out,                   \
      (uint32_t*)scratch, B, L1p, L2p, lg, P)
  if (C == 4) RTT_LAUNCH(4);
  else RTT_LAUNCH(8);
#undef RTT_LAUNCH
  return (int)cudaGetLastError();
}
