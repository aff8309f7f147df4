// Native host kernels for reveal_tpu: suffix array (SA-IS) and capped
// Kasai LCP.
//
// The reference links libdivsufsort (divsufsort) for its
// host suffix sort; this is an independent SA-IS (induced sorting)
// implementation — the standard linear-time algorithm (Nong, Zhang & Chan
// 2009) written from the algorithm description.  The LCP pass mirrors the
// reference's compute_lcp semantics (interface.c:97-114): comparisons stop
// at '$' and 'N' so matches never span sequence boundaries or gap runs.
//
// Exposed via a C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// generic SA-IS over an integer alphabet; S has n elements, values in
// [0, K); S[n-1] must be the unique smallest element (sentinel 0).
template <typename Char, typename Index>
void sais(const Char* S, Index* SA, Index n, Index K) {
  if (n == 0) return;
  if (n == 1) {
    SA[0] = 0;
    return;
  }
  std::vector<bool> is_s(n);
  is_s[n - 1] = true;
  for (Index i = n - 2; i >= 0; --i) {
    is_s[i] = (S[i] < S[i + 1]) || (S[i] == S[i + 1] && is_s[i + 1]);
    if (i == 0) break;
  }
  auto is_lms = [&](Index i) {
    return i > 0 && is_s[i] && !is_s[i - 1];
  };

  std::vector<Index> bkt(K, 0);
  auto bucket_sizes = [&]() {
    std::fill(bkt.begin(), bkt.end(), 0);
    for (Index i = 0; i < n; ++i) bkt[S[i]]++;
  };
  auto bucket_ends = [&](std::vector<Index>& b) {
    b.resize(K);
    Index sum = 0;
    for (Index c = 0; c < K; ++c) {
      sum += bkt[c];
      b[c] = sum;  // exclusive end
    }
  };
  auto bucket_starts = [&](std::vector<Index>& b) {
    b.resize(K);
    Index sum = 0;
    for (Index c = 0; c < K; ++c) {
      b[c] = sum;
      sum += bkt[c];
    }
  };

  std::vector<Index> b;
  const Index EMPTY = (Index)-1;

  auto induce = [&](/* SA prefilled with LMS seeds or EMPTY */) {
    // L-type left-to-right
    bucket_starts(b);
    for (Index i = 0; i < n; ++i) {
      Index j = SA[i];
      if (j != EMPTY && j > 0 && !is_s[j - 1]) {
        SA[b[S[j - 1]]++] = j - 1;
      }
    }
    // S-type right-to-left
    bucket_ends(b);
    for (Index i = n - 1; i >= 0; --i) {
      Index j = SA[i];
      if (j != EMPTY && j > 0 && is_s[j - 1]) {
        SA[--b[S[j - 1]]] = j - 1;
      }
      if (i == 0) break;
    }
  };

  bucket_sizes();

  // step 1: place LMS suffixes at their bucket ends (text order), induce
  std::fill(SA, SA + n, EMPTY);
  bucket_ends(b);
  for (Index i = n - 1; i >= 0; --i) {
    if (is_lms(i)) SA[--b[S[i]]] = i;
    if (i == 0) break;
  }
  induce();

  // collect sorted LMS positions
  std::vector<Index> lms_order;
  lms_order.reserve(n / 2 + 1);
  for (Index i = 0; i < n; ++i) {
    if (SA[i] != EMPTY && is_lms(SA[i])) lms_order.push_back(SA[i]);
  }
  Index n_lms = (Index)lms_order.size();

  // name LMS substrings
  std::vector<Index> name(n, EMPTY);
  Index cur_name = 0;
  Index prev = EMPTY;
  for (Index k = 0; k < n_lms; ++k) {
    Index pos = lms_order[k];
    if (prev == EMPTY) {
      name[pos] = cur_name;
    } else {
      // compare LMS substrings at prev and pos
      bool diff = false;
      for (Index d = 0;; ++d) {
        Index a = prev + d, c = pos + d;
        if (a >= n || c >= n) {
          diff = true;
          break;
        }
        bool la = is_lms(a), lc = is_lms(c);
        if (d > 0 && (la || lc)) {
          diff = !(la && lc);
          break;
        }
        if (S[a] != S[c] || is_s[a] != is_s[c]) {
          diff = true;
          break;
        }
      }
      if (diff) ++cur_name;
      name[pos] = cur_name;
    }
    prev = pos;
  }
  Index num_names = n_lms ? cur_name + 1 : 0;

  // LMS positions in text order + their names form the reduced string
  std::vector<Index> lms_text;
  lms_text.reserve(n_lms);
  for (Index i = 0; i < n; ++i) {
    if (is_lms(i)) lms_text.push_back(i);
  }
  std::vector<Index> s1(n_lms), sa1(n_lms);
  for (Index k = 0; k < n_lms; ++k) s1[k] = name[lms_text[k]];

  if (num_names < n_lms) {
    sais<Index, Index>(s1.data(), sa1.data(), n_lms, num_names);
  } else {
    for (Index k = 0; k < n_lms; ++k) sa1[s1[k]] = k;
  }

  // step 2: seed with LMS suffixes in their sorted order, induce again
  std::fill(SA, SA + n, EMPTY);
  bucket_ends(b);
  for (Index k = n_lms - 1; k >= 0; --k) {
    Index pos = lms_text[sa1[k]];
    SA[--b[S[pos]]] = pos;
    if (k == 0) break;
  }
  induce();
}

template <typename Index>
int build_sa(const uint8_t* T, Index* SA, Index n) {
  if (n <= 0) return 0;
  // append virtual 0-sentinel: run over alphabet shifted by +1
  std::vector<uint16_t> S(n + 1);
  for (Index i = 0; i < n; ++i) S[i] = (uint16_t)T[i] + 1;
  S[n] = 0;
  std::vector<Index> SAx(n + 1);
  sais<uint16_t, Index>(S.data(), SAx.data(), n + 1, 257);
  // SAx[0] == n (the sentinel); the rest is the SA of T
  std::memcpy(SA, SAx.data() + 1, sizeof(Index) * n);
  return 0;
}

template <typename Index>
void kasai_capped(const uint8_t* T, const Index* SA, Index* SAi, Index* LCP,
                  Index n) {
  // chunk-parallel: h is only a lower-bound hint (lcp(i) >= lcp(i-1)-1),
  // so restarting each chunk at h=0 recomputes a few extra byte
  // comparisons at the boundary and yields the IDENTICAL LCP array.
  int64_t nt = (int64_t)std::thread::hardware_concurrency();
  if (const char* e = std::getenv("REVEAL_TPU_KASAI_THREADS"))
    nt = std::max((int64_t)1, (int64_t)std::atoll(e));
  nt = std::max((int64_t)1, std::min(nt, (int64_t)(n / 262144)));
  auto fill = [&](Index lo, Index hi) {
    for (Index i = lo; i < hi; ++i) SAi[SA[i]] = i;
  };
  auto scan = [&](Index lo, Index hi) {
    Index h = 0;
    for (Index i = lo; i < hi; ++i) {
      Index k = SAi[i];
      if (k == 0) {
        LCP[k] = 0;
      } else {
        Index j = SA[k - 1];
        while (i + h < n && j + h < n && T[i + h] == T[j + h] &&
               T[i + h] != '$' && T[i + h] != 'N') {
          ++h;
        }
        LCP[k] = h;
      }
      if (h > 0) --h;
    }
  };
  if (nt <= 1) {
    fill(0, n);
    scan(0, n);
    return;
  }
  {
    std::vector<std::thread> pool;
    Index step = (n + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
      Index lo = (Index)(t * step);
      Index hi = std::min<Index>(n, lo + step);
      if (lo < hi) pool.emplace_back(fill, lo, hi);
    }
    for (auto& th : pool) th.join();
  }
  {
    std::vector<std::thread> pool;
    Index step = (n + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
      Index lo = (Index)(t * step);
      Index hi = std::min<Index>(n, lo + step);
      if (lo < hi) pool.emplace_back(scan, lo, hi);
    }
    for (auto& th : pool) th.join();
  }
}

}  // namespace

namespace {

// pairwise MUM scan over one segment (reveal.c:119-180 semantics):
// adjacent SA entries with LCP >= minl, straddling nsep0, left-maximal,
// unique.  Returns match count; fills (l, a, b) arrays.  Index is int32
// or int64 — the 32-bit twin (reference setup.py:21-31 builds both)
// halves memory traffic on these memory-bound passes.
template <typename Index>
int64_t pairwise_mums(const uint8_t* T, const Index* SA,
                      const Index* LCP, int64_t n, int64_t nsep0,
                      int64_t minl, int rc, int64_t nT, Index* out_l,
                      Index* out_a, Index* out_b) {
  int64_t cnt = 0;
  constexpr int64_t PD = 16;
  for (int64_t i = 1; i < n; ++i) {
    // T[SA[.]-1] left-maximality checks are random gathers — prefetch
    if (i + PD < n) {
      __builtin_prefetch(&T[SA[i + PD - 1]], 0, 0);
      __builtin_prefetch(&T[SA[i + PD]], 0, 0);
    }
    int64_t l = LCP[i];
    if (l < minl || l <= 0) continue;
    int64_t prev = SA[i - 1], cur = SA[i];
    if ((cur > nsep0) == (prev > nsep0)) continue;  // repeat
    int64_t a = cur < prev ? cur : prev;
    int64_t b = cur < prev ? prev : cur;
    if (a > 0 && b > 0) {
      uint8_t ta = T[a - 1], tb = T[b - 1];
      if (!(ta != tb || ta == 'N' || ta == '$' ||
            (ta >= 'a' && ta <= 'z'))) {
        continue;  // not left-maximal
      }
    }
    int64_t lb = LCP[i - 1];
    int64_t la = (i == n - 1) ? 0 : LCP[i + 1];
    if (lb >= l || la >= l) continue;  // not unique
    if (rc) b = nsep0 + (nT - b - l);
    out_l[cnt] = l;
    out_a[cnt] = a;
    out_b[cnt] = b;
    ++cnt;
  }
  return cnt;
}

// 3-way stable split with running-min LCP (reveal.c:582-664).  D_sa is the
// per-SA-slot class (1=leading, 2=trailing, 3=matched, 4=parallel,
// 0=dropped).  Outputs are preallocated to n; returns counts via out_n.
template <typename Index>
void split3(const Index* SA, const Index* LCP, const uint8_t* D_sa,
            int64_t n, Index* SAi, Index* sa_l, Index* lcp_l,
            Index* sa_t, Index* lcp_t, Index* sa_p, Index* lcp_p,
            int64_t* out_n) {
  int64_t il = 0, it = 0, ip = 0;
  Index minl = 0, mint = 0, minp = 0;
  int64_t lastl = -1, lastt = -1, lastp = -1;
  constexpr int64_t PD = 16;
  for (int64_t i = 0; i < n; ++i) {
    // SAi[SA[i]] writes are random — prefetch the line ahead of use
    if (i + PD < n) __builtin_prefetch(&SAi[SA[i + PD]], 1, 0);
    uint8_t d = D_sa[i];
    if (d == 1) {
      sa_l[il] = SA[i];
      lcp_l[il] = il == 0 ? 0 : minl;
      SAi[SA[i]] = (Index)il;
      ++il;
      lastl = i;
    } else if (d == 2) {
      sa_t[it] = SA[i];
      lcp_t[it] = it == 0 ? 0 : mint;
      SAi[SA[i]] = (Index)it;
      ++it;
      lastt = i;
    } else if (d == 4) {
      sa_p[ip] = SA[i];
      lcp_p[ip] = ip == 0 ? 0 : minp;
      SAi[SA[i]] = (Index)ip;
      ++ip;
      lastp = i;
    }
    if (i == n - 1) break;
    Index nxt = LCP[i + 1];
    minl = (i == lastl) ? nxt : (nxt < minl ? nxt : minl);
    mint = (i == lastt) ? nxt : (nxt < mint ? nxt : mint);
    minp = (i == lastp) ? nxt : (nxt < minp ? nxt : minp);
  }
  out_n[0] = il;
  out_n[1] = it;
  out_n[2] = ip;
}

// full split step (aligner() post-callback work, reveal.c:1005-1324):
// classify this segment's SA slots from the node/match intervals (via the
// segment-local inverse SAi), then stable 3-way split with running-min
// LCP, children written contiguously into sa_buf/lcp_buf as
// [leading | trailing | parallel].  Interval classes overwrite in input
// order (callers pass leading, trailing, rest, then matched=3 last, like
// the numpy D_sa construction).  SAi is rewritten for child slots.
template <typename Index>
void split3_full(const Index* SA, const Index* LCP, int64_t n,
                 Index* SAi, const int64_t* iv, int64_t niv,
                 Index* sa_buf, Index* lcp_buf, int64_t* out_n) {
  std::vector<uint8_t> D(n, 0);
  for (int64_t k = 0; k < niv; ++k) {
    const int64_t begin = iv[k * 3];
    const int64_t end = iv[k * 3 + 1];
    const uint8_t cls = (uint8_t)iv[k * 3 + 2];
    // the D[SAi[p]] scatter is a dependent cache miss per position —
    // prefetch ahead on the sequential SAi read to overlap the misses
    constexpr int64_t PD = 16;
    for (int64_t p = begin; p < end; ++p) {
      if (p + PD < end) __builtin_prefetch(&D[SAi[p + PD]], 1, 0);
      D[SAi[p]] = cls;
    }
  }
  int64_t c1 = 0, c2 = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (D[i] == 1) ++c1;
    else if (D[i] == 2) ++c2;
  }
  Index* sa_l = sa_buf;
  Index* lcp_l = lcp_buf;
  Index* sa_t = sa_buf + c1;
  Index* lcp_t = lcp_buf + c1;
  Index* sa_p = sa_buf + c1 + c2;
  Index* lcp_p = lcp_buf + c1 + c2;
  split3(SA, LCP, D.data(), n, SAi, sa_l, lcp_l, sa_t, lcp_t, sa_p, lcp_p,
         out_n);
}

// multiMUM enumeration: the linear LCP-interval stack walk
// (getmultimums semantics, reveal.c:436-580).  Emits (l, lb, ub) for
// every lcp-interval whose width is in [minn, nsamples_main], whose
// suffixes come from distinct samples, and where some adjacent pair is
// left-maximal.  Output arrays must hold n entries.
template <typename Index>
int64_t multimums_scan(const uint8_t* T, const Index* SA,
                       const Index* LCP, const uint16_t* SO, int64_t n,
                       int64_t nsamples_main, int64_t minl, int64_t minn,
                       Index* out_l, Index* out_lb, Index* out_ub) {
  if (minl < 1) minl = 1;
  int64_t cnt = 0;
  auto ismultimum = [&](int64_t l, int64_t lb, int64_t ub) -> bool {
    if (l <= 0) return false;
    for (int64_t j = lb; j <= ub; ++j) {  // distinct samples (width small)
      uint16_t s = SO[SA[j]];
      for (int64_t k = lb; k < j; ++k)
        if (SO[SA[k]] == s) return false;
    }
    for (int64_t j = lb; j < ub; ++j) {  // some adjacent pair left-maximal
      if (SA[j] == 0 || SA[j + 1] == 0) return true;
      uint8_t ta = T[SA[j] - 1];
      uint8_t tb = T[SA[j + 1] - 1];
      if (ta != tb || ta == 'N' || ta == '$' || (ta >= 'a' && ta <= 'z'))
        return true;
    }
    return false;
  };
  auto emit = [&](int64_t l, int64_t lb, int64_t ub) {
    int64_t w = ub - lb + 1;
    if (l >= minl && w >= minn && w <= nsamples_main &&
        ismultimum(l, lb, ub)) {
      out_l[cnt] = (Index)l;
      out_lb[cnt] = (Index)lb;
      out_ub[cnt] = (Index)ub;
      ++cnt;
    }
  };
  std::vector<std::pair<int64_t, int64_t>> stack;  // (lcp, lb)
  stack.emplace_back(0, 0);
  for (int64_t i = 1; i < n; ++i) {
    int64_t lb = i - 1;
    while (LCP[i] < stack.back().first) {
      int64_t l = stack.back().first;
      int64_t ilb = stack.back().second;
      stack.pop_back();
      emit(l, ilb, i - 1);
      lb = ilb;
    }
    if (LCP[i] > stack.back().first) stack.emplace_back(LCP[i], lb);
  }
  while (!stack.empty()) {
    int64_t l = stack.back().first;
    int64_t ilb = stack.back().second;
    stack.pop_back();
    emit(l, ilb, n - 1);
  }
  return cnt;
}

// boundary repair after a split (bubble_sort, reveal.c:666-727 semantics):
// for every new matching-interval start `begin` (ascending), suffixes that
// start before the match and whose LCP crosses it are re-inserted at their
// corrected position with truncated LCP; following entries get their LCP
// capped.  Mutates SA/LCP (the child's arrays) and SAi (the global
// inverse) in place.
template <typename Index>
void repair_leading(Index* SA, Index* LCP, Index* SAi, int64_t n,
                    const int64_t* begins, int64_t nb) {
  if (n == 0) return;
  for (int64_t bi = 0; bi < nb; ++bi) {
    const Index begin = (Index)begins[bi];
    for (int64_t i = 0; i < n; ++i) {
      if (SA[i] < begin && SA[i] + LCP[i] > begin) {
        const Index tmp_sa = SA[i];
        const Index tmp_lcp = LCP[i];
        const Index thr = begin - tmp_sa;
        int64_t x = i;
        while (x > 0 && LCP[x] >= thr) --x;
        if (x < i) {
          std::memmove(SA + x + 1, SA + x, (i - x) * sizeof(Index));
          std::memmove(LCP + x + 1, LCP + x, (i - x) * sizeof(Index));
          for (int64_t j = x + 1; j <= i; ++j) SAi[SA[j]] = (Index)j;
        }
        SA[x] = tmp_sa;
        SAi[tmp_sa] = (Index)x;
        LCP[x + 1] = thr;
        if (i < n - 1 && tmp_lcp < LCP[i + 1]) LCP[i + 1] = tmp_lcp;
      } else if (i < n - 1 && SA[i] < begin && SA[i] + LCP[i + 1] > begin &&
                 LCP[i + 1] > LCP[i]) {
        LCP[i + 1] = begin - SA[i];
      }
    }
  }
}

// fused post-pick step (the aligner()'s whole post-callback sequence,
// reveal.c:1005-1324, in one host call): classify + 3-way split, lowercase
// the matched text (reveal.c:1230-1234), boundary-repair the leading child
// (bubble_sort, reveal.c:666-727), then enumerate pairwise MUM candidates
// for the leading and trailing children while their SA/LCP slices are
// cache-hot.  Eager enumeration is exact for these two children under the
// LIFO worklist: the trailing child is popped immediately next, and every
// split that runs before the leading child is popped only lowercases text
// to the right of this match (see align/rem._align_loop).
// out_n: [n_lead, n_trail, n_par, mums_lead, mums_trail].
template <typename Index>
void split3_repair_enum(const Index* SA, const Index* LCP, int64_t n,
                        Index* SAi, const int64_t* iv, int64_t niv,
                        uint8_t* T, const int64_t* matches /* (nm,2) */,
                        int64_t nm, int64_t nsep0, int64_t minl,
                        int enum_lead, int enum_trail, Index* sa_buf,
                        Index* lcp_buf, Index* ml, Index* ma, Index* mb,
                        int64_t* out_n) {
  split3_full(SA, LCP, n, SAi, iv, niv, sa_buf, lcp_buf, out_n);
  const int64_t c1 = out_n[0], c2 = out_n[1];
  for (int64_t k = 0; k < nm; ++k) {
    const int64_t p = matches[k * 2];
    const int64_t l = matches[k * 2 + 1];
    for (int64_t q = p; q < p + l; ++q) {
      if (T[q] >= 'A' && T[q] <= 'Z') T[q] += 32;
    }
  }
  if (c1 > 0 && nm > 0) {
    std::vector<int64_t> begins(nm);
    for (int64_t k = 0; k < nm; ++k) begins[k] = matches[k * 2];
    std::sort(begins.begin(), begins.end());
    repair_leading(sa_buf, lcp_buf, SAi, c1, begins.data(), nm);
  }
  out_n[3] = -1;  // -1 = not enumerated (caller enumerates lazily)
  out_n[4] = -1;
  if (enum_lead) {
    out_n[3] = c1 > 1 ? pairwise_mums(T, sa_buf, lcp_buf, c1, nsep0, minl,
                                      0, (int64_t)0, ml, ma, mb)
                      : 0;
  }
  if (enum_trail) {
    const int64_t off = out_n[3] > 0 ? out_n[3] : 0;
    out_n[4] = c2 > 1 ? pairwise_mums(T, sa_buf + c1, lcp_buf + c1, c2,
                                      nsep0, minl, 0, (int64_t)0, ml + off,
                                      ma + off, mb + off)
                      : 0;
  }
}

// per-dimension overlap trimming (schemes.py:161-191 semantics as
// re-expressed in align/chaining.trim_overlap): for each dimension,
// stable-sort by (start, -len), drop matches contained in their sorted
// neighbour (with the reference's i==0 wraparound quirk), then walk the
// survivors resolving overlaps by shortening the earlier match (or
// deleting it) and shifting the later one's start in every dimension.
// L (k) and P (k, d) are mutated in place; the surviving indices are
// written to ord_out in final order; returns the survivor count.
int64_t trim_overlap_dp(int64_t* L, int64_t* P, int64_t k, int64_t d,
                        int64_t* ord_out) {
  std::vector<int64_t> cur(k);
  for (int64_t i = 0; i < k; ++i) cur[i] = i;
  for (int64_t coord = 0; coord < d; ++coord) {
    if ((int64_t)cur.size() <= 1) break;
    std::stable_sort(cur.begin(), cur.end(),
                     [&](int64_t x, int64_t y) {
                       if (P[x * d + coord] != P[y * d + coord])
                         return P[x * d + coord] < P[y * d + coord];
                       return L[x] > L[y];
                     });
    const int64_t m = (int64_t)cur.size();
    std::vector<int64_t> ends(m);
    for (int64_t i = 0; i < m; ++i)
      ends[i] = P[cur[i] * d + coord] + L[cur[i]];
    std::vector<int64_t> kept;
    kept.reserve(m);
    for (int64_t i = 0; i < m; ++i) {
      bool keep;
      if (i == 0) {
        keep = (ends[1] > ends[0]) || (ends[m - 1] < ends[0]);
      } else {
        keep = ends[i - 1] < ends[i];
      }
      if (keep) kept.push_back(cur[i]);
    }
    cur.swap(kept);
    if ((int64_t)cur.size() <= 1) break;
    std::vector<int64_t> trimmed;
    trimmed.reserve(cur.size());
    trimmed.push_back(cur[0]);
    for (size_t t = 1; t < cur.size(); ++t) {
      const int64_t mi = cur[t];
      if (trimmed.empty()) {
        // both neighbours fully consumed each other; the reference would
        // raise here (trimmed[-1] on an empty list) — the containment
        // filter makes this unreachable for well-formed input, so treat
        // the next mum as a fresh run start
        trimmed.push_back(mi);
        continue;
      }
      const int64_t pi = trimmed.back();
      const int64_t overlap = P[pi * d + coord] + L[pi] - P[mi * d + coord];
      if (overlap > 0) {
        if (L[pi] - overlap > 0) {
          L[pi] -= overlap;
        } else {
          trimmed.pop_back();
        }
        if (L[mi] - overlap > 0) {
          L[mi] -= overlap;
          for (int64_t c = 0; c < d; ++c) P[mi * d + c] += overlap;
          trimmed.push_back(mi);
        }
      } else {
        trimmed.push_back(mi);
      }
    }
    cur.swap(trimmed);
  }
  for (size_t i = 0; i < cur.size(); ++i) ord_out[i] = cur[i];
  return (int64_t)cur.size();
}

}  // namespace

// sparse chaining DP (schemes.py:20-104 semantics as re-expressed in
// align/chaining.py): mums pre-sorted by the ref dimension (with the
// virtual `right` element included), sumofpairs gap cost with lambda=1,
// eps=0.  Fills link[] (predecessor slot, -1 = left) and scores[].
namespace {

void chain_dp(const int64_t* starts,  // (k, d) row-major
              const int64_t* lens,    // (k,)
              const int64_t* nmul,    // (k,) precomputed wscore*l*C(n,2)
              int64_t k, int64_t d, const int64_t* left_start,
              double wpen, int64_t* link, double* scores) {
  struct Key {
    double negscore;
    int64_t counter;
  };
  // active order: indices into slots; slot k is "left"
  std::vector<int64_t> order;     // slot ids in (score desc, arrival)
  std::vector<Key> keys;          // parallel to order
  std::vector<double> slot_score(k + 1, 0.0);
  std::vector<int64_t> slot_end((k + 1) * d);
  for (int64_t j = 0; j < d; ++j) slot_end[k * d + j] = left_start[j];
  order.push_back(k);
  keys.push_back({-0.0, 0});
  int64_t counter = 1;

  std::vector<char> live(k, 0);
  std::vector<int64_t> processed;  // slots in arrival order
  processed.reserve(k);

  std::vector<double> D(d);

  for (int64_t m = 0; m < k; ++m) {
    const int64_t* ms = starts + m * d;
    // migrate eligible processed -> active
    for (size_t pi = 0; pi < processed.size(); ++pi) {
      int64_t p = processed[pi];
      if (!live[p]) continue;
      bool elig = true;
      for (int64_t j = 0; j < d; ++j) {
        if (slot_end[p * d + j] > ms[j]) {
          elig = false;
          break;
        }
      }
      if (!elig) continue;
      live[p] = 0;
      Key key{-slot_score[p], counter++};
      // upper_bound by (negscore, counter)
      size_t lo = 0, hi = keys.size();
      while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        if (keys[mid].negscore < key.negscore ||
            (keys[mid].negscore == key.negscore &&
             keys[mid].counter < key.counter)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      keys.insert(keys.begin() + lo, key);
      order.insert(order.begin() + lo, p);
    }

    double mul = (double)nmul[m];
    double w = 0;
    bool have_w = false;
    int64_t best = -2;
    for (size_t ai = 0; ai < order.size(); ++ai) {
      int64_t a = order[ai];
      bool ok = true;
      for (int64_t j = 0; j < d; ++j) {
        if (slot_end[a * d + j] > ms[j]) {
          ok = false;
          break;
        }
      }
      if (!ok) continue;
      double s = slot_score[a] + mul;
      if (have_w && w > s) break;
      double pen = 0;
      for (int64_t j = 0; j < d; ++j) {
        int64_t diff = ms[j] - slot_end[a * d + j];
        D[j] = diff < 0 ? (double)(-diff) : (double)diff;
      }
      for (int64_t i = 0; i < d; ++i) {
        for (int64_t j = i + 1; j < d; ++j) {
          double dd = D[i] - D[j];
          pen += dd < 0 ? -dd : dd;
        }
      }
      double tmpw = s - wpen * pen;
      if (!have_w || tmpw > w) {
        w = tmpw;
        have_w = true;
        best = a;
      }
    }
    link[m] = best == k ? -1 : best;
    scores[m] = w;
    slot_score[m] = w;
    for (int64_t j = 0; j < d; ++j) {
      slot_end[m * d + j] = ms[j] + lens[m];
    }
    live[m] = 1;
    processed.push_back(m);
  }
}

}  // namespace


// whole pairwise pick in one call (graphmumpicker, schemes.py:197-358,
// for the 2-genome sumofpairs/largest case as re-expressed in
// align/picker.pick_pairwise): trim -> stable (n, l) sort -> arithmetic
// offset map -> target-pair filter -> maxmums cap -> chain DP -> chain
// walk -> largest split pick -> optional seed skip lists -> p-value gate.
// left_off/right_off: per-sample-id boundary offsets (INT64_MIN =
// missing -> defer).  Returns 0 ok, 1 stop-recursion, 2 defer-to-generic.
namespace {

struct PickResult {
  int64_t split_l, split_a, split_b;
  double pvalue;  // set when status==1 because of the p-gate, else -1
};

int pick_pairwise_dp(const int64_t* ls_in, const int64_t* aa_in,
                     const int64_t* bb_in, int64_t k,
                     const int64_t* seq_starts, const int64_t* seq_sids,
                     int64_t nseq, const int64_t* left_off,
                     const int64_t* right_off, int64_t nsid, int do_trim,
                     int64_t maxmums, int64_t wscore, double wpen,
                     int64_t seedsize, double pcutoff, int64_t minlength,
                     PickResult* out, int64_t* skip_buf /* (2, k, 3) */,
                     int64_t* skip_counts /* [nleft, nright] */,
                     double* skip_scores /* (2, k) */) {
  const int64_t MISSING = INT64_MIN;
  const int64_t skip_stride = k;  // caller allocates (2, k_orig, 3)
  skip_counts[0] = skip_counts[1] = 0;
  out->pvalue = -1;
  if (k == 0) return 1;

  std::vector<int64_t> L(ls_in, ls_in + k);
  std::vector<int64_t> A(aa_in, aa_in + k);
  std::vector<int64_t> B(bb_in, bb_in + k);

  if (do_trim) {
    std::vector<int64_t> P(2 * k);
    for (int64_t i = 0; i < k; ++i) {
      P[2 * i] = A[i];
      P[2 * i + 1] = B[i];
    }
    std::vector<int64_t> tord(k);
    int64_t nk = trim_overlap_dp(L.data(), P.data(), k, 2, tord.data());
    if (nk == 0) return 1;
    std::vector<int64_t> L2(nk), A2(nk), B2(nk);
    for (int64_t i = 0; i < nk; ++i) {
      L2[i] = L[tord[i]];
      A2[i] = P[2 * tord[i]];
      B2[i] = P[2 * tord[i] + 1];
    }
    L.swap(L2);
    A.swap(A2);
    B.swap(B2);
    k = nk;
  }

  // stable sort by l ascending (the generic path's two stable list
  // sorts — l desc, then (n, l) asc with n constant — compose to this)
  std::vector<int64_t> ord(k);
  for (int64_t i = 0; i < k; ++i) ord[i] = i;
  std::stable_sort(ord.begin(), ord.end(),
                   [&](int64_t x, int64_t y) { return L[x] < L[y]; });

  auto seq_of = [&](int64_t p) -> int64_t {
    int64_t lo = 0, hi = nseq;  // last seq_start <= p
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (seq_starts[mid] <= p) lo = mid + 1;
      else hi = mid;
    }
    return lo - 1;
  };

  // target pair = sequence pair of the last (max-l) mum
  const int64_t last = ord[k - 1];
  const int64_t ta = seq_sids[seq_of(A[last])];
  const int64_t tb = seq_sids[seq_of(B[last])];

  std::vector<int64_t> fl, fa, fb, foa, fob;
  fl.reserve(k);
  fa.reserve(k);
  fb.reserve(k);
  foa.reserve(k);
  fob.reserve(k);
  for (int64_t i = 0; i < k; ++i) {
    const int64_t m = ord[i];
    const int64_t sa_ = seq_of(A[m]);
    const int64_t sb_ = seq_of(B[m]);
    if (seq_sids[sa_] != ta || seq_sids[sb_] != tb) continue;
    fl.push_back(L[m]);
    fa.push_back(A[m]);
    fb.push_back(B[m]);
    foa.push_back(A[m] - seq_starts[sa_]);
    fob.push_back(B[m] - seq_starts[sb_]);
  }
  int64_t n = (int64_t)fl.size();
  if (n == 0) return 1;

  if (ta < 0 || ta >= nsid || tb < 0 || tb >= nsid) return 2;
  const int64_t la_ = left_off[ta];
  const int64_t lb_ = left_off[tb];
  const int64_t ra_ = right_off[ta];
  const int64_t rb_ = right_off[tb];
  if (la_ == MISSING || lb_ == MISSING || ra_ == MISSING ||
      rb_ == MISSING) {
    return 2;
  }

  int64_t split_i;  // index into fl/fa/fb
  if (n == 1) {
    split_i = 0;
  } else {
    if (n > maxmums) {
      const int64_t off = n - maxmums;
      fl.erase(fl.begin(), fl.begin() + off);
      fa.erase(fa.begin(), fa.begin() + off);
      fb.erase(fb.begin(), fb.begin() + off);
      foa.erase(foa.begin(), foa.begin() + off);
      fob.erase(fob.begin(), fob.begin() + off);
      n = maxmums;
    }
    // chain candidates: mums + right, stable-sorted by the ref offset
    std::vector<int64_t> co(n + 1);
    for (int64_t i = 0; i <= n; ++i) co[i] = i;
    std::vector<int64_t> roff(n + 1);
    for (int64_t i = 0; i < n; ++i) roff[i] = foa[i];
    roff[n] = ra_;
    std::stable_sort(co.begin(), co.end(), [&](int64_t x, int64_t y) {
      return roff[x] < roff[y];
    });
    for (int64_t i = 0; i < n; ++i) {
      if (roff[co[i]] == roff[co[i + 1]]) return 2;  // ref-start alias
    }
    std::vector<int64_t> starts(2 * (n + 1)), lens(n + 1), nmul(n + 1);
    int64_t pos_r = -1;
    for (int64_t i = 0; i <= n; ++i) {
      const int64_t m = co[i];
      if (m == n) {
        starts[2 * i] = ra_;
        starts[2 * i + 1] = rb_;
        lens[i] = 0;
        nmul[i] = 0;
        pos_r = i;
      } else {
        starts[2 * i] = foa[m];
        starts[2 * i + 1] = fob[m];
        lens[i] = fl[m];
        nmul[i] = wscore * fl[m];
      }
    }
    const int64_t left_start[2] = {la_, lb_};
    std::vector<int64_t> link(n + 1);
    std::vector<double> scores(n + 1);
    chain_dp(starts.data(), lens.data(), nmul.data(), n + 1, 2,
             left_start, wpen, link.data(), scores.data());
    for (int64_t i = 0; i <= n; ++i) {
      if (link[i] == -2) return 2;
    }
    // walk from right, then reverse -> left-to-right, right excluded
    std::vector<int64_t> path;
    int64_t s = pos_r;
    while (true) {
      path.push_back(s);
      if (link[s] < 0) break;
      s = link[s];
    }
    if (path.size() <= 1) return 1;
    std::vector<int64_t> chained(path.begin() + 1, path.end());
    std::reverse(chained.begin(), chained.end());
    // "largest": max l, ties -> latest in chain order
    size_t best_j = 0;
    for (size_t j = 1; j < chained.size(); ++j) {
      if (lens[chained[j]] >= lens[chained[best_j]]) best_j = j;
    }
    const int64_t split_slot = chained[best_j];
    split_i = co[split_slot];

    if (seedsize > 0) {
      int side = 0;  // 0 = left list, 1 = right list
      double scoreatsplit = 0.0;
      for (size_t j = 0; j < chained.size(); ++j) {
        const int64_t slot = chained[j];
        if (slot == split_slot) {
          scoreatsplit = scores[slot];
          side = 1;
          continue;
        }
        if (lens[slot] >= seedsize) {
          const int64_t m = co[slot];
          int64_t& cnt = skip_counts[side];
          int64_t* row = skip_buf + (side * skip_stride + cnt) * 3;
          row[0] = fl[m];
          row[1] = fa[m];
          row[2] = fb[m];
          skip_scores[side * skip_stride + cnt] =
              scores[slot] - scoreatsplit;
          ++cnt;
        }
      }
    }
  }

  out->split_l = fl[split_i];
  out->split_a = fa[split_i];
  out->split_b = fb[split_i];

  if (minlength == 0) {
    // o is an exact integer in the reference (python int); compute it
    // exactly, then round once to double like float(o)
    const __int128 oi =
        (__int128)(ra_ - la_) * (__int128)(rb_ - lb_);
    const double o = (double)oi;
    const double l = (double)fl[split_i];
    double p = std::pow(0.25, l);
    if (p > 0) p = 1.0 - std::exp(std::log(1.0 - p) * o);
    if (p > pcutoff) {
      out->pvalue = p;
      return 1;
    }
  }
  return 0;
}

// d-dim generalization of the pick for multi-genome segments
// (graphmumpicker, schemes.py:197-358): multiMUMs arrive as ragged
// (l, width, coords...) rows in the (l, lb, ub) lexsort order the tuple
// path uses.  Handles the nsamples width filter, the genome-subset
// fallback (schemes.segment, :107-124), d-dim trim, arithmetic offset
// map, target-key-set filter, maxmums cap, d-dim chain DP, largest
// split, seed skip lists.  Defers (status 2) on: p-gate with width > 2
// (the reference computes the search space as an exact big int), missing
// boundary offsets, ref-start aliases.  Returns 0 ok / 1 stop / 2 defer.
// Outputs: split row (w coords) written to split_coords (+ split_l/width
// via out_hdr = [l, w]); skip lists as rows of (l, w coords) with scores.
int pick_multi_dp(const int64_t* ls_in, const int64_t* ws_in,
                  const int64_t* coords_in /* ragged, offs_in */,
                  const int64_t* offs_in, int64_t k, int64_t nsamples_seg,
                  const int64_t* seq_starts, const int64_t* seq_sids,
                  int64_t nseq, const uint16_t* SO,
                  const int64_t* left_off, const int64_t* right_off,
                  int64_t nsid, int do_trim, int64_t maxmums,
                  int64_t wscore, double wpen, int64_t seedsize,
                  double pcutoff, int64_t minlength, int64_t skip_rowlen,
                  int64_t* out_hdr, int64_t* split_coords,
                  double* pvalue_out, int64_t* skip_buf,
                  int64_t* skip_counts, double* skip_scores) {
  const int64_t MISSING = INT64_MIN;
  skip_counts[0] = skip_counts[1] = 0;
  *pvalue_out = -1;
  if (k == 0) return 1;

  // width filter: mums spanning all of this segment's samples
  std::vector<int64_t> sel;
  sel.reserve(k);
  for (int64_t i = 0; i < k; ++i) {
    if (ws_in[i] == nsamples_seg) sel.push_back(i);
  }
  if (sel.empty() && nsamples_seg > 2) {
    // genome-subset fallback: maximize sum(l) * |subset| over the
    // per-mum sorted sample-ordinal signature; ties keep the first-seen
    // subset (dict insertion order in the reference)
    std::vector<std::vector<int64_t>> keys;
    std::vector<std::vector<int64_t>> groups;
    std::vector<int64_t> sums;
    for (int64_t i = 0; i < k; ++i) {
      std::vector<int64_t> sig;
      for (int64_t c = offs_in[i]; c < offs_in[i + 1]; ++c)
        sig.push_back((int64_t)SO[coords_in[c]]);
      std::sort(sig.begin(), sig.end());
      size_t g = 0;
      for (; g < keys.size(); ++g)
        if (keys[g] == sig) break;
      if (g == keys.size()) {
        keys.push_back(sig);
        groups.emplace_back();
        sums.push_back(0);
      }
      groups[g].push_back(i);
      sums[g] += ls_in[i];
    }
    int64_t best = 0;
    int64_t bg = -1;
    for (size_t g = 0; g < keys.size(); ++g) {
      const int64_t z = sums[g] * (int64_t)keys[g].size();
      if (z > best) {
        best = z;
        bg = (int64_t)g;
      }
    }
    if (bg < 0) return 1;
    sel = groups[bg];
  }
  if (sel.empty()) return 1;

  // all selected mums share one width
  const int64_t w = ws_in[sel[0]];
  for (int64_t i : sel) {
    if (ws_in[i] != w) return 2;  // mixed widths cannot happen; defer
  }
  int64_t n = (int64_t)sel.size();

  std::vector<int64_t> L(n);
  std::vector<int64_t> C(n * w);  // SA-order positions
  for (int64_t i = 0; i < n; ++i) {
    L[i] = ls_in[sel[i]];
    const int64_t o = offs_in[sel[i]];
    for (int64_t c = 0; c < w; ++c) C[i * w + c] = coords_in[o + c];
  }

  if (do_trim) {
    std::vector<int64_t> tord(n);
    const int64_t nk = trim_overlap_dp(L.data(), C.data(), n, w,
                                       tord.data());
    if (nk == 0) return 1;
    std::vector<int64_t> L2(nk), C2(nk * w);
    for (int64_t i = 0; i < nk; ++i) {
      L2[i] = L[tord[i]];
      for (int64_t c = 0; c < w; ++c)
        C2[i * w + c] = C[tord[i] * w + c];
    }
    L.swap(L2);
    C.swap(C2);
    n = nk;
  }

  // the generic path's two stable list sorts (l desc, then (n, l) asc
  // with n = width constant across survivors) compose to one stable
  // ascending sort by l
  std::vector<int64_t> ord(n);
  for (int64_t i = 0; i < n; ++i) ord[i] = i;
  std::stable_sort(ord.begin(), ord.end(),
                   [&](int64_t x, int64_t y) { return L[x] < L[y]; });

  auto seq_of = [&](int64_t p) -> int64_t {
    int64_t lo = 0, hi = nseq;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (seq_starts[mid] <= p) lo = mid + 1;
      else hi = mid;
    }
    return lo - 1;
  };

  // per-mum sid rows in position order; target = last mum's sid SET
  std::vector<int64_t> sids(n * w);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t c = 0; c < w; ++c)
      sids[i * w + c] = seq_sids[seq_of(C[i * w + c])];

  const int64_t last = ord[n - 1];
  std::vector<int64_t> target(sids.begin() + last * w,
                              sids.begin() + (last + 1) * w);
  std::vector<int64_t> tsorted(target);
  std::sort(tsorted.begin(), tsorted.end());
  if (std::unique(tsorted.begin(), tsorted.end()) != tsorted.end())
    return 2;  // duplicate path ids within one mum: defer

  std::vector<int64_t> keep;
  keep.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t m = ord[i];
    std::vector<int64_t> s(sids.begin() + m * w,
                           sids.begin() + (m + 1) * w);
    std::sort(s.begin(), s.end());
    if (s == tsorted) keep.push_back(m);
  }
  n = (int64_t)keep.size();
  if (n == 0) return 1;

  // boundary offsets for the target dims (keyed by sid, so dimension
  // order is irrelevant except for the ref dim choice below)
  for (int64_t sid : target) {
    if (sid < 0 || sid >= nsid || left_off[sid] == MISSING ||
        right_off[sid] == MISSING) {
      return 2;
    }
  }

  // compact to filtered order with per-dim offsets keyed by sid
  std::vector<int64_t> fl(n), fc(n * w);
  std::vector<int64_t> foff(n * w);  // offset in dim order of each mum
  for (int64_t i = 0; i < n; ++i) {
    const int64_t m = keep[i];
    fl[i] = L[m];
    for (int64_t c = 0; c < w; ++c) {
      const int64_t p = C[m * w + c];
      fc[i * w + c] = p;
      foff[i * w + c] = p - seq_starts[seq_of(p)];
    }
  }

  int64_t split_i;
  if (n == 1) {
    split_i = 0;
  } else {
    if (n > maxmums) {
      const int64_t off = n - maxmums;
      fl.erase(fl.begin(), fl.begin() + off);
      fc.erase(fc.begin(), fc.begin() + off * w);
      foff.erase(foff.begin(), foff.begin() + off * w);
      // sids rows follow keep/ord; re-derive below as needed
      n = maxmums;
    }
    // ref dim = first coordinate's sid of the first filtered mum
    const int64_t ref_sid = seq_sids[seq_of(fc[0])];
    // canonical dim order for the DP: the first mum's sid order (any
    // fixed order works — sumofpairs is dim-symmetric; only ref matters)
    std::vector<int64_t> dims(w);
    for (int64_t c = 0; c < w; ++c)
      dims[c] = seq_sids[seq_of(fc[c])];
    std::vector<int64_t> dimpos(nsid, -1);
    for (int64_t c = 0; c < w; ++c) dimpos[dims[c]] = c;
    int64_t refdim = dimpos[ref_sid];

    // per-mum offsets arranged in the canonical dim order
    std::vector<int64_t> starts((n + 1) * w);
    std::vector<int64_t> lens(n + 1), nmul(n + 1);
    for (int64_t i = 0; i < n; ++i) {
      for (int64_t c = 0; c < w; ++c) {
        const int64_t sid = seq_sids[seq_of(fc[i * w + c])];
        starts[i * w + dimpos[sid]] = foff[i * w + c];
      }
      lens[i] = fl[i];
      nmul[i] = wscore * fl[i] * ((w * (w - 1)) / 2);
    }
    for (int64_t c = 0; c < w; ++c)
      starts[n * w + c] = right_off[dims[c]];
    lens[n] = 0;
    nmul[n] = 0;

    // stable sort by the ref dim, right (index n) appended last
    std::vector<int64_t> co(n + 1);
    for (int64_t i = 0; i <= n; ++i) co[i] = i;
    std::stable_sort(co.begin(), co.end(), [&](int64_t x, int64_t y) {
      return starts[x * w + refdim] < starts[y * w + refdim];
    });
    for (int64_t i = 0; i < n; ++i) {
      if (starts[co[i] * w + refdim] == starts[co[i + 1] * w + refdim])
        return 2;  // ref-start alias: defer
    }
    std::vector<int64_t> sstarts((n + 1) * w), slens(n + 1),
        snmul(n + 1);
    int64_t pos_r = -1;
    for (int64_t i = 0; i <= n; ++i) {
      const int64_t m = co[i];
      for (int64_t c = 0; c < w; ++c)
        sstarts[i * w + c] = starts[m * w + c];
      slens[i] = lens[m];
      snmul[i] = nmul[m];
      if (m == n) pos_r = i;
    }
    std::vector<int64_t> left_start(w);
    for (int64_t c = 0; c < w; ++c) left_start[c] = left_off[dims[c]];
    std::vector<int64_t> link(n + 1);
    std::vector<double> scores(n + 1);
    chain_dp(sstarts.data(), slens.data(), snmul.data(), n + 1, w,
             left_start.data(), wpen, link.data(), scores.data());
    for (int64_t i = 0; i <= n; ++i) {
      if (link[i] == -2) return 2;
    }
    std::vector<int64_t> path;
    int64_t s = pos_r;
    while (true) {
      path.push_back(s);
      if (link[s] < 0) break;
      s = link[s];
    }
    if (path.size() <= 1) return 1;
    std::vector<int64_t> chained(path.begin() + 1, path.end());
    std::reverse(chained.begin(), chained.end());
    size_t best_j = 0;
    for (size_t j = 1; j < chained.size(); ++j) {
      if (slens[chained[j]] >= slens[chained[best_j]]) best_j = j;
    }
    const int64_t split_slot = chained[best_j];
    split_i = co[split_slot];

    if (seedsize > 0) {
      const int64_t stride = k;  // caller allocates (2, k_orig, rowlen)
      int side = 0;
      double scoreatsplit = 0.0;
      for (size_t j = 0; j < chained.size(); ++j) {
        const int64_t slot = chained[j];
        if (slot == split_slot) {
          scoreatsplit = scores[slot];
          side = 1;
          continue;
        }
        if (slens[slot] >= seedsize) {
          const int64_t m = co[slot];
          int64_t& cnt = skip_counts[side];
          int64_t* row =
              skip_buf + (side * stride + cnt) * skip_rowlen;
          row[0] = fl[m];
          for (int64_t c = 0; c < w; ++c) row[1 + c] = fc[m * w + c];
          skip_scores[side * stride + cnt] =
              scores[slot] - scoreatsplit;
          ++cnt;
        }
      }
    }
  }

  out_hdr[0] = fl[split_i];
  out_hdr[1] = w;
  for (int64_t c = 0; c < w; ++c)
    split_coords[c] = fc[split_i * w + c];

  if (minlength == 0) {
    if (w > 2) return 2;  // exact big-int search space: defer
    const int64_t ta = seq_sids[seq_of(split_coords[0])];
    const int64_t tb = seq_sids[seq_of(split_coords[1])];
    const __int128 oi = (__int128)(right_off[ta] - left_off[ta]) *
                        (__int128)(right_off[tb] - left_off[tb]);
    const double o = (double)oi;
    const double l = (double)fl[split_i];
    double p = std::pow(std::pow(0.25, (double)(w - 1)), l);
    if (p > 0) p = 1.0 - std::exp(std::log(1.0 - p) * o);
    if (p > pcutoff) {
      *pvalue_out = p;
      return 1;
    }
  }
  return 0;
}

}  // namespace

// ---- whole pairwise recursion in one native call ----------------------
//
// The _align_loop fast case (align/rem.py): 2 samples, one sequence
// each, largest/sumofpairs picker, no seeding, no maxdepth/maxsize.
// Runs the complete LIFO recursion (pop -> premums/enumerate -> pick ->
// split3+repair+child-enum -> push trailing/leading) without returning
// to Python, and appends one record per anchor IN POP ORDER:
//
//   [ma, mb, l, aBeg, aEnd, bBeg, bEnd]
//
// (aBeg,aEnd)/(bBeg,bEnd) are the segment's live intervals at pick
// time, which are exactly the unaligned graph nodes the per-step path
// would breaknode — the Python replay (align/rem._rem2_replay) applies
// breaknode/mergenodes for these records in the same order and
// reproduces the incremental engine's graph byte-for-byte, with no
// segmentgraph/BFS work.  Boundary offsets for the pick are arithmetic
// (left = anchor end offsets - 1, right = next anchor start offsets;
// schemes.py:197-361 via align/picker.pick_pairwise semantics).
// Mutates T (matched-text lowercase) and SAi exactly like the per-step
// path; SA/LCP of the root are read-only.  Returns the anchor count,
// or -1 on a pick defer (ref-start alias) — the caller restores its
// T/SAi snapshots and falls back to the per-step loop.
namespace {

struct Rem2Block {
  void* p;
  int refs;
};

template <typename Index>
struct Rem2Seg {
  Index *sa, *lcp;       // views into blk (null blk for the root)
  Rem2Block* blk;        // refcounted split buffer shared by siblings
  int64_t n;
  int64_t aBeg, aEnd, bBeg, bEnd;  // text coords of the live intervals
  int64_t la, lb, ra, rb;          // boundary PATH offsets
  Index *mums;           // owned (ml|ma|mb packed), null = enumerate
  int64_t nmum;
};

template <typename Index>
int64_t rem2_loop(uint8_t* T, const Index* SA, const Index* LCP,
                  Index* SAi, int64_t n, int64_t nsep0, int64_t minlength,
                  int do_trim, int64_t maxmums, int64_t wscore,
                  double wpen, double pcutoff, int64_t** out_anchors,
                  // defer_max > 0: segments whose candidate count is
                  // <= defer_max are NOT recursed into; instead a
                  // placeholder record {defer_id, -1, -1, bounds} goes
                  // into the anchor stream (marking the serial pop
                  // position) and the segment's state is appended to
                  // *out_defer as [n, k, aBeg, aEnd, bBeg, bEnd, SA[n],
                  // LCP[n]] — the device whole-recursion kernel takes
                  // the deferred forest as its level-0 frontier.
                  int64_t defer_max = 0,
                  std::vector<int64_t>* out_defer = nullptr) {
  const int64_t lenA = nsep0;              // A = T[0, nsep0), '$' at nsep0
  const int64_t lenB = n - nsep0 - 2;      // B = T[nsep0+1, n-1)
  const int64_t bOff = nsep0 + 1;          // B text start
  const int64_t seq_starts[2] = {0, bOff};
  const int64_t seq_sids[2] = {0, 1};

  std::vector<int64_t> anchors;  // flat (k, 7)
  std::vector<Rem2Seg<Index>> stack;
  std::vector<int64_t> l64, a64, b64;       // pick scratch (int64 view)
  std::vector<Index> eml, ema, emb;         // enum scratch
  int64_t skip_counts[2];
  int64_t n_defer = 0;

  stack.push_back(Rem2Seg<Index>{nullptr, nullptr, nullptr, n, 0, lenA,
                                 bOff, bOff + lenB, -1, -1, lenA, lenB,
                                 nullptr, -1});
  auto seg_free = [](Rem2Seg<Index>& s) {
    if (s.blk && --s.blk->refs == 0) {
      std::free(s.blk->p);
      delete s.blk;
    }
    std::free(s.mums);
  };
  auto fail = [&]() -> int64_t {
    for (auto& s : stack) seg_free(s);
    return -1;
  };

  while (!stack.empty()) {
    Rem2Seg<Index> seg = stack.back();
    stack.pop_back();
    const Index* ssa = seg.sa ? seg.sa : SA;
    const Index* slcp = seg.lcp ? seg.lcp : LCP;

    // candidates: parent's fused enumeration, or enumerate now (root)
    int64_t k;
    const Index *cl, *ca, *cb;
    if (seg.nmum >= 0) {
      k = seg.nmum;
      cl = seg.mums;
      ca = seg.mums + k;
      cb = seg.mums + 2 * k;
    } else {
      if ((int64_t)eml.size() < seg.n) {
        eml.resize(seg.n);
        ema.resize(seg.n);
        emb.resize(seg.n);
      }
      k = seg.n > 1 ? pairwise_mums(T, ssa, slcp, seg.n, nsep0, minlength,
                                    0, (int64_t)0, eml.data(), ema.data(),
                                    emb.data())
                    : 0;
      cl = eml.data();
      ca = ema.data();
      cb = emb.data();
    }
    if (k == 0) {
      seg_free(seg);
      continue;
    }

    if (defer_max > 0 && k <= defer_max && out_defer != nullptr) {
      const int64_t did = n_defer++;
      anchors.insert(anchors.end(), {did, -1, -1, seg.aBeg, seg.aEnd,
                                     seg.bBeg, seg.bEnd});
      out_defer->insert(out_defer->end(),
                        {seg.n, k, seg.aBeg, seg.aEnd, seg.bBeg,
                         seg.bEnd});
      for (int64_t i = 0; i < seg.n; i++)
        out_defer->push_back((int64_t)ssa[i]);
      for (int64_t i = 0; i < seg.n; i++)
        out_defer->push_back((int64_t)slcp[i]);
      seg_free(seg);
      continue;
    }

    l64.assign(cl, cl + k);
    a64.assign(ca, ca + k);
    b64.assign(cb, cb + k);
    const int64_t left_off[2] = {seg.la, seg.lb};
    const int64_t right_off[2] = {seg.ra, seg.rb};
    PickResult pr;
    const int st = pick_pairwise_dp(
        l64.data(), a64.data(), b64.data(), k, seq_starts, seq_sids, 2,
        left_off, right_off, 2, do_trim, maxmums, wscore, wpen,
        /*seedsize=*/0, pcutoff, minlength, &pr, nullptr, skip_counts,
        nullptr);
    if (st == 2) {
      seg_free(seg);
      return fail();
    }
    if (st == 1) {
      seg_free(seg);
      continue;
    }
    const int64_t ma = pr.split_a, mb = pr.split_b, l = pr.split_l;
    anchors.insert(anchors.end(), {ma, mb, l, seg.aBeg, seg.aEnd,
                                   seg.bBeg, seg.bEnd});

    // split: leading [aBeg,ma)+[bBeg,mb) | trailing [ma+l,aEnd)+
    // [mb+l,bEnd) | matched (lowercased); fused child enumeration
    const int64_t iv[6 * 3] = {
        seg.aBeg, ma,      1, seg.bBeg, mb,      1,
        ma + l,   seg.aEnd, 2, mb + l,   seg.bEnd, 2,
        ma,       ma + l,   3, mb,       mb + l,   3,
    };
    const int64_t matches[4] = {ma, l, mb, l};
    Index* sa_buf = (Index*)std::malloc(
        (size_t)seg.n * 2 * sizeof(Index));
    Index* lcp_buf = sa_buf + seg.n;
    if ((int64_t)eml.size() < seg.n) {
      eml.resize(seg.n);
      ema.resize(seg.n);
      emb.resize(seg.n);
    }
    int64_t out_n[5];
    split3_repair_enum(ssa, slcp, seg.n, SAi, iv, (int64_t)6, T, matches,
                       (int64_t)2, nsep0, minlength, 1, 1, sa_buf, lcp_buf,
                       eml.data(), ema.data(), emb.data(), out_n);
    const int64_t c1 = out_n[0], c2 = out_n[1];
    const int64_t m1 = out_n[3] > 0 ? out_n[3] : 0;
    const int64_t m2 = out_n[4] > 0 ? out_n[4] : 0;

    // child boundary offsets (path coords): the matched node's offsets;
    // children take refcounted views of the split buffer (no memcpy)
    const int64_t offa = ma, offb = mb - bOff;
    Rem2Block* blk = nullptr;
    if (c1 > 0 || c2 > 0) {
      blk = new Rem2Block{sa_buf, (c1 > 0) + (c2 > 0)};
    } else {
      std::free(sa_buf);
    }
    Rem2Seg<Index> lead{sa_buf,  lcp_buf, blk,  c1,   seg.aBeg, ma,
                        seg.bBeg, mb,     seg.la, seg.lb, offa, offb,
                        nullptr, m1};
    Rem2Seg<Index> trail{sa_buf + c1,  lcp_buf + c1, blk,
                         c2,           ma + l,       seg.aEnd,
                         mb + l,       seg.bEnd,     offa + l - 1,
                         offb + l - 1, seg.ra,       seg.rb,
                         nullptr,      m2};
    if (c1 > 0 && m1 > 0) {
      lead.mums = (Index*)std::malloc((size_t)(3 * m1) * sizeof(Index));
      std::memcpy(lead.mums, eml.data(), (size_t)m1 * sizeof(Index));
      std::memcpy(lead.mums + m1, ema.data(), (size_t)m1 * sizeof(Index));
      std::memcpy(lead.mums + 2 * m1, emb.data(),
                  (size_t)m1 * sizeof(Index));
    }
    if (c2 > 0 && m2 > 0) {
      trail.mums = (Index*)std::malloc((size_t)(3 * m2) * sizeof(Index));
      std::memcpy(trail.mums, eml.data() + m1, (size_t)m2 * sizeof(Index));
      std::memcpy(trail.mums + m2, ema.data() + m1,
                  (size_t)m2 * sizeof(Index));
      std::memcpy(trail.mums + 2 * m2, emb.data() + m1,
                  (size_t)m2 * sizeof(Index));
    }
    seg_free(seg);
    // push order: (parallel: none), leading, trailing -> trailing pops
    // first (reveal.c:1295-1324 via align/rem._align_loop)
    if (c1 > 0) stack.push_back(lead);
    if (c2 > 0) stack.push_back(trail);
  }

  const int64_t na = (int64_t)anchors.size() / 7;
  int64_t* out = (int64_t*)std::malloc(
      (size_t)(anchors.size() ? anchors.size() : 1) * sizeof(int64_t));
  std::memcpy(out, anchors.data(), anchors.size() * sizeof(int64_t));
  *out_anchors = out;
  return na;
}

// ---- parallel dispatch -------------------------------------------------
//
// Same recursion, executed by a C thread pool over a shared LIFO.  The
// anchor SET is a pure function of each segment in isolation (every
// pick reads only its own segment's SA/LCP/candidates plus text whose
// case bits were fixed before the segment existed: T[a-1] at a segment
// edge is always an ancestor's already-lowercased match or the text
// start), and sibling subtrees mutate disjoint SAi entries / text
// intervals — so any execution order yields the serial anchors.  The
// serial POP ORDER (which the graph replay needs for byte-identical
// output) is reconstructed afterwards from the recorded recursion tree
// by simulating the serial stack.  No GIL, no Python: near-linear on
// the early large segments, which carry most of the scan work.

template <typename Index>
struct Rem2Par {
  uint8_t* T;
  const Index* SA;
  const Index* LCP;
  Index* SAi;
  int64_t n, nsep0, bOff, minlength, maxmums, wscore;
  int do_trim;
  double wpen, pcutoff;

  struct Node {
    int64_t rec[7];
    int64_t lead_id = -1, trail_id = -1;
    bool has_anchor = false;
    // deferred segment (candidate count <= defer_max): frozen state
    // for the device forest, flat [n, k, aBeg, aEnd, bBeg, bEnd,
    // SA[n], LCP[n]] — same layout as the serial rem2_loop defer
    bool has_defer = false;
    std::vector<int64_t> defer;
  };
  std::vector<Node> nodes;
  int64_t defer_max = 0;
  std::vector<Rem2Seg<Index>> stack;  // Rem2Seg.nmum<0: enumerate
  std::vector<int64_t> seg_ids;       // parallel to stack
  std::mutex mu;
  std::condition_variable cv;
  int64_t active = 0;
  int64_t next_id = 0;
  bool abort_flag = false;

  void worker() {
    std::vector<int64_t> l64, a64, b64;
    std::vector<Index> eml, ema, emb;
    int64_t skip_counts[2];
    const int64_t seq_starts[2] = {0, bOff};
    const int64_t seq_sids[2] = {0, 1};
    auto seg_free = [](Rem2Seg<Index>& s) {
      if (s.blk && --s.blk->refs == 0) {
        std::free(s.blk->p);
        delete s.blk;
      }
      std::free(s.mums);
    };
    std::unique_lock<std::mutex> lk(mu);
    while (true) {
      while (stack.empty() && active > 0 && !abort_flag) cv.wait(lk);
      if (abort_flag || stack.empty()) return;
      Rem2Seg<Index> seg = stack.back();
      stack.pop_back();
      const int64_t seg_id = seg_ids.back();
      seg_ids.pop_back();
      ++active;
      lk.unlock();

      // ---- process one segment (identical to the serial body) ----
      const Index* ssa = seg.sa ? seg.sa : SA;
      const Index* slcp = seg.lcp ? seg.lcp : LCP;
      int64_t k;
      const Index *cl, *ca, *cb;
      if (seg.nmum >= 0) {
        k = seg.nmum;
        cl = seg.mums;
        ca = seg.mums + k;
        cb = seg.mums + 2 * k;
      } else {
        if ((int64_t)eml.size() < seg.n) {
          eml.resize(seg.n);
          ema.resize(seg.n);
          emb.resize(seg.n);
        }
        k = seg.n > 1
                ? pairwise_mums(T, ssa, slcp, seg.n, nsep0, minlength, 0,
                                (int64_t)0, eml.data(), ema.data(),
                                emb.data())
                : 0;
        cl = eml.data();
        ca = ema.data();
        cb = emb.data();
      }
      if (defer_max > 0 && k > 0 && k <= defer_max) {
        // same condition as the serial rem2_loop: freeze this
        // segment's state for the device forest; the placeholder id
        // is assigned later, during the serial-pop-order walk
        std::vector<int64_t> pay;
        pay.reserve((size_t)(6 + 2 * seg.n));
        pay.insert(pay.end(), {seg.n, k, seg.aBeg, seg.aEnd, seg.bBeg,
                               seg.bEnd});
        for (int64_t i = 0; i < seg.n; i++)
          pay.push_back((int64_t)ssa[i]);
        for (int64_t i = 0; i < seg.n; i++)
          pay.push_back((int64_t)slcp[i]);
        const int64_t sb[4] = {seg.aBeg, seg.aEnd, seg.bBeg, seg.bEnd};
        seg_free(seg);
        lk.lock();
        --active;
        if ((int64_t)nodes.size() <= seg_id) nodes.resize(seg_id + 1);
        Node& nd = nodes[seg_id];
        nd.has_defer = true;
        nd.defer = std::move(pay);
        nd.rec[3] = sb[0];
        nd.rec[4] = sb[1];
        nd.rec[5] = sb[2];
        nd.rec[6] = sb[3];
        cv.notify_all();
        continue;
      }
      int st = 1;
      PickResult pr;
      if (k > 0) {
        l64.assign(cl, cl + k);
        a64.assign(ca, ca + k);
        b64.assign(cb, cb + k);
        const int64_t left_off[2] = {seg.la, seg.lb};
        const int64_t right_off[2] = {seg.ra, seg.rb};
        st = pick_pairwise_dp(l64.data(), a64.data(), b64.data(), k,
                              seq_starts, seq_sids, 2, left_off, right_off,
                              2, do_trim, maxmums, wscore, wpen,
                              /*seedsize=*/0, pcutoff, minlength, &pr,
                              nullptr, skip_counts, nullptr);
      }
      Rem2Seg<Index> lead{}, trail{};
      int64_t c1 = 0, c2 = 0;
      if (st == 0) {
        const int64_t ma = pr.split_a, mb = pr.split_b, l = pr.split_l;
        const int64_t iv[6 * 3] = {
            seg.aBeg, ma,       1, seg.bBeg, mb,       1,
            ma + l,   seg.aEnd, 2, mb + l,   seg.bEnd, 2,
            ma,       ma + l,   3, mb,       mb + l,   3,
        };
        const int64_t matches[4] = {ma, l, mb, l};
        Index* sa_buf =
            (Index*)std::malloc((size_t)seg.n * 2 * sizeof(Index));
        Index* lcp_buf = sa_buf + seg.n;
        if ((int64_t)eml.size() < seg.n) {
          eml.resize(seg.n);
          ema.resize(seg.n);
          emb.resize(seg.n);
        }
        int64_t out_n[5];
        split3_repair_enum(ssa, slcp, seg.n, SAi, iv, (int64_t)6, T,
                           matches, (int64_t)2, nsep0, minlength, 1, 1,
                           sa_buf, lcp_buf, eml.data(), ema.data(),
                           emb.data(), out_n);
        c1 = out_n[0];
        c2 = out_n[1];
        const int64_t m1 = out_n[3] > 0 ? out_n[3] : 0;
        const int64_t m2 = out_n[4] > 0 ? out_n[4] : 0;
        const int64_t offa = ma, offb = mb - bOff;
        Rem2Block* blk = nullptr;
        if (c1 > 0 || c2 > 0) {
          blk = new Rem2Block{sa_buf, (c1 > 0) + (c2 > 0)};
        } else {
          std::free(sa_buf);
        }
        lead = Rem2Seg<Index>{sa_buf,  lcp_buf, blk,  c1,
                              seg.aBeg, ma,     seg.bBeg, mb,
                              seg.la,  seg.lb,  offa, offb,
                              nullptr, m1};
        trail = Rem2Seg<Index>{sa_buf + c1,  lcp_buf + c1, blk,
                               c2,           ma + l,       seg.aEnd,
                               mb + l,       seg.bEnd,     offa + l - 1,
                               offb + l - 1, seg.ra,       seg.rb,
                               nullptr,      m2};
        if (c1 > 0 && m1 > 0) {
          lead.mums =
              (Index*)std::malloc((size_t)(3 * m1) * sizeof(Index));
          std::memcpy(lead.mums, eml.data(), (size_t)m1 * sizeof(Index));
          std::memcpy(lead.mums + m1, ema.data(),
                      (size_t)m1 * sizeof(Index));
          std::memcpy(lead.mums + 2 * m1, emb.data(),
                      (size_t)m1 * sizeof(Index));
        }
        if (c2 > 0 && m2 > 0) {
          trail.mums =
              (Index*)std::malloc((size_t)(3 * m2) * sizeof(Index));
          std::memcpy(trail.mums, eml.data() + m1,
                      (size_t)m2 * sizeof(Index));
          std::memcpy(trail.mums + m2, ema.data() + m1,
                      (size_t)m2 * sizeof(Index));
          std::memcpy(trail.mums + 2 * m2, emb.data() + m1,
                      (size_t)m2 * sizeof(Index));
        }
      }
      seg_free(seg);

      lk.lock();
      --active;
      if (st == 2) {
        abort_flag = true;
        if (c1 > 0) seg_free(lead);
        if (c2 > 0) seg_free(trail);
        cv.notify_all();
        return;
      }
      if ((int64_t)nodes.size() <= seg_id) nodes.resize(seg_id + 1);
      Node& nd = nodes[seg_id];
      if (st == 0) {
        nd.has_anchor = true;
        nd.rec[0] = pr.split_a;
        nd.rec[1] = pr.split_b;
        nd.rec[2] = pr.split_l;
        nd.rec[3] = seg.aBeg;
        nd.rec[4] = seg.aEnd;
        nd.rec[5] = seg.bBeg;
        nd.rec[6] = seg.bEnd;
        // serial push order: leading then trailing (trailing pops first)
        if (c1 > 0) {
          nd.lead_id = next_id++;
          stack.push_back(lead);
          seg_ids.push_back(nd.lead_id);
        }
        if (c2 > 0) {
          nd.trail_id = next_id++;
          stack.push_back(trail);
          seg_ids.push_back(nd.trail_id);
        }
      }
      cv.notify_all();
    }
  }
};

template <typename Index>
int64_t rem2_loop_par(uint8_t* T, const Index* SA, const Index* LCP,
                      Index* SAi, int64_t n, int64_t nsep0,
                      int64_t minlength, int do_trim, int64_t maxmums,
                      int64_t wscore, double wpen, double pcutoff,
                      int64_t nthreads, int64_t** out_anchors,
                      int64_t defer_max = 0,
                      std::vector<int64_t>* out_defer = nullptr) {
  Rem2Par<Index> ctx;
  ctx.defer_max = out_defer != nullptr ? defer_max : 0;
  ctx.T = T;
  ctx.SA = SA;
  ctx.LCP = LCP;
  ctx.SAi = SAi;
  ctx.n = n;
  ctx.nsep0 = nsep0;
  ctx.bOff = nsep0 + 1;
  ctx.minlength = minlength;
  ctx.maxmums = maxmums;
  ctx.wscore = wscore;
  ctx.do_trim = do_trim;
  ctx.wpen = wpen;
  ctx.pcutoff = pcutoff;
  const int64_t lenA = nsep0;
  const int64_t lenB = n - nsep0 - 2;

  // Pre-enumerate the ROOT in parallel: its candidate conditions read
  // only slots (i-1, i, i+1), so chunked scans concatenated in order
  // equal the serial pairwise_mums exactly — this removes the one
  // large serial scan (the whole-array pass a single pool worker would
  // otherwise do alone while the others idle).
  Index* root_mums = nullptr;
  int64_t root_k = -1;
  if (nthreads > 1 && n >= (1 << 20)) {
    const int64_t nt = std::min<int64_t>(nthreads, 8);
    std::vector<std::vector<Index>> chunks(nt);
    std::vector<std::thread> tp;
    const int64_t step = (n + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
      tp.emplace_back([&, t] {
        const int64_t lo = std::max<int64_t>(1, t * step);
        const int64_t hi = std::min<int64_t>(n, (t + 1) * step);
        std::vector<Index>& out = chunks[t];
        constexpr int64_t PD = 16;
        for (int64_t i = lo; i < hi; ++i) {
          if (i + PD < n) {
            __builtin_prefetch(&T[SA[i + PD - 1]], 0, 0);
            __builtin_prefetch(&T[SA[i + PD]], 0, 0);
          }
          int64_t l = LCP[i];
          if (l < minlength || l <= 0) continue;
          int64_t prev = SA[i - 1], cur = SA[i];
          if ((cur > nsep0) == (prev > nsep0)) continue;
          int64_t a = cur < prev ? cur : prev;
          int64_t b = cur < prev ? prev : cur;
          if (a > 0 && b > 0) {
            uint8_t ta = T[a - 1], tb = T[b - 1];
            if (!(ta != tb || ta == 'N' || ta == '$' ||
                  (ta >= 'a' && ta <= 'z'))) {
              continue;
            }
          }
          int64_t lb_ = LCP[i - 1];
          int64_t la_ = (i == n - 1) ? 0 : LCP[i + 1];
          if (lb_ >= l || la_ >= l) continue;
          out.push_back((Index)l);
          out.push_back((Index)a);
          out.push_back((Index)b);
        }
      });
    }
    for (auto& th : tp) th.join();
    root_k = 0;
    for (auto& c : chunks) root_k += (int64_t)c.size() / 3;
    root_mums = (Index*)std::malloc(
        sizeof(Index) * (size_t)std::max<int64_t>(1, 3 * root_k));
    int64_t w = 0;
    for (auto& c : chunks) {
      const int64_t m = (int64_t)c.size() / 3;
      for (int64_t j = 0; j < m; ++j) {
        root_mums[w + j] = c[3 * j];                    // l
        root_mums[root_k + w + j] = c[3 * j + 1];       // a
        root_mums[2 * root_k + w + j] = c[3 * j + 2];   // b
      }
      w += m;
    }
  }

  ctx.stack.push_back(Rem2Seg<Index>{nullptr, nullptr, nullptr, n, 0,
                                     lenA, ctx.bOff, ctx.bOff + lenB, -1,
                                     -1, lenA, lenB, root_mums, root_k});
  ctx.seg_ids.push_back(0);
  ctx.next_id = 1;

  std::vector<std::thread> pool;
  for (int64_t i = 1; i < nthreads; ++i) {
    pool.emplace_back([&ctx] { ctx.worker(); });
  }
  ctx.worker();
  for (auto& th : pool) th.join();

  if (ctx.abort_flag) {
    for (auto& s : ctx.stack) {
      if (s.blk && --s.blk->refs == 0) {
        std::free(s.blk->p);
        delete s.blk;
      }
      std::free(s.mums);
    }
    return -1;
  }

  // reconstruct the serial pop order by simulating the serial stack;
  // deferred segments get their placeholder ids in this (serial pop)
  // order, matching the serial rem2_loop's n_defer++ exactly
  std::vector<int64_t> anchors;
  std::vector<int64_t> sim;
  int64_t n_defer = 0;
  sim.push_back(0);
  while (!sim.empty()) {
    const int64_t id = sim.back();
    sim.pop_back();
    if (id >= (int64_t)ctx.nodes.size()) continue;
    const auto& nd = ctx.nodes[id];
    if (nd.has_defer) {
      const int64_t did = n_defer++;
      anchors.insert(anchors.end(), {did, -1, -1, nd.rec[3], nd.rec[4],
                                     nd.rec[5], nd.rec[6]});
      out_defer->insert(out_defer->end(), nd.defer.begin(),
                        nd.defer.end());
      continue;
    }
    if (!nd.has_anchor) continue;
    anchors.insert(anchors.end(), nd.rec, nd.rec + 7);
    if (nd.lead_id >= 0) sim.push_back(nd.lead_id);
    if (nd.trail_id >= 0) sim.push_back(nd.trail_id);
  }
  const int64_t na = (int64_t)anchors.size() / 7;
  int64_t* out = (int64_t*)std::malloc(
      (size_t)(anchors.size() ? anchors.size() : 1) * sizeof(int64_t));
  std::memcpy(out, anchors.data(), anchors.size() * sizeof(int64_t));
  *out_anchors = out;
  return na;
}

}  // namespace

// glocal synteny-chain DP (transform.py:947-1244 semantics as re-expressed
// in transform/blocks.py glocalchain, non-heap window scan): candidates
// 0..ncand-1 are [start dummy] + sorted blocks; for every block the
// reversed candidate window is scanned with the validity filters, the
// dummy-substitution costs (reduced algebraically to
// gapopen+min(rearrangecost, lambda*|d1|)), the orientation/cross-contig
// gap costs, and the lastn/lastbp/deepest early stop.  Emits per block the
// best predecessor candidate index and its DP score.
namespace {

struct GlocalParams {
  double rearrangecost, inversioncost, lambda_, eps, alfa, gapopen;
  int64_t lastn, lastbp;
  int axis;
};

static inline double glocal_pair_cost(
    int64_t pc1e, int64_t pc2, int64_t pc2e, int64_t po, int64_t bc1,
    int64_t bc2, int64_t bc2e, int64_t bo, const GlocalParams& P) {
  double d1 = (double)(bc1 - pc1e);
  if (po == 0 && bo == 0) {
    if (bc2 < pc2)
      return P.gapopen + P.rearrangecost + P.eps * (d1 > 0 ? d1 : 0);
    double d2 = (double)(bc2 - pc2e);
    double indel =
        std::min(P.rearrangecost, P.lambda_ * std::fabs(d1 - d2));
    double sub = P.eps * std::max(std::min(d1, d2), 0.0);
    return P.gapopen + indel + sub;
  }
  if (po == 1 && bo == 1) {
    if (bc2 > pc2)
      return P.gapopen + P.rearrangecost + P.eps * (d1 > 0 ? d1 : 0);
    double d2 = (double)(pc2 - bc2e);
    double indel =
        std::min(P.rearrangecost, P.lambda_ * std::fabs(d1 - d2));
    double sub = P.eps * std::max(std::min(d1, d2), 0.0);
    return P.gapopen + indel + sub;
  }
  double d1m = d1 > 0 ? d1 : 0;
  double d2 = bc2 > pc2 ? std::max(0.0, (double)(bc2 - pc2e))
                        : std::max(0.0, (double)(pc2 - bc2e));
  double indel =
      std::min(P.rearrangecost, P.lambda_ * std::fabs(d1m - d2));
  double sub = P.eps * std::max(std::min(d1m, d2), 0.0);
  return P.gapopen + indel + sub + P.inversioncost;
}

void glocal_dp(const int64_t* S1, const int64_t* E1, const int64_t* S2,
               const int64_t* E2, const int64_t* O, const int64_t* REF,
               const int64_t* CTG, const int64_t* SCORE, int64_t ncand,
               const int64_t* RNG0, const int64_t* RNG1,
               const GlocalParams& P, int64_t* out_best,
               double* out_score) {
  int64_t nb = ncand - 1;
  const int64_t* C1 = P.axis == 0 ? S1 : S2;
  const int64_t* C1E = P.axis == 0 ? E1 : E2;
  const int64_t* C2 = P.axis == 0 ? S2 : S1;
  const int64_t* C2E = P.axis == 0 ? E2 : E1;
  std::vector<double> CS(ncand, 0.0);
  int64_t deepest = 1;  // candidate index of the first sorted block

  for (int64_t ri = 0; ri < nb; ++ri) {
    int64_t b = ri + 1;
    while (C1E[deepest] < C1[b]) deepest++;
    int64_t deep_c1 = C1[deepest];
    bool bdum = REF[b] < 0;

    double bestscore = 0;
    bool have = false;
    int64_t besti = -1;
    int64_t l = 0;

    for (int64_t i = ri; i >= 0; --i) {
      bool pdum = REF[i] < 0;
      if (!pdum && !bdum) {
        if (C1[i] == C1[b] || C1E[i] >= C1E[b]) continue;
        if (C2[i] >= C2[b] && C2E[i] <= C2E[b]) continue;
      }
      l++;
      double cscore = CS[i];
      bool brk = (C1[b] - C1[i] > P.lastbp) && (l >= P.lastn) &&
                 (C1[i] < deep_c1);
      if (have && cscore <= bestscore) {
        if (brk) break;
        continue;
      }
      double c;
      double d1 = (double)(C1[b] - C1E[i]);
      if (pdum && bdum) {
        c = P.gapopen + std::fabs(d1) * P.eps;
      } else if (pdum || bdum) {
        c = P.gapopen +
            std::min(P.rearrangecost, P.lambda_ * std::fabs(d1));
      } else if (REF[i] == REF[b] && CTG[i] == CTG[b]) {
        c = glocal_pair_cost(C1E[i], C2[i], C2E[i], O[i], C1[b], C2[b],
                             C2E[b], O[b], P);
      } else if (P.axis == 0 && REF[i] == REF[b]) {
        double cp = O[i] == 0
                        ? std::fabs((double)(RNG1[CTG[i]] - E2[i]))
                        : std::fabs((double)(S2[i] - RNG0[CTG[i]]));
        double cb = O[b] == 0
                        ? std::fabs((double)(RNG1[CTG[b]] - E2[b]))
                        : std::fabs((double)(S2[b] - RNG0[CTG[b]]));
        c = P.gapopen + std::min(P.rearrangecost, (cp + cb) * P.eps);
      } else if (P.axis == 1 && CTG[i] == CTG[b]) {
        double cp = O[i] == 0
                        ? std::fabs((double)(RNG1[REF[i]] - E1[i]))
                        : std::fabs((double)(S1[i] - RNG0[REF[i]]));
        double cb = O[b] == 0
                        ? std::fabs((double)(S1[b] - RNG0[REF[b]]))
                        : std::fabs((double)(RNG1[REF[b]] - E1[b]));
        c = P.gapopen + std::min(P.rearrangecost, (cp + cb) * P.eps);
      } else {
        c = P.rearrangecost + P.gapopen + std::fabs(d1) * P.eps;
      }
      double v = cscore - c;
      if (!have || v > bestscore) {
        bestscore = v;
        besti = i;
        have = true;
      }
      if (brk) break;
    }

    double sc = bestscore + P.alfa * (double)SCORE[b];
    CS[b] = sc;
    out_best[ri] = besti;
    out_score[ri] = bestscore;
  }
}

// ---------------------------------------------------------------------------
// MEA alignment DP (ProbabilisticModel.h:641-760 ComputeAlignment).
// Scalar float32 DP identical to hmm/msa._mea_dp: cell = max(D, L, U) with
// ChooseBestOfThree tie order (D >= L >= U, .h:627-639); float arithmetic
// matches the numpy float32 path bit-for-bit so native and fallback produce
// identical alignments.  Returns the edit length; edit_out holds 0='B'
// (both), 1='Y' (second advances), 2='X' (first advances) in forward order.
// ---------------------------------------------------------------------------
namespace {

// Single DP core, caller-held arenas (refine_rounds runs ~100 DPs per
// bubble; reusing the buffers skips ~100 large zero-init allocations).
// total_out may be null when the MEA score is not needed.
int64_t mea_dp_arena(const float* post, int64_t L1, int64_t L2,
                     uint8_t* edit_out, std::vector<float>& rowbuf,
                     std::vector<uint8_t>& tbbuf,
                     double* total_out = nullptr) {
  const int64_t W = L2 + 1;
  rowbuf.resize(2 * W);
  float* oldrow = rowbuf.data();
  float* newrow = rowbuf.data() + W;
  for (int64_t j = 0; j <= L2; ++j) oldrow[j] = 0.0f;
  if ((int64_t)tbbuf.size() < (L1 + 1) * W) tbbuf.resize((L1 + 1) * W);
  uint8_t* tb = tbbuf.data();
  for (int64_t j = 0; j <= L2; ++j) tb[j] = 1;  // 'L'
  for (int64_t i = 1; i <= L1; ++i) {
    tb[i * W] = 2;  // 'U'
    newrow[0] = 0.0f;
    const float* prow = post + i * W;
    uint8_t* trow = tb + i * W;
    for (int64_t j = 1; j <= L2; ++j) {
      float dv = prow[j] + oldrow[j - 1];
      float uv = oldrow[j];
      float lv = newrow[j - 1];
      if (dv >= lv) {
        if (dv >= uv) {
          newrow[j] = dv;
          trow[j] = 0;
        } else {
          newrow[j] = uv;
          trow[j] = 2;
        }
      } else if (lv >= uv) {
        newrow[j] = lv;
        trow[j] = 1;
      } else {
        newrow[j] = uv;
        trow[j] = 2;
      }
    }
    std::swap(oldrow, newrow);
  }
  if (total_out) *total_out = (double)oldrow[L2];
  int64_t r = L1, c = L2, k = 0;
  while (r != 0 || c != 0) {
    uint8_t ch = tb[r * W + c];
    if (ch == 1) {
      --c;
      edit_out[k++] = 1;  // 'Y'
    } else if (ch == 2) {
      --r;
      edit_out[k++] = 2;  // 'X'
    } else {
      --r;
      --c;
      edit_out[k++] = 0;  // 'B'
    }
  }
  std::reverse(edit_out, edit_out + k);
  return k;
}

int64_t mea_dp(const float* post, int64_t L1, int64_t L2, uint8_t* edit_out,
               double* total_out) {
  std::vector<float> rowbuf;
  std::vector<uint8_t> tbbuf;
  return mea_dp_arena(post, L1, L2, edit_out, rowbuf, tbbuf, total_out);
}

// Scatter-accumulate one pairwise posterior into alignment-column
// coordinates (BuildPosterior, ProbabilisticModel.h:1018-1089):
// post[m1[ii], m2[jj]] += P[ii, jj]  (or P[jj, ii] when transposed).
// Zero entries are skipped — P is cutoff-sparsified, so most are.
void posterior_accum(float* post, int64_t W, const float* P, int64_t l1,
                     int64_t l2, int64_t w, const int64_t* m1,
                     const int64_t* m2, int transpose) {
  if (!transpose) {
    for (int64_t ii = 0; ii <= l1; ++ii) {
      const float* row = P + ii * w;
      float* pr = post + m1[ii] * W;
      for (int64_t jj = 0; jj <= l2; ++jj) {
        float v = row[jj];
        if (v != 0.0f) pr[m2[jj]] += v;
      }
    }
  } else {
    // P has shape (l2+1, w) with w = l1+1; logical P_t[ii, jj] = P[jj, ii]
    for (int64_t jj = 0; jj <= l2; ++jj) {
      const float* row = P + jj * w;
      int64_t mj = m2[jj];
      for (int64_t ii = 0; ii <= l1; ++ii) {
        float v = row[ii];
        if (v != 0.0f) post[m1[ii] * W + mj] += v;
      }
    }
  }
}

// Whole BuildPosterior sum in one call: npairs sparse matrices scattered
// into the (L1+1) x (W) output.  Mapping arrays arrive concatenated with
// per-row offsets; pair k uses a1-row map m1_idx[k] and a2-row map
// m2_idx[k], matrix Ps[k] (transposed indexing when tflags[k]).
void build_posterior_sum(float* post, int64_t W, const float** Ps,
                         const int64_t* pl1, const int64_t* pl2,
                         const int64_t* pw, const int32_t* tflags,
                         const int64_t* m1_idx, const int64_t* m2_idx,
                         const int64_t* m1_cat, const int64_t* m1_off,
                         const int64_t* m2_cat, const int64_t* m2_off,
                         int64_t npairs) {
  for (int64_t k = 0; k < npairs; ++k) {
    posterior_accum(post, W, Ps[k], pl1[k], pl2[k], pw[k],
                    m1_cat + m1_off[m1_idx[k]], m2_cat + m2_off[m2_idx[k]],
                    tflags[k]);
  }
}

// ---------------------------------------------------------------------------
// Whole iterative-refinement stage in one call (DoIterativeRefinement,
// Probcons.cc:1467-1490): per round, project the alignment onto the two
// bipartition groups (MultiSequence::Project, MultiSequence.h:653-700),
// scatter the pairwise posteriors into alignment-column coordinates
// (BuildPosterior), run the MEA DP, re-merge with gaps, stable-sort by
// label.  Float32 arithmetic, accumulation order, and ChooseBestOfThree
// tie order match hmm/msa.probcons_align stage 5 bit-for-bit
// (differential test tests/test_msa.py); the posterior mats are
// CSR-ified once so every round touches only nonzero entries instead of
// re-scanning the dense matrices.
// ---------------------------------------------------------------------------

constexpr uint8_t GAP = '-';

struct CsrMat {
  std::vector<int64_t> rowptr;  // nrows + 1
  std::vector<int32_t> col;
  std::vector<float> val;
  int64_t nrows = 0;
};

// CSR scatter-accumulate, same traversal (and f32 summation) order as
// posterior_accum over the dense matrix: row-major, ascending column.
void csr_accum(float* post, int64_t W, const CsrMat& M, const int64_t* m1,
               const int64_t* m2, int transpose) {
  if (!transpose) {
    for (int64_t ii = 0; ii < M.nrows; ++ii) {
      float* pr = post + m1[ii] * W;
      for (int64_t t = M.rowptr[ii]; t < M.rowptr[ii + 1]; ++t) {
        pr[m2[M.col[t]]] += M.val[t];
      }
    }
  } else {
    // logical P_t[ii, jj] = P[jj, ii]: CSR rows are the second group's
    // residues, columns the first's
    for (int64_t jj = 0; jj < M.nrows; ++jj) {
      int64_t mj = m2[jj];
      for (int64_t t = M.rowptr[jj]; t < M.rowptr[jj + 1]; ++t) {
        post[m1[M.col[t]] * W + mj] += M.val[t];
      }
    }
  }
}

// rows0: (N, L0) row-major alignment matrix, row k = label k, '-' = gap.
// mats[p]: dense float32 (la+1, lb+1) posterior for pair p in a<b
// lexicographic order (p = a*N - a*(a+1)/2 + b - a - 1).
// masks: (nrounds, N) bipartition indicators (group 1 where nonzero).
// out_rows: (N, Lcap) caller buffer; returns the final alignment length,
// or -1 if an intermediate alignment exceeds Lcap (cannot happen when
// Lcap >= total residue count, since merged columns always hold >=1
// residue).
int64_t refine_rounds(const uint8_t* rows0, int64_t N, int64_t L0,
                      const float** mats, const int64_t* mrows,
                      const int64_t* mcols, const uint8_t* masks,
                      int64_t nrounds, uint8_t* out_rows, int64_t Lcap) {
  if (L0 > Lcap) return -1;
  const int64_t npairs = N * (N - 1) / 2;
  std::vector<CsrMat> csr(npairs);
  for (int64_t p = 0; p < npairs; ++p) {
    CsrMat& M = csr[p];
    M.nrows = mrows[p];
    M.rowptr.resize(M.nrows + 1);
    const float* D = mats[p];
    int64_t w = mcols[p];
    M.rowptr[0] = 0;
    for (int64_t i = 0; i < M.nrows; ++i) {
      const float* row = D + i * w;
      for (int64_t j = 0; j < w; ++j) {
        if (row[j] != 0.0f) {
          M.col.push_back((int32_t)j);
          M.val.push_back(row[j]);
        }
      }
      M.rowptr[i + 1] = (int64_t)M.col.size();
    }
  }

  auto pidx = [N](int64_t a, int64_t b) {
    return a * N - a * (a + 1) / 2 + b - a - 1;
  };

  // double-buffered alignment state, stride Lcap
  std::vector<uint8_t> buf(2 * N * Lcap);
  uint8_t* cur = buf.data();
  uint8_t* nxt = buf.data() + N * Lcap;
  for (int64_t k = 0; k < N; ++k)
    std::copy(rows0 + k * L0, rows0 + (k + 1) * L0, cur + k * Lcap);
  int64_t L = L0;

  std::vector<int64_t> g1, g2, kept1, kept2;
  std::vector<std::vector<int64_t>> maps(N);  // per-label residue->column
  std::vector<float> post;
  std::vector<float> mea_rows;
  std::vector<uint8_t> mea_tb;
  std::vector<uint8_t> edit;

  for (int64_t r = 0; r < nrounds; ++r) {
    const uint8_t* mask = masks + r * N;
    g1.clear();
    g2.clear();
    for (int64_t k = 0; k < N; ++k) (mask[k] ? g1 : g2).push_back(k);
    if (g1.empty() || g2.empty()) continue;

    // ---- project both groups: kept columns + per-row mappings ----
    auto project = [&](const std::vector<int64_t>& g,
                       std::vector<int64_t>& kept) {
      kept.clear();
      for (int64_t k : g) {
        maps[k].clear();
        maps[k].push_back(0);
      }
      for (int64_t c = 0; c < L; ++c) {
        bool any = false;
        for (int64_t k : g) {
          if (cur[k * Lcap + c] != GAP) {
            any = true;
            break;
          }
        }
        if (!any) continue;
        kept.push_back(c);
        int64_t pc = (int64_t)kept.size();  // 1-based projected column
        for (int64_t k : g) {
          if (cur[k * Lcap + c] != GAP) maps[k].push_back(pc);
        }
      }
    };
    project(g1, kept1);
    project(g2, kept2);
    const int64_t L1 = (int64_t)kept1.size();
    const int64_t L2 = (int64_t)kept2.size();
    const int64_t W = L2 + 1;

    // ---- BuildPosterior over cross-group pairs, job order = Python's
    // (ascending a1 label x ascending a2 label) ----
    post.assign((L1 + 1) * W, 0.0f);
    for (int64_t a : g1) {
      for (int64_t b : g2) {
        if (a < b) {
          csr_accum(post.data(), W, csr[pidx(a, b)], maps[a].data(),
                    maps[b].data(), 0);
        } else {
          csr_accum(post.data(), W, csr[pidx(b, a)], maps[a].data(),
                    maps[b].data(), 1);
        }
      }
    }

    // ---- MEA DP + traceback ----
    edit.resize(L1 + L2 + 1);
    int64_t elen =
        mea_dp_arena(post.data(), L1, L2, edit.data(), mea_rows, mea_tb);
    if (elen > Lcap) return -1;

    // ---- AddGaps + merge; labels stay sorted (row k = label k) ----
    for (int64_t k = 0; k < N; ++k) {
      bool in1 = mask[k] != 0;
      const std::vector<int64_t>& kept = in1 ? kept1 : kept2;
      uint8_t keep_op = in1 ? 2 : 1;  // 'X' advances g1, 'Y' advances g2
      const uint8_t* src = cur + k * Lcap;
      uint8_t* dst = nxt + k * Lcap;
      int64_t c = 0;
      for (int64_t t = 0; t < elen; ++t) {
        if (edit[t] == 0 || edit[t] == keep_op) {
          dst[t] = src[kept[c++]];
        } else {
          dst[t] = GAP;
        }
      }
    }
    std::swap(cur, nxt);
    L = elen;
  }

  for (int64_t k = 0; k < N; ++k)
    std::copy(cur + k * Lcap, cur + k * Lcap + L, out_rows + k * Lcap);
  return L;
}

}  // namespace

}  // namespace

// ---------------------------------------------------------------------------
// Native 5-state pair-HMM posterior batch — the host fast path for small
// refine workloads, where device dispatch latency dominates the O(L^2) DP.
// Model and parameters are identical to hmm/pairhmm.py (reference:
// ProbabilisticModel.h:102-331 recurrences, Defaults.h pecan DNA params,
// NumInsertStates=2): states M, Ix_s, Iy_s, Ix_l, Iy_l.  Arithmetic is
// exact float32 logaddexp — the repo's documented deviation from the
// reference's LOG_ADD lookup table (ScoreType.h:64-150) — so results sit
// within the same oracle gate as the device kernels (tests pin <=2e-3).
// Per pair this computes: the dense posterior already cutoff-sparsified
// (msa._sparsify semantics: <cutoff zeroed, row/col 0 zeroed), the total
// log-probability, and the MEA score of the full posterior (same float32
// recurrence as mea_dp above, score only).  Pairs run on std::threads.
// ---------------------------------------------------------------------------
namespace pairhmm {

constexpr float kLogZero = -2e20f;  // ScoreType.h:16

struct Params {
  float li[5];         // log initial distribution
  float lt[5][5];      // log transition matrix (LOG_ZERO where p=0)
  float les[256];      // log single-emission by byte
  const float* lep;    // 256x256 log pair-emission by byte
};

inline double lae(double a, double b) {
  // exact float32 logaddexp with the oracle's LOG_ZERO guard
  // (hmm/pairhmm.forward_np lae); the d<-60 cutout returns the exact
  // same float (log1pf(expf(-60)) == 0.0f in float32)
  if (a <= kLogZero / 2 && b <= kLogZero / 2) return kLogZero;
  double m, d;
  if (a > b) { m = a; d = b - a; } else { m = b; d = a - b; }
  if (d < -60.0) return m;
  return m + log1p(exp(d));
}

// MEA score only: the float32 arithmetic and update order of
// mea_dp_arena above, without traceback storage.
double mea_score(const float* post, int64_t L1, int64_t L2,
                 std::vector<float>& rowbuf) {
  const int64_t W = L2 + 1;
  rowbuf.resize(2 * W);
  float* oldrow = rowbuf.data();
  float* newrow = rowbuf.data() + W;
  for (int64_t j = 0; j <= L2; ++j) oldrow[j] = 0.0f;
  for (int64_t i = 1; i <= L1; ++i) {
    newrow[0] = 0.0f;
    const float* prow = post + i * W;
    for (int64_t j = 1; j <= L2; ++j) {
      float dv = prow[j] + oldrow[j - 1];
      float uv = oldrow[j];
      float lv = newrow[j - 1];
      float v = dv >= lv ? (dv >= uv ? dv : uv) : (lv >= uv ? lv : uv);
      newrow[j] = v;
    }
    std::swap(oldrow, newrow);
  }
  return (double)oldrow[L2];
}

struct Arena {
  std::vector<double> f0, b0;  // full match-state planes (double: f32
  // log-space drift exceeds the 2e-3 oracle gate by L~300 when chained
  // scalar; measured 4e-3 at L=300, <=2e-4 in double)
  std::vector<double> rows;   // rolling insert-state rows
  std::vector<float> mea;
};

// Forward DP (ProbabilisticModel.h:102-176 / hmm/pairhmm.forward_np):
// fills the full M plane f0 (row-major (L1+1) x (L2+1)) and returns the
// five (L1, L2) corner values in fend.  x, y are '@'-prefixed byte
// arrays of length L1+1 / L2+1.
void forward_plane(const uint8_t* x, int64_t L1, const uint8_t* y,
                   int64_t L2, const Params& P, double* f0, double fend[5],
                   Arena& A) {
  const int64_t W = L2 + 1;
  A.rows.assign(8 * W, kLogZero);
  double* prev = A.rows.data();  // states 1..4 at row i-1 (4 x W)
  double* cur = prev + 4 * W;
  const double t00 = P.lt[0][0];
  for (int64_t i = 0; i <= L1; ++i) {
    double* frow = f0 + i * W;
    const double* fprev = i > 0 ? f0 + (i - 1) * W : f0;
    const double e1 = i >= 1 ? P.les[x[i]] : 0.0;
    const float* leprow = P.lep + 256 * (i >= 1 ? x[i] : 0);
    for (int64_t j = 0; j <= L2; ++j) {
      if (i <= 1 && j <= 1) {
        // init cells (forward_np:661-667); everything else LOG_ZERO
        frow[j] = kLogZero;
        for (int k = 0; k < 4; ++k) cur[k * W + j] = kLogZero;
        if (i == 1 && j == 1) frow[j] = P.li[0] + leprow[y[1]];
        if (i == 1 && j == 0) {
          cur[0 * W + 0] = P.li[1] + e1;  // Ix_s
          cur[2 * W + 0] = P.li[3] + e1;  // Ix_l
        }
        if (i == 0 && j == 1) {
          cur[1 * W + 1] = P.li[2] + P.les[y[1]];  // Iy_s
          cur[3 * W + 1] = P.li[4] + P.les[y[1]];  // Iy_l
        }
        continue;
      }
      double m = kLogZero;
      if (i > 0 && j > 0) {
        // chained lae in the oracle's order M, Ix_s, Iy_s, Ix_l, Iy_l
        double v = fprev[j - 1] + t00;
        v = lae(v, prev[0 * W + j - 1] + P.lt[1][0]);
        v = lae(v, prev[1 * W + j - 1] + P.lt[2][0]);
        v = lae(v, prev[2 * W + j - 1] + P.lt[3][0]);
        v = lae(v, prev[3 * W + j - 1] + P.lt[4][0]);
        m = v + leprow[y[j]];
      }
      frow[j] = m;
      if (i > 0) {
        cur[0 * W + j] =
            e1 + lae(fprev[j] + P.lt[0][1], prev[0 * W + j] + P.lt[1][1]);
        cur[2 * W + j] =
            e1 + lae(fprev[j] + P.lt[0][3], prev[2 * W + j] + P.lt[3][3]);
      } else {
        cur[0 * W + j] = kLogZero;
        cur[2 * W + j] = kLogZero;
      }
      if (j > 0) {
        const double e2 = P.les[y[j]];
        cur[1 * W + j] =
            e2 + lae(frow[j - 1] + P.lt[0][2], cur[1 * W + j - 1] + P.lt[2][2]);
        cur[3 * W + j] =
            e2 + lae(frow[j - 1] + P.lt[0][4], cur[3 * W + j - 1] + P.lt[4][4]);
      } else {
        cur[1 * W + j] = kLogZero;
        cur[3 * W + j] = kLogZero;
      }
    }
    if (i == L1) {
      fend[0] = frow[L2];
      fend[1] = cur[0 * W + L2];
      fend[2] = cur[1 * W + L2];
      fend[3] = cur[2 * W + L2];
      fend[4] = cur[3 * W + L2];
    }
    std::swap(prev, cur);
  }
  if (L1 == 0) {
    fend[0] = f0[L2];
    fend[1] = kLogZero;
    fend[2] = prev[1 * W + L2];
    fend[3] = kLogZero;
    fend[4] = prev[3 * W + L2];
  }
}

// Backward DP (ProbabilisticModel.h:194-258 / hmm/pairhmm.backward_np):
// fills the full M plane b0; accumulation order mirrors backward_np.
void backward_plane(const uint8_t* x, int64_t L1, const uint8_t* y,
                    int64_t L2, const Params& P, double* b0, Arena& A) {
  const int64_t W = L2 + 1;
  A.rows.assign(8 * W, kLogZero);
  double* next = A.rows.data();  // states 1..4 at row i+1 (4 x W)
  double* cur = next + 4 * W;
  for (int64_t i = L1; i >= 0; --i) {
    double* brow = b0 + i * W;
    const double* bnext = i < L1 ? b0 + (i + 1) * W : b0;
    const double e1n = i < L1 ? P.les[x[i + 1]] : 0.0;
    const float* lepn = P.lep + 256 * (i < L1 ? x[i + 1] : 0);
    for (int64_t j = L2; j >= 0; --j) {
      double v0 = kLogZero, v1 = kLogZero, v2 = kLogZero, v3 = kLogZero,
             v4 = kLogZero;
      if (i == L1 && j == L2) {
        v0 = P.li[0]; v1 = P.li[1]; v2 = P.li[2]; v3 = P.li[3];
        v4 = P.li[4];
      }
      if (i < L1 && j < L2) {
        const double pxy = bnext[j + 1] + lepn[y[j + 1]];
        v0 = lae(v0, pxy + P.lt[0][0]);
        v1 = lae(v1, pxy + P.lt[1][0]);
        v2 = lae(v2, pxy + P.lt[2][0]);
        v3 = lae(v3, pxy + P.lt[3][0]);
        v4 = lae(v4, pxy + P.lt[4][0]);
      }
      if (i < L1) {
        v0 = lae(v0, next[0 * W + j] + e1n + P.lt[0][1]);
        v1 = lae(v1, next[0 * W + j] + e1n + P.lt[1][1]);
        v0 = lae(v0, next[2 * W + j] + e1n + P.lt[0][3]);
        v3 = lae(v3, next[2 * W + j] + e1n + P.lt[3][3]);
      }
      if (j < L2) {
        const double e2n = P.les[y[j + 1]];
        v0 = lae(v0, cur[1 * W + j + 1] + e2n + P.lt[0][2]);
        v2 = lae(v2, cur[1 * W + j + 1] + e2n + P.lt[2][2]);
        v0 = lae(v0, cur[3 * W + j + 1] + e2n + P.lt[0][4]);
        v4 = lae(v4, cur[3 * W + j + 1] + e2n + P.lt[4][4]);
      }
      brow[j] = v0;
      cur[0 * W + j] = v1;
      cur[1 * W + j] = v2;
      cur[2 * W + j] = v3;
      cur[3 * W + j] = v4;
    }
    std::swap(next, cur);
  }
}

// One pair end to end: posterior (cutoff-sparsified in place), total
// log-prob, MEA score of the full posterior.
void pair_posterior(const uint8_t* x, int64_t L1, const uint8_t* y,
                    int64_t L2, const Params& P, float cutoff, float* out,
                    double* tot_out, double* score_out, Arena& A) {
  const int64_t W = L2 + 1;
  const int64_t H = L1 + 1;
  A.f0.resize(H * W);
  A.b0.resize(H * W);
  double fend[5];
  forward_plane(x, L1, y, L2, P, A.f0.data(), fend, A);
  backward_plane(x, L1, y, L2, P, A.b0.data(), A);
  // total: chained per posterior_oracle:753-756 (b[k,L1,L2] == li[k])
  double tot = kLogZero;
  for (int k = 0; k < 5; ++k) {
    const double v = fend[k] + P.li[k];
    tot = (tot > kLogZero / 2) ? lae(tot, v) : v;
  }
  *tot_out = tot;
  // posterior = exp(min(0, f0 + b0 - tot)), row/col 0 zeroed
  const double* f0 = A.f0.data();
  const double* b0 = A.b0.data();
  for (int64_t j = 0; j <= L2; ++j) out[j] = 0.0f;
  for (int64_t i = 1; i <= L1; ++i) {
    const double* fr = f0 + i * W;
    const double* br = b0 + i * W;
    float* orow = out + i * W;
    orow[0] = 0.0f;
    for (int64_t j = 1; j <= L2; ++j) {
      double lv = fr[j] + br[j] - tot;
      if (lv > 0.0) lv = 0.0;
      orow[j] = lv < -60.0 ? 0.0f : (float)exp(lv);
    }
  }
  *score_out = mea_score(out, L1, L2, A.mea);
  // cutoff-sparsify in place (msa._sparsify)
  const int64_t total_cells = H * W;
  for (int64_t c = 0; c < total_cells; ++c)
    if (out[c] < cutoff) out[c] = 0.0f;
}

void post_batch(const uint8_t* seqs, const int64_t* offs, const int32_t* pa,
                const int32_t* pb, int64_t npairs, const int64_t* out_offs,
                float* out, double* tots, double* scores, const float* li,
                const float* lt, const float* les, const float* lep,
                float cutoff, int64_t nthreads) {
  Params P;
  for (int k = 0; k < 5; ++k) P.li[k] = li[k];
  for (int a = 0; a < 5; ++a)
    for (int b = 0; b < 5; ++b) P.lt[a][b] = lt[a * 5 + b];
  for (int c = 0; c < 256; ++c) P.les[c] = les[c];
  P.lep = lep;

  std::atomic<int64_t> nextp(0);
  auto worker = [&]() {
    Arena A;
    for (;;) {
      const int64_t p = nextp.fetch_add(1);
      if (p >= npairs) break;
      const int64_t ia = pa[p], ib = pb[p];
      const uint8_t* x = seqs + offs[ia];
      const int64_t L1 = offs[ia + 1] - offs[ia] - 1;  // minus '@'
      const uint8_t* y = seqs + offs[ib];
      const int64_t L2 = offs[ib + 1] - offs[ib] - 1;
      pair_posterior(x, L1, y, L2, P, cutoff, out + out_offs[p], tots + p,
                     scores + p, A);
    }
  };
  int64_t nt = nthreads;
  if (nt <= 0) nt = (int64_t)std::thread::hardware_concurrency();
  if (nt > npairs) nt = npairs;
  if (nt <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  for (int64_t t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace pairhmm

// ---------------------------------------------------------------------------
// Whole-MSA native batch: the complete per-bubble DoAlign pipeline
// (Probcons.cc:312-544) in one threaded call — pairwise posteriors
// (pairhmm::pair_posterior), expected-accuracy distances, consistency
// transform (DoRelaxation, Probcons.cc:1135-1248; gap-aware Relax_gap
// :1291-1353), guide tree (EvolutionaryTree.h:104), progressive MEA
// alignment (ProbabilisticModel.h:641,1018), iterative refinement
// (refine_rounds above, Probcons.cc:1467-1490) and column confidence
// (Probcons.cc:1545-1602).  Bubbles run on a worker pool (the
// reference's mp-pool parallelism P2, refine.py:459-525, with no
// process or GIL overhead).  Float semantics mirror hmm/msa.py's host
// path: f32 posteriors, f64 consistency accumulation cast back to f32
// with the 0.01 cutoff (_sparsify), f32 MEA DP with ChooseBestOfThree
// tie order — summation order inside the consistency product differs
// from numpy BLAS at the ULP level (differential tests compare the MSA
// strings + %.6f posteriors, tests/test_msa_native.py).
// ---------------------------------------------------------------------------
namespace msafull {

using pairhmm::Arena;
using pairhmm::Params;

struct Aln {
  std::vector<int> labels;
  std::vector<std::vector<uint8_t>> rows;  // gapped, no terminator
  int64_t L = 0;
};

struct Work {
  // per-pair dense posteriors, a<b lexicographic
  std::vector<std::vector<float>> mats;
  std::vector<std::vector<float>> tmats;   // transposes (consistency)
  std::vector<std::vector<double>> rowsum; // per matrix: row sums
  std::vector<std::vector<double>> colsum;
  std::vector<double> newbuf;              // f64 acc scratch
  std::vector<float> post;                 // merge posterior scratch
  std::vector<float> mea_rows;
  std::vector<uint8_t> mea_tb;
  std::vector<uint8_t> edit;
  Arena A;
};

static inline int64_t pidx(int64_t a, int64_t b, int64_t N) {
  return a * N - a * (a + 1) / 2 + b - a - 1;
}

// mapping[k] = 1-based alignment column of residue k, mapping[0]=0
// (Sequence::GetMapping, Sequence.h:391-397)
static void row_mapping(const std::vector<uint8_t>& row,
                        std::vector<int64_t>& map) {
  map.clear();
  map.push_back(0);
  for (int64_t c = 0; c < (int64_t)row.size(); ++c)
    if (row[c] != GAP) map.push_back(c + 1);
}

// _align_alignments: BuildPosterior + MEA + AddGaps + label sort
static void merge_alns(const Aln& a1, const Aln& a2,
                       const std::vector<std::vector<float>>& mats,
                       const std::vector<int64_t>& dims, int64_t N,
                       Work& W, Aln& out) {
  const int64_t L1 = a1.L, L2 = a2.L;
  const int64_t Wd = L2 + 1;
  W.post.assign((L1 + 1) * Wd, 0.0f);
  std::vector<std::vector<int64_t>> m1(a1.labels.size()),
      m2(a2.labels.size());
  for (size_t i = 0; i < a1.labels.size(); ++i)
    row_mapping(a1.rows[i], m1[i]);
  for (size_t j = 0; j < a2.labels.size(); ++j)
    row_mapping(a2.rows[j], m2[j]);
  for (size_t i = 0; i < a1.labels.size(); ++i) {
    for (size_t j = 0; j < a2.labels.size(); ++j) {
      int first = a1.labels[i], second = a2.labels[j];
      if (first < second) {
        int64_t p = pidx(first, second, N);
        posterior_accum(W.post.data(), Wd, mats[p].data(),
                        dims[first], dims[second], dims[second] + 1,
                        m1[i].data(), m2[j].data(), 0);
      } else {
        int64_t p = pidx(second, first, N);
        posterior_accum(W.post.data(), Wd, mats[p].data(),
                        dims[first], dims[second], dims[first] + 1,
                        m1[i].data(), m2[j].data(), 1);
      }
    }
  }
  W.edit.resize(L1 + L2 + 1);
  int64_t elen = mea_dp_arena(W.post.data(), L1, L2, W.edit.data(),
                              W.mea_rows, W.mea_tb);
  // AddGaps both groups, then stable sort by label
  const int64_t nrows = (int64_t)(a1.labels.size() + a2.labels.size());
  std::vector<int> labels;
  std::vector<std::vector<uint8_t>> rows(nrows);
  labels.reserve(nrows);
  int64_t r = 0;
  for (size_t i = 0; i < a1.labels.size(); ++i, ++r) {
    labels.push_back(a1.labels[i]);
    rows[r].assign(elen, GAP);
    const std::vector<uint8_t>& src = a1.rows[i];
    int64_t c = 0;
    for (int64_t t = 0; t < elen; ++t)
      if (W.edit[t] == 0 || W.edit[t] == 2) rows[r][t] = src[c++];
  }
  for (size_t j = 0; j < a2.labels.size(); ++j, ++r) {
    labels.push_back(a2.labels[j]);
    rows[r].assign(elen, GAP);
    const std::vector<uint8_t>& src = a2.rows[j];
    int64_t c = 0;
    for (int64_t t = 0; t < elen; ++t)
      if (W.edit[t] == 0 || W.edit[t] == 1) rows[r][t] = src[c++];
  }
  std::vector<int64_t> order(nrows);
  for (int64_t k = 0; k < nrows; ++k) order[k] = k;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t x, int64_t y) {
                     return labels[x] < labels[y];
                   });
  out.labels.clear();
  out.rows.clear();
  for (int64_t k = 0; k < nrows; ++k) {
    out.labels.push_back(labels[order[k]]);
    out.rows.push_back(std::move(rows[order[k]]));
  }
  out.L = elen;
}

// guide tree (EvolutionaryTree.h:104 / msa._compute_tree): repeated
// best-pair merge; returns merge tree as (left, right) child arrays
// over 2N-1 nodes (0..N-1 leaves), root = last interior node created
// ... except the tree SHAPE must match the python nested-tuple exactly:
// nodes[i] = (nodes[i], nodes[j]) keeps slot i, so we track slot->node.
static int compute_tree(const std::vector<double>& dist0, int64_t N,
                        std::vector<int>& lch, std::vector<int>& rch) {
  std::vector<double> d(dist0);
  std::vector<char> valid(N, 1);
  std::vector<int> slot(N);
  lch.assign(2 * N - 1, -1);
  rch.assign(2 * N - 1, -1);
  for (int64_t k = 0; k < N; ++k) slot[k] = (int)k;
  int next = (int)N;
  for (int64_t it = 0; it + 1 < N; ++it) {
    double best = -1.0;
    int64_t bi = -1, bj = -1;
    for (int64_t i = 0; i < N; ++i) {
      if (!valid[i]) continue;
      for (int64_t j = i + 1; j < N; ++j) {
        if (!valid[j]) continue;
        if (d[i * N + j] > best) {
          best = d[i * N + j];
          bi = i;
          bj = j;
        }
      }
    }
    lch[next] = slot[bi];
    rch[next] = slot[bj];
    slot[bi] = next++;
    for (int64_t k = 0; k < N; ++k) {
      if (valid[k]) {
        double v = (d[k * N + bi] + d[k * N + bj]) * best / 2;
        d[bi * N + k] = d[k * N + bi] = v;
      }
    }
    valid[bj] = 0;
  }
  return N == 1 ? 0 : next - 1;
}

static void process_node(int node, const std::vector<int>& lch,
                         const std::vector<int>& rch,
                         const uint8_t* seqs, const int64_t* soffs,
                         const std::vector<int64_t>& dims, int64_t N,
                         Work& W, Aln& out) {
  if (node < (int)N) {
    out.labels.assign(1, node);
    out.rows.assign(1, std::vector<uint8_t>());
    const uint8_t* s = seqs + soffs[node] + 1;  // skip '@'
    out.rows[0].assign(s, s + dims[node]);
    out.L = dims[node];
    return;
  }
  Aln left, right;
  process_node(lch[node], lch, rch, seqs, soffs, dims, N, W, left);
  process_node(rch[node], lch, rch, seqs, soffs, dims, N, W, right);
  merge_alns(left, right, W.mats, dims, N, W, out);
}

// one bubble end-to-end; returns final alignment length or -1
static int64_t msa_one(const uint8_t* seqs, const int64_t* soffs,
                       int64_t N, const Params& P, float cutoff,
                       int64_t consistency, int consgap,
                       const uint8_t* masks, int64_t nrounds,
                       uint8_t* out_rows, int64_t Lcap,
                       int32_t* out_conf, Work& W) {
  std::vector<int64_t> dims(N);
  for (int64_t k = 0; k < N; ++k)
    dims[k] = soffs[k + 1] - soffs[k] - 1;  // minus '@'
  if (N == 1) {
    if (dims[0] > Lcap) return -1;
    std::copy(seqs + soffs[0] + 1, seqs + soffs[0] + 1 + dims[0],
              out_rows);
    std::fill(out_conf, out_conf + dims[0], 0);
    return dims[0];
  }
  const int64_t npairs = N * (N - 1) / 2;
  W.mats.assign(npairs, {});
  std::vector<double> dist(N * N, 0.0);
  for (int64_t a = 0; a < N; ++a) {
    for (int64_t b = a + 1; b < N; ++b) {
      const int64_t p = pidx(a, b, N);
      W.mats[p].resize((dims[a] + 1) * (dims[b] + 1));
      double tot, score;
      pairhmm::pair_posterior(seqs + soffs[a], dims[a],
                              seqs + soffs[b], dims[b], P, cutoff,
                              W.mats[p].data(), &tot, &score, W.A);
      int64_t mn = dims[a] < dims[b] ? dims[a] : dims[b];
      if (mn < 1) mn = 1;
      dist[a * N + b] = dist[b * N + a] = score / (double)mn;
    }
  }

  // ---- consistency transform (msa.probcons_align stage 2 dense path:
  // f64 accumulate, /N, previous-pattern mask, f32 cast + cutoff).
  // The z-products run sparse x sparse over per-row nonzero index
  // lists (both orientations) — the cutoff keeps ~O(L) nonzeros per
  // matrix, so a product costs sum_k nnzA_k * nnzB_k instead of
  // nnzA * cb (the reference's DoRelaxation traversal shape,
  // Probcons.cc:1203-1248). ----
  std::vector<std::vector<int32_t>> fidx(npairs), tidx(npairs);
  std::vector<std::vector<int64_t>> fptr(npairs), tptr(npairs);
  for (int64_t round = 0; round < consistency; ++round) {
    // transposes + nonzero indexes + gap sums of the current mats
    W.tmats.assign(npairs, {});
    W.rowsum.assign(npairs, {});
    W.colsum.assign(npairs, {});
    for (int64_t a = 0; a < N; ++a) {
      for (int64_t b = a + 1; b < N; ++b) {
        const int64_t p = pidx(a, b, N);
        const int64_t ra = dims[a] + 1, cb = dims[b] + 1;
        const std::vector<float>& M = W.mats[p];
        std::vector<float>& T = W.tmats[p];
        T.assign(ra * cb, 0.0f);
        for (int64_t i = 0; i < ra; ++i)
          for (int64_t j = 0; j < cb; ++j)
            T[j * ra + i] = M[i * cb + j];
        // row-wise nonzero columns, both orientations
        fidx[p].clear();
        tidx[p].clear();
        fptr[p].assign(ra + 1, 0);
        tptr[p].assign(cb + 1, 0);
        for (int64_t i = 0; i < ra; ++i) {
          const float* row = M.data() + i * cb;
          for (int64_t j = 0; j < cb; ++j)
            if (row[j] != 0.0f) fidx[p].push_back((int32_t)j);
          fptr[p][i + 1] = (int64_t)fidx[p].size();
        }
        for (int64_t j = 0; j < cb; ++j) {
          const float* row = T.data() + j * ra;
          for (int64_t i = 0; i < ra; ++i)
            if (row[i] != 0.0f) tidx[p].push_back((int32_t)i);
          tptr[p][j + 1] = (int64_t)tidx[p].size();
        }
        if (consgap) {
          std::vector<double>& rs = W.rowsum[p];
          std::vector<double>& cs = W.colsum[p];
          rs.assign(ra, 0.0);
          cs.assign(cb, 0.0);
          for (int64_t i = 0; i < ra; ++i) {
            const float* row = M.data() + i * cb;
            double s = 0.0;
            for (int64_t j = 0; j < cb; ++j) {
              s += row[j];
              cs[j] += row[j];
            }
            rs[i] = s;
          }
        }
      }
    }
    std::vector<std::vector<float>> newmats(npairs);
    for (int64_t a = 0; a < N; ++a) {
      for (int64_t b = a + 1; b < N; ++b) {
        const int64_t p = pidx(a, b, N);
        const int64_t ra = dims[a] + 1, cb = dims[b] + 1;
        const std::vector<float>& Pab = W.mats[p];
        std::vector<double>& acc = W.newbuf;
        acc.assign(ra * cb, 0.0);
        for (int64_t c = 0; c < ra * cb; ++c)
          acc[c] = 2.0 * (double)Pab[c];
        for (int64_t z = 0; z < N; ++z) {
          if (z == a || z == b) continue;
          // A = P(a,z) as (ra, rz); B = P(z,b) as (rz, cb)
          const int64_t rz = dims[z] + 1;
          const bool az = a < z, zb = z < b;
          const int64_t paz = az ? pidx(a, z, N) : pidx(z, a, N);
          const int64_t pzb = zb ? pidx(z, b, N) : pidx(b, z, N);
          const float* A =
              az ? W.mats[paz].data() : W.tmats[paz].data();
          const float* B =
              zb ? W.mats[pzb].data() : W.tmats[pzb].data();
          const std::vector<int32_t>& Aix = az ? fidx[paz] : tidx[paz];
          const std::vector<int64_t>& Apt = az ? fptr[paz] : tptr[paz];
          const std::vector<int32_t>& Bix = zb ? fidx[pzb] : tidx[pzb];
          const std::vector<int64_t>& Bpt = zb ? fptr[pzb] : tptr[pzb];
          for (int64_t i = 0; i < ra; ++i) {
            const float* Ar = A + i * rz;
            double* ar = acc.data() + i * cb;
            for (int64_t t = Apt[i]; t < Apt[i + 1]; ++t) {
              const int32_t k = Aix[t];
              const double av = Ar[k];
              const float* Br = B + (int64_t)k * cb;
              for (int64_t u = Bpt[k]; u < Bpt[k + 1]; ++u) {
                const int32_t j = Bix[u];
                ar[j] += av * (double)Br[j];
              }
            }
          }
          if (consgap) {
            // pgx = 1 - rowsum(A); pgy = 1 - colsum(B)
            const std::vector<double>& rsA =
                az ? W.rowsum[paz] : W.colsum[paz];
            const std::vector<double>& csB =
                zb ? W.colsum[pzb] : W.rowsum[pzb];
            for (int64_t i = 0; i < ra; ++i) {
              const double gx = 1.0 - rsA[i];
              double* ar = acc.data() + i * cb;
              for (int64_t j = 0; j < cb; ++j)
                ar[j] += gx * (1.0 - csB[j]);
            }
          }
        }
        std::vector<float>& out = newmats[p];
        out.assign(ra * cb, 0.0f);
        for (int64_t i = 1; i < ra; ++i) {
          for (int64_t j = 1; j < cb; ++j) {
            const int64_t c = i * cb + j;
            if (Pab[c] == 0.0f) continue;  // previous-pattern mask
            const float v = (float)(acc[c] / (double)N);
            if (v >= cutoff) out[c] = v;
          }
        }
      }
    }
    W.mats = std::move(newmats);
  }

  // ---- guide tree + progressive alignment ----
  std::vector<int> lch, rch;
  int root = compute_tree(dist, N, lch, rch);
  Aln aln;
  process_node(root, lch, rch, seqs, soffs, dims, N, W, aln);
  if (aln.L > Lcap) return -1;

  // ---- iterative refinement (refine_rounds above) ----
  int64_t L = aln.L;
  std::vector<uint8_t> rows0(N * L);
  for (int64_t k = 0; k < N; ++k)  // labels are 0..N-1 post-sort
    std::copy(aln.rows[k].begin(), aln.rows[k].end(),
              rows0.begin() + k * L);
  std::vector<const float*> mptr(npairs);
  std::vector<int64_t> mrows(npairs), mcols(npairs);
  for (int64_t a = 0; a < N; ++a) {
    for (int64_t b = a + 1; b < N; ++b) {
      const int64_t p = pidx(a, b, N);
      mptr[p] = W.mats[p].data();
      mrows[p] = dims[a] + 1;
      mcols[p] = dims[b] + 1;
    }
  }
  std::vector<uint8_t> rowsbuf(N * Lcap);
  if (nrounds > 0) {
    L = refine_rounds(rows0.data(), N, L, mptr.data(), mrows.data(),
                      mcols.data(), masks, nrounds, rowsbuf.data(),
                      Lcap);
    if (L < 0) return -1;
  } else {
    for (int64_t k = 0; k < N; ++k)
      std::copy(rows0.begin() + k * aln.L,
                rows0.begin() + (k + 1) * aln.L,
                rowsbuf.begin() + k * Lcap);
  }

  // ---- column confidence (Probcons.cc:1545-1602 / msa._annotation) --
  std::vector<double> val(L, 0.0);
  std::vector<int32_t> nact(L, 0);
  std::vector<int64_t> pos(N * L, 0);
  for (int64_t k = 0; k < N; ++k) {
    int64_t r = 0;
    for (int64_t c = 0; c < L; ++c) {
      if (rowsbuf[k * Lcap + c] != GAP) {
        ++r;
        ++nact[c];
      }
      pos[k * L + c] = r;  // 1-based residue index at column c
    }
  }
  for (int64_t i = 0; i < N; ++i) {
    for (int64_t j = i + 1; j < N; ++j) {
      const int64_t p = pidx(i, j, N);
      const std::vector<float>& M = W.mats[p];
      const int64_t cb = dims[j] + 1;
      for (int64_t c = 0; c < L; ++c) {
        if (rowsbuf[i * Lcap + c] != GAP &&
            rowsbuf[j * Lcap + c] != GAP)
          val[c] += M[pos[i * L + c] * cb + pos[j * L + c]];
      }
    }
  }
  for (int64_t c = 0; c < L; ++c) {
    const int64_t den = (int64_t)nact[c] * (nact[c] - 1);
    out_conf[c] =
        den > 0 ? (int32_t)(200.0 * val[c] / (double)den) : 0;
  }
  for (int64_t k = 0; k < N; ++k)
    std::copy(rowsbuf.begin() + k * Lcap, rowsbuf.begin() + k * Lcap + L,
              out_rows + k * Lcap);
  return L;
}

}  // namespace msafull

extern "C" {

int64_t rtpu_mea_dp(const float* post, int64_t L1, int64_t L2,
                    uint8_t* edit_out, double* total_out) {
  return mea_dp(post, L1, L2, edit_out, total_out);
}

void rtpu_pairhmm_post_batch(const uint8_t* seqs, const int64_t* offs,
                             const int32_t* pa, const int32_t* pb,
                             int64_t npairs, const int64_t* out_offs,
                             float* out, double* tots, double* scores,
                             const float* li, const float* lt,
                             const float* les, const float* lep,
                             float cutoff, int64_t nthreads) {
  pairhmm::post_batch(seqs, offs, pa, pb, npairs, out_offs, out, tots,
                      scores, li, lt, les, lep, cutoff, nthreads);
}

void rtpu_posterior_accum(float* post, int64_t W, const float* P, int64_t l1,
                          int64_t l2, int64_t w, const int64_t* m1,
                          const int64_t* m2, int transpose) {
  posterior_accum(post, W, P, l1, l2, w, m1, m2, transpose);
}

void rtpu_build_posterior(float* post, int64_t W, const float** Ps,
                          const int64_t* pl1, const int64_t* pl2,
                          const int64_t* pw, const int32_t* tflags,
                          const int64_t* m1_idx, const int64_t* m2_idx,
                          const int64_t* m1_cat, const int64_t* m1_off,
                          const int64_t* m2_cat, const int64_t* m2_off,
                          int64_t npairs) {
  build_posterior_sum(post, W, Ps, pl1, pl2, pw, tflags, m1_idx, m2_idx,
                      m1_cat, m1_off, m2_cat, m2_off, npairs);
}

// Whole-MSA batch over independent bubbles (see namespace msafull).
// seqs: '@'-prefixed sequences concatenated; soffs: nseq+1 offsets;
// boffs: nb+1 bubble->sequence-range offsets; masks_cat/moffs: per-
// bubble (nrounds, N_b) refinement bipartitions; out_rows: per bubble
// at ooffs[b], (N_b, lcaps[b]) row-major; out_conf at coffs[b].
// Returns 0; per-bubble failures set out_lens[b] = -1.
int rtpu_msa_batch(const uint8_t* seqs, const int64_t* soffs,
                   const int64_t* boffs, int64_t nb,
                   const uint8_t* masks_cat, const int64_t* moffs,
                   int64_t consistency, int consgap, int64_t nrounds,
                   const float* li, const float* lt, const float* les,
                   const float* lep, float cutoff, uint8_t* out_rows,
                   const int64_t* ooffs, const int64_t* lcaps,
                   int64_t* out_lens, int32_t* out_conf,
                   const int64_t* coffs, int64_t nthreads) {
  msafull::Params P;
  for (int k = 0; k < 5; ++k) P.li[k] = li[k];
  for (int a = 0; a < 5; ++a)
    for (int b = 0; b < 5; ++b) P.lt[a][b] = lt[a * 5 + b];
  for (int c = 0; c < 256; ++c) P.les[c] = les[c];
  P.lep = lep;
  std::atomic<int64_t> nextb(0);
  auto worker = [&]() {
    msafull::Work W;
    for (;;) {
      const int64_t b = nextb.fetch_add(1);
      if (b >= nb) break;
      const int64_t s0 = boffs[b];
      const int64_t N = boffs[b + 1] - s0;
      out_lens[b] = msafull::msa_one(
          seqs, soffs + s0, N, P, cutoff, consistency, consgap,
          masks_cat + moffs[b], nrounds, out_rows + ooffs[b], lcaps[b],
          out_conf + coffs[b], W);
    }
  };
  int64_t nt = nthreads;
  if (nt <= 0) nt = (int64_t)std::thread::hardware_concurrency();
  if (nt > nb) nt = nb;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return 0;
}

int64_t rtpu_refine_rounds(const uint8_t* rows0, int64_t N, int64_t L0,
                           const float** mats, const int64_t* mrows,
                           const int64_t* mcols, const uint8_t* masks,
                           int64_t nrounds, uint8_t* out_rows,
                           int64_t Lcap) {
  return refine_rounds(rows0, N, L0, mats, mrows, mcols, masks, nrounds,
                       out_rows, Lcap);
}

int64_t rtpu_trim_overlap(int64_t* L, int64_t* P, int64_t k, int64_t d,
                          int64_t* ord_out) {
  return trim_overlap_dp(L, P, k, d, ord_out);
}

int rtpu_pick_multi(const int64_t* ls, const int64_t* ws,
                    const int64_t* coords, const int64_t* offs, int64_t k,
                    int64_t nsamples_seg, const int64_t* seq_starts,
                    const int64_t* seq_sids, int64_t nseq,
                    const uint16_t* SO, const int64_t* left_off,
                    const int64_t* right_off, int64_t nsid, int do_trim,
                    int64_t maxmums, int64_t wscore, double wpen,
                    int64_t seedsize, double pcutoff, int64_t minlength,
                    int64_t skip_rowlen, int64_t* out_hdr,
                    int64_t* split_coords, double* pvalue_out,
                    int64_t* skip_buf, int64_t* skip_counts,
                    double* skip_scores) {
  return pick_multi_dp(ls, ws, coords, offs, k, nsamples_seg, seq_starts,
                       seq_sids, nseq, SO, left_off, right_off, nsid,
                       do_trim, maxmums, wscore, wpen, seedsize, pcutoff,
                       minlength, skip_rowlen, out_hdr, split_coords,
                       pvalue_out, skip_buf, skip_counts, skip_scores);
}

int rtpu_pick_pairwise(const int64_t* ls, const int64_t* aa,
                       const int64_t* bb, int64_t k,
                       const int64_t* seq_starts, const int64_t* seq_sids,
                       int64_t nseq, const int64_t* left_off,
                       const int64_t* right_off, int64_t nsid, int do_trim,
                       int64_t maxmums, int64_t wscore, double wpen,
                       int64_t seedsize, double pcutoff, int64_t minlength,
                       int64_t* split_out /* [l, a, b] */,
                       double* pvalue_out, int64_t* skip_buf,
                       int64_t* skip_counts, double* skip_scores) {
  PickResult res;
  int st = pick_pairwise_dp(ls, aa, bb, k, seq_starts, seq_sids, nseq,
                            left_off, right_off, nsid, do_trim, maxmums,
                            wscore, wpen, seedsize, pcutoff, minlength,
                            &res, skip_buf, skip_counts, skip_scores);
  split_out[0] = res.split_l;
  split_out[1] = res.split_a;
  split_out[2] = res.split_b;
  *pvalue_out = res.pvalue;
  return st;
}

void rtpu_chain(const int64_t* starts, const int64_t* lens,
                const int64_t* nmul, int64_t k, int64_t d,
                const int64_t* left_start, double wpen, int64_t* link,
                double* scores) {
  chain_dp(starts, lens, nmul, k, d, left_start, wpen, link, scores);
}

int rtpu_sais32(const uint8_t* T, int32_t* SA, int32_t n) {
  return build_sa<int32_t>(T, SA, n);
}

int64_t rtpu_pairwise_mums(const uint8_t* T, const int64_t* SA,
                           const int64_t* LCP, int64_t n, int64_t nsep0,
                           int64_t minl, int rc, int64_t nT, int64_t* out_l,
                           int64_t* out_a, int64_t* out_b) {
  return pairwise_mums(T, SA, LCP, n, nsep0, minl, rc, nT, out_l, out_a,
                       out_b);
}

int64_t rtpu_pairwise_mums32(const uint8_t* T, const int32_t* SA,
                             const int32_t* LCP, int64_t n, int64_t nsep0,
                             int64_t minl, int rc, int64_t nT,
                             int32_t* out_l, int32_t* out_a,
                             int32_t* out_b) {
  return pairwise_mums(T, SA, LCP, n, nsep0, minl, rc, nT, out_l, out_a,
                       out_b);
}

void rtpu_split3(const int64_t* SA, const int64_t* LCP, const uint8_t* D_sa,
                 int64_t n, int64_t* SAi, int64_t* sa_l, int64_t* lcp_l,
                 int64_t* sa_t, int64_t* lcp_t, int64_t* sa_p,
                 int64_t* lcp_p, int64_t* out_n) {
  split3(SA, LCP, D_sa, n, SAi, sa_l, lcp_l, sa_t, lcp_t, sa_p, lcp_p,
         out_n);
}

int rtpu_sais64(const uint8_t* T, int64_t* SA, int64_t n) {
  return build_sa<int64_t>(T, SA, n);
}

void rtpu_repair_leading(int64_t* SA, int64_t* LCP, int64_t* SAi, int64_t n,
                         const int64_t* begins, int64_t nb) {
  repair_leading(SA, LCP, SAi, n, begins, nb);
}

void rtpu_repair_leading32(int32_t* SA, int32_t* LCP, int32_t* SAi,
                           int64_t n, const int64_t* begins, int64_t nb) {
  repair_leading(SA, LCP, SAi, n, begins, nb);
}

void rtpu_split3_full(const int64_t* SA, const int64_t* LCP, int64_t n,
                      int64_t* SAi, const int64_t* iv, int64_t niv,
                      int64_t* sa_buf, int64_t* lcp_buf, int64_t* out_n) {
  split3_full(SA, LCP, n, SAi, iv, niv, sa_buf, lcp_buf, out_n);
}

void rtpu_split3_full32(const int32_t* SA, const int32_t* LCP, int64_t n,
                        int32_t* SAi, const int64_t* iv, int64_t niv,
                        int32_t* sa_buf, int32_t* lcp_buf, int64_t* out_n) {
  split3_full(SA, LCP, n, SAi, iv, niv, sa_buf, lcp_buf, out_n);
}

void rtpu_split3_repair_enum(const int64_t* SA, const int64_t* LCP,
                             int64_t n, int64_t* SAi, const int64_t* iv,
                             int64_t niv, uint8_t* T,
                             const int64_t* matches, int64_t nm,
                             int64_t nsep0, int64_t minl, int enum_lead,
                             int enum_trail, int64_t* sa_buf,
                             int64_t* lcp_buf, int64_t* ml, int64_t* ma,
                             int64_t* mb, int64_t* out_n) {
  split3_repair_enum(SA, LCP, n, SAi, iv, niv, T, matches, nm, nsep0,
                     minl, enum_lead, enum_trail, sa_buf, lcp_buf, ml, ma,
                     mb, out_n);
}

void rtpu_split3_repair_enum32(const int32_t* SA, const int32_t* LCP,
                               int64_t n, int32_t* SAi, const int64_t* iv,
                               int64_t niv, uint8_t* T,
                               const int64_t* matches, int64_t nm,
                               int64_t nsep0, int64_t minl, int enum_lead,
                               int enum_trail, int32_t* sa_buf,
                               int32_t* lcp_buf, int32_t* ml, int32_t* ma,
                               int32_t* mb, int64_t* out_n) {
  split3_repair_enum(SA, LCP, n, SAi, iv, niv, T, matches, nm, nsep0,
                     minl, enum_lead, enum_trail, sa_buf, lcp_buf, ml, ma,
                     mb, out_n);
}

int64_t rtpu_multimums(const uint8_t* T, const int64_t* SA,
                       const int64_t* LCP, const uint16_t* SO, int64_t n,
                       int64_t nsamples_main, int64_t minl, int64_t minn,
                       int64_t* out_l, int64_t* out_lb, int64_t* out_ub) {
  return multimums_scan(T, SA, LCP, SO, n, nsamples_main, minl, minn,
                        out_l, out_lb, out_ub);
}

int64_t rtpu_multimums32(const uint8_t* T, const int32_t* SA,
                         const int32_t* LCP, const uint16_t* SO, int64_t n,
                         int64_t nsamples_main, int64_t minl, int64_t minn,
                         int32_t* out_l, int32_t* out_lb, int32_t* out_ub) {
  return multimums_scan(T, SA, LCP, SO, n, nsamples_main, minl, minn,
                        out_l, out_lb, out_ub);
}

int64_t rtpu_rem2_loop(uint8_t* T, const int64_t* SA, const int64_t* LCP,
                       int64_t* SAi, int64_t n, int64_t nsep0,
                       int64_t minlength, int do_trim, int64_t maxmums,
                       int64_t wscore, double wpen, double pcutoff,
                       int64_t nthreads, int64_t** out_anchors) {
  if (nthreads > 1) {
    return rem2_loop_par(T, SA, LCP, SAi, n, nsep0, minlength, do_trim,
                         maxmums, wscore, wpen, pcutoff, nthreads,
                         out_anchors);
  }
  return rem2_loop(T, SA, LCP, SAi, n, nsep0, minlength, do_trim, maxmums,
                   wscore, wpen, pcutoff, out_anchors);
}

int64_t rtpu_rem2_loop32(uint8_t* T, const int32_t* SA, const int32_t* LCP,
                         int32_t* SAi, int64_t n, int64_t nsep0,
                         int64_t minlength, int do_trim, int64_t maxmums,
                         int64_t wscore, double wpen, double pcutoff,
                         int64_t nthreads, int64_t** out_anchors) {
  if (nthreads > 1) {
    return rem2_loop_par(T, SA, LCP, SAi, n, nsep0, minlength, do_trim,
                         maxmums, wscore, wpen, pcutoff, nthreads,
                         out_anchors);
  }
  return rem2_loop(T, SA, LCP, SAi, n, nsep0, minlength, do_trim, maxmums,
                   wscore, wpen, pcutoff, out_anchors);
}

// rem2 with deferral: the host runs the big-candidate prefix of the
// recursion, small segments are returned for the device kernel.
// out_defer gets a malloc'd flat buffer (caller frees via rtpu_free):
// per deferred segment [n, k, aBeg, aEnd, bBeg, bEnd, SA[n], LCP[n]].
int64_t rtpu_rem2_defer32(uint8_t* T, const int32_t* SA,
                          const int32_t* LCP, int32_t* SAi, int64_t n,
                          int64_t nsep0, int64_t minlength, int do_trim,
                          int64_t maxmums, int64_t wscore, double wpen,
                          double pcutoff, int64_t defer_max,
                          int64_t** out_anchors, int64_t** out_defer,
                          int64_t* out_defer_len) {
  std::vector<int64_t> defer;
  int64_t na = rem2_loop(T, SA, LCP, SAi, n, nsep0, minlength, do_trim,
                         maxmums, wscore, wpen, pcutoff, out_anchors,
                         defer_max, &defer);
  if (na < 0) {
    *out_defer = nullptr;
    *out_defer_len = 0;
    return na;
  }
  int64_t* buf = (int64_t*)std::malloc(
      (defer.size() ? defer.size() : 1) * sizeof(int64_t));
  if (!buf) {
    *out_defer = nullptr;
    *out_defer_len = 0;
    return -1;
  }
  std::memcpy(buf, defer.data(), defer.size() * sizeof(int64_t));
  *out_defer = buf;
  *out_defer_len = (int64_t)defer.size();
  return na;
}

int64_t rtpu_rem2_defer64(uint8_t* T, const int64_t* SA,
                          const int64_t* LCP, int64_t* SAi, int64_t n,
                          int64_t nsep0, int64_t minlength, int do_trim,
                          int64_t maxmums, int64_t wscore, double wpen,
                          double pcutoff, int64_t defer_max,
                          int64_t** out_anchors, int64_t** out_defer,
                          int64_t* out_defer_len) {
  std::vector<int64_t> defer;
  int64_t na = rem2_loop(T, SA, LCP, SAi, n, nsep0, minlength, do_trim,
                         maxmums, wscore, wpen, pcutoff, out_anchors,
                         defer_max, &defer);
  if (na < 0) {
    *out_defer = nullptr;
    *out_defer_len = 0;
    return na;
  }
  int64_t* buf = (int64_t*)std::malloc(
      (defer.size() ? defer.size() : 1) * sizeof(int64_t));
  if (!buf) {
    *out_defer = nullptr;
    *out_defer_len = 0;
    return -1;
  }
  std::memcpy(buf, defer.data(), defer.size() * sizeof(int64_t));
  *out_defer = buf;
  *out_defer_len = (int64_t)defer.size();
  return na;
}

// threaded variant of rtpu_rem2_defer*: the worker pool processes the
// host prefix in parallel (rem2_loop_par), deferral + placeholder ids
// identical to the serial engine (assigned on the serial-pop-order
// reconstruction walk)
int64_t rtpu_rem2_defer_par32(uint8_t* T, const int32_t* SA,
                              const int32_t* LCP, int32_t* SAi,
                              int64_t n, int64_t nsep0,
                              int64_t minlength, int do_trim,
                              int64_t maxmums, int64_t wscore,
                              double wpen, double pcutoff,
                              int64_t defer_max, int64_t nthreads,
                              int64_t** out_anchors,
                              int64_t** out_defer,
                              int64_t* out_defer_len) {
  std::vector<int64_t> defer;
  int64_t na = rem2_loop_par(T, SA, LCP, SAi, n, nsep0, minlength,
                             do_trim, maxmums, wscore, wpen, pcutoff,
                             nthreads, out_anchors, defer_max, &defer);
  if (na < 0) {
    *out_defer = nullptr;
    *out_defer_len = 0;
    return na;
  }
  int64_t* buf = (int64_t*)std::malloc(
      (defer.size() ? defer.size() : 1) * sizeof(int64_t));
  if (!buf) {
    *out_defer = nullptr;
    *out_defer_len = 0;
    return -1;
  }
  std::memcpy(buf, defer.data(), defer.size() * sizeof(int64_t));
  *out_defer = buf;
  *out_defer_len = (int64_t)defer.size();
  return na;
}

int64_t rtpu_rem2_defer_par64(uint8_t* T, const int64_t* SA,
                              const int64_t* LCP, int64_t* SAi,
                              int64_t n, int64_t nsep0,
                              int64_t minlength, int do_trim,
                              int64_t maxmums, int64_t wscore,
                              double wpen, double pcutoff,
                              int64_t defer_max, int64_t nthreads,
                              int64_t** out_anchors,
                              int64_t** out_defer,
                              int64_t* out_defer_len) {
  std::vector<int64_t> defer;
  int64_t na = rem2_loop_par(T, SA, LCP, SAi, n, nsep0, minlength,
                             do_trim, maxmums, wscore, wpen, pcutoff,
                             nthreads, out_anchors, defer_max, &defer);
  if (na < 0) {
    *out_defer = nullptr;
    *out_defer_len = 0;
    return na;
  }
  int64_t* buf = (int64_t*)std::malloc(
      (defer.size() ? defer.size() : 1) * sizeof(int64_t));
  if (!buf) {
    *out_defer = nullptr;
    *out_defer_len = 0;
    return -1;
  }
  std::memcpy(buf, defer.data(), defer.size() * sizeof(int64_t));
  *out_defer = buf;
  *out_defer_len = (int64_t)defer.size();
  return na;
}

void rtpu_free(void* p) { std::free(p); }

void rtpu_kasai64(const uint8_t* T, const int64_t* SA, int64_t* SAi,
                  int64_t* LCP, int64_t n) {
  kasai_capped<int64_t>(T, SA, SAi, LCP, n);
}

void rtpu_kasai32(const uint8_t* T, const int32_t* SA, int32_t* SAi,
                  int32_t* LCP, int32_t n) {
  kasai_capped<int32_t>(T, SA, SAi, LCP, n);
}

void rtpu_glocal_dp(const int64_t* S1, const int64_t* E1, const int64_t* S2,
                    const int64_t* E2, const int64_t* O, const int64_t* REF,
                    const int64_t* CTG, const int64_t* SCORE, int64_t ncand,
                    const int64_t* RNG0, const int64_t* RNG1,
                    double rearrangecost, double inversioncost,
                    double lambda_, double eps, double alfa, double gapopen,
                    int64_t lastn, int64_t lastbp, int axis,
                    int64_t* out_best, double* out_score) {
  GlocalParams P{rearrangecost, inversioncost, lambda_, eps,
                 alfa,          gapopen,       lastn,   lastbp, axis};
  glocal_dp(S1, E1, S2, E2, O, REF, CTG, SCORE, ncand, RNG0, RNG1, P,
            out_best, out_score);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Pairwise graph-surgery replay (align/rem._rem2_replay semantics in C).
//
// Simulates the exact breaknode(A) + breaknode(B) + mergenodes sequence
// over interval nodes, preserving node and edge INSERTION ORDER so the
// Python dict rebuild is operation-for-operation identical to the
// per-step engine's graph (GFA topological numbering included).  The
// Python replay costs ~0.23 s on 2a2b (12.8k breaks of dict/set
// micro-ops); this runs in ~5 ms and hands back flat arrays.
//
// Node 0 = start marker, node 1 = end marker (string nodes on the
// Python side); nodes 2/3 = the two fasta roots.  Edge path sets are
// 2-bit masks (path 0 / path 1).
// ---------------------------------------------------------------------------

namespace replay {

struct Adj {
  int32_t nbr;
  int32_t eid;
};

struct RNode {
  int64_t s, e;        // interval (markers: s = -1 / -2)
  int64_t off[2];
  uint8_t has[2];
  uint8_t aligned;
  uint8_t alive;
  std::vector<Adj> succ, pred;
};

struct Sim {
  std::vector<RNode> nodes;
  std::vector<uint8_t> emask;
  std::unordered_map<uint64_t, int32_t> live;

  static uint64_t key(int64_t s, int64_t e) {
    return (uint64_t)s << 32 | (uint32_t)e;
  }

  int32_t new_node(int64_t s, int64_t e) {
    RNode nd;
    nd.s = s;
    nd.e = e;
    nd.off[0] = nd.off[1] = 0;
    nd.has[0] = nd.has[1] = 0;
    nd.aligned = 0;
    nd.alive = 1;
    nodes.push_back(std::move(nd));
    if (s >= 0) live[key(s, e)] = (int32_t)nodes.size() - 1;
    return (int32_t)nodes.size() - 1;
  }

  int32_t new_edge(uint8_t mask) {
    emask.push_back(mask);
    return (int32_t)emask.size() - 1;
  }

  static void drop(std::vector<Adj>& v, int32_t nbr) {
    for (size_t i = 0; i < v.size(); ++i)
      if (v[i].nbr == nbr) {
        v.erase(v.begin() + i);
        return;
      }
  }

  // breaknode(node, (pos, pos+l)) — rem.py _rem2_replay.brk
  int32_t brk(int64_t ns, int64_t ne, int64_t pos, int64_t l) {
    int32_t ni = live.at(key(ns, ne));
    if (ns == pos && ne == pos + l) return ni;
    uint8_t pospaths = 0;
    {
      RNode& nd = nodes[ni];
      if (!nd.pred.empty() || !nd.succ.empty()) {
        for (const Adj& a : nd.pred) pospaths |= emask[a.eid];
        for (const Adj& a : nd.succ) pospaths |= emask[a.eid];
      } else {
        pospaths = (uint8_t)(nd.has[0] | (nd.has[1] << 1));
      }
    }

    const int64_t n_s = nodes[ni].s;
    const int64_t n_e = nodes[ni].e;
    int32_t mn = new_node(pos, pos + l);
    for (int p = 0; p < 2; ++p)
      if (nodes[ni].has[p]) {
        nodes[mn].has[p] = 1;
        nodes[mn].off[p] = nodes[ni].off[p] + (pos - n_s);
      }

    int32_t pn = mn;
    if (n_s != pos) {
      pn = new_node(n_s, pos);
      for (int p = 0; p < 2; ++p)
        if (nodes[ni].has[p]) {
          nodes[pn].has[p] = 1;
          nodes[pn].off[p] = nodes[ni].off[p];
        }
      int32_t eid = new_edge(pospaths);
      nodes[pn].succ.push_back({mn, eid});
      nodes[mn].pred.push_back({pn, eid});
    }
    int32_t sn = mn;
    if (n_e != pos + l) {
      sn = new_node(pos + l, n_e);
      for (int p = 0; p < 2; ++p)
        if (nodes[ni].has[p]) {
          nodes[sn].has[p] = 1;
          nodes[sn].off[p] = nodes[ni].off[p] + (pos + l - n_s);
        }
      int32_t eid = new_edge(pospaths);
      nodes[mn].succ.push_back({sn, eid});
      nodes[sn].pred.push_back({mn, eid});
    }

    // detach + delete the original, reattach its edges (copies)
    std::vector<Adj> in_items;
    std::vector<Adj> out_items;
    in_items.swap(nodes[ni].pred);
    out_items.swap(nodes[ni].succ);
    for (const Adj& a : out_items) drop(nodes[a.nbr].pred, ni);
    for (const Adj& a : in_items) drop(nodes[a.nbr].succ, ni);
    nodes[ni].alive = 0;
    live.erase(key(ns, ne));
    for (const Adj& a : in_items) {
      int32_t eid = new_edge(emask[a.eid]);
      nodes[a.nbr].succ.push_back({pn, eid});
      nodes[pn].pred.push_back({a.nbr, eid});
    }
    for (const Adj& a : out_items) {
      int32_t eid = new_edge(emask[a.eid]);
      nodes[sn].succ.push_back({a.nbr, eid});
      nodes[a.nbr].pred.push_back({sn, eid});
    }
    return mn;
  }

  static int find(const std::vector<Adj>& v, int32_t nbr) {
    for (size_t i = 0; i < v.size(); ++i)
      if (v[i].nbr == nbr) return (int)i;
    return -1;
  }

  // mergenodes([a, b]) — DiGraph branch
  void merge(int32_t a, int32_t b) {
    for (int p = 0; p < 2; ++p)
      if (nodes[b].has[p]) {
        nodes[a].has[p] = 1;
        nodes[a].off[p] = nodes[b].off[p];
      }
    nodes[a].aligned = 1;
    std::vector<Adj> bpred, bsucc;
    bpred.swap(nodes[b].pred);
    bsucc.swap(nodes[b].succ);
    for (const Adj& ad : bpred) {
      int j = find(nodes[a].pred, ad.nbr);
      if (j >= 0) {
        emask[nodes[a].pred[j].eid] |= emask[ad.eid];
      } else {
        int32_t eid = new_edge(emask[ad.eid]);
        nodes[ad.nbr].succ.push_back({a, eid});
        nodes[a].pred.push_back({ad.nbr, eid});
      }
      drop(nodes[ad.nbr].succ, b);
    }
    for (const Adj& ad : bsucc) {
      int j = find(nodes[a].succ, ad.nbr);
      if (j >= 0) {
        emask[nodes[a].succ[j].eid] |= emask[ad.eid];
      } else {
        int32_t eid = new_edge(emask[ad.eid]);
        nodes[a].succ.push_back({ad.nbr, eid});
        nodes[ad.nbr].pred.push_back({a, eid});
      }
      drop(nodes[ad.nbr].pred, b);
    }
    nodes[b].alive = 0;
    live.erase(key(nodes[b].s, nodes[b].e));
  }
};

}  // namespace replay

extern "C" {

// anchors: (A, 7) int64 rows [ma, mb, l, a_beg, a_end, b_beg, b_end] in
// serial LIFO pop order.  The initial graph is passed in: N nodes in
// dict-insertion order (markers have ns < 0, one unique sentinel each;
// interval nodes carry offsets/flags), per-node succ and pred
// adjacency in their dict orders (edge masks aligned with the succ
// scan; pred entries resolve to the same edge objects via (u,v)).
// Call rtpu_replay_fetch to copy the result, rtpu_replay_end to free.
void* rtpu_replay_pairwise(const int64_t* anchors, int64_t A,
                           const int64_t* ns0, const int64_t* ne0,
                           const int64_t* off0_in, const int64_t* off1_in,
                           const uint8_t* nflags, int64_t N,
                           const int64_t* succ_cnt0,
                           const int64_t* succ_nbr0,
                           const uint8_t* succ_mask0,
                           const int64_t* pred_cnt0,
                           const int64_t* pred_nbr0,
                           int64_t* out_nnodes, int64_t* out_nsucc,
                           int64_t* out_npred) {
  auto* sim = new replay::Sim();
  sim->nodes.reserve((size_t)(4 * A + N + 8));
  sim->emask.reserve((size_t)(8 * A + 8));
  for (int64_t i = 0; i < N; ++i) {
    int32_t idx = sim->new_node(ns0[i], ne0[i]);
    replay::RNode& nd = sim->nodes[idx];
    nd.has[0] = nflags[i] & 1;
    nd.has[1] = (nflags[i] >> 1) & 1;
    nd.aligned = (nflags[i] >> 2) & 1;
    nd.off[0] = off0_in[i];
    nd.off[1] = off1_in[i];
  }
  // succ scan creates the edge objects; pred scan shares them
  std::unordered_map<uint64_t, int32_t> emap;
  int64_t k = 0;
  for (int64_t u = 0; u < N; ++u)
    for (int64_t j = 0; j < succ_cnt0[u]; ++j, ++k) {
      int32_t v = (int32_t)succ_nbr0[k];
      int32_t eid = sim->new_edge(succ_mask0[k]);
      sim->nodes[u].succ.push_back({v, eid});
      emap[(uint64_t)u << 32 | (uint32_t)v] = eid;
    }
  k = 0;
  for (int64_t v = 0; v < N; ++v)
    for (int64_t j = 0; j < pred_cnt0[v]; ++j, ++k) {
      int32_t u = (int32_t)pred_nbr0[k];
      sim->nodes[v].pred.push_back(
          {u, emap.at((uint64_t)u << 32 | (uint32_t)v)});
    }

  for (int64_t i = 0; i < A; ++i) {
    const int64_t* r = anchors + 7 * i;
    int32_t mn_a = sim->brk(r[3], r[4], r[0], r[2]);
    int32_t mn_b = sim->brk(r[5], r[6], r[1], r[2]);
    sim->merge(mn_a, mn_b);
  }

  int64_t nn = 0, nsu = 0, npr = 0;
  for (const replay::RNode& nd : sim->nodes)
    if (nd.alive) {
      ++nn;
      nsu += (int64_t)nd.succ.size();
      npr += (int64_t)nd.pred.size();
    }
  *out_nnodes = nn;
  *out_nsucc = nsu;
  *out_npred = npr;
  return sim;
}

void rtpu_replay_fetch(void* handle, int64_t* ns, int64_t* ne,
                       int64_t* off0, int64_t* off1, uint8_t* flags,
                       int64_t* succ_cnt, int64_t* pred_cnt,
                       int64_t* succ_nbr, int64_t* succ_eid,
                       int64_t* pred_nbr, int64_t* pred_eid,
                       uint8_t* edge_mask) {
  auto* sim = (replay::Sim*)handle;
  std::vector<int64_t> remap(sim->nodes.size(), -1);
  int64_t k = 0;
  for (size_t i = 0; i < sim->nodes.size(); ++i)
    if (sim->nodes[i].alive) remap[i] = k++;
  int64_t su = 0, pr = 0;
  k = 0;
  for (size_t i = 0; i < sim->nodes.size(); ++i) {
    const replay::RNode& nd = sim->nodes[i];
    if (!nd.alive) continue;
    ns[k] = nd.s;
    ne[k] = nd.e;
    off0[k] = nd.off[0];
    off1[k] = nd.off[1];
    flags[k] = (uint8_t)(nd.has[0] | (nd.has[1] << 1) | (nd.aligned << 2));
    succ_cnt[k] = (int64_t)nd.succ.size();
    pred_cnt[k] = (int64_t)nd.pred.size();
    for (const replay::Adj& a : nd.succ) {
      succ_nbr[su] = remap[a.nbr];
      succ_eid[su] = a.eid;
      ++su;
    }
    for (const replay::Adj& a : nd.pred) {
      pred_nbr[pr] = remap[a.nbr];
      pred_eid[pr] = a.eid;
      ++pr;
    }
    ++k;
  }
  std::memcpy(edge_mask, sim->emask.data(), sim->emask.size());
}

int64_t rtpu_replay_nedges(void* handle) {
  return (int64_t)((replay::Sim*)handle)->emask.size();
}

void rtpu_replay_end(void* handle) { delete (replay::Sim*)handle; }

}  // extern "C"
