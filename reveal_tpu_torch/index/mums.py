"""MUM / multiMUM enumeration over an enhanced suffix array segment.

Semantics mirror the reference C engine:

* pairwise MUMs (2 samples): scan adjacent SA entries; conditions are
  LCP >= minl, the two suffixes straddle the first sample boundary (not a
  repeat), left-maximality (previous characters differ or are 'N'/'$'/
  lowercase), and uniqueness (strictly larger LCP than both neighbours)
  (reveallib/reveal.c:55-180).

* multiMUMs (>2 samples): LCP-interval enumeration — the reference walks a
  stack over the LCP array (reveallib/reveal.c:436-580); here
  the same intervals are derived data-parallel via previous/next-smaller-value
  (PSV/NSV) pointer doubling + row dedup, then per-interval
  distinct-sample and left-maximality checks run vectorized
  (ismultimum, reveal.c:227-259).

Everything is elementwise/gather math; host numpy is used for the
(shrinking) per-segment rescans of the recursion.  ``pairwise_mums_device``
is the same pairwise scan over torch tensors on one device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.encoding import N_BYTE, SENTINEL

Mum = Tuple[int, int, Tuple[Tuple[int, int], ...]]


def _leftmax_vec(T: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Left-maximality of a match starting at positions a and b."""
    safe_a = np.maximum(a - 1, 0)
    safe_b = np.maximum(b - 1, 0)
    ta = T[safe_a]
    tb = T[safe_b]
    prevdiff = (
        (ta != tb)
        | (ta == N_BYTE)
        | (ta == SENTINEL)
        | ((ta >= ord("a")) & (ta <= ord("z")))
    )
    return (a == 0) | (b == 0) | prevdiff


def pairwise_mums(
    T: np.ndarray,
    SA: np.ndarray,
    LCP: np.ndarray,
    nsep0: int,
    minl: int = 0,
    rc: bool = False,
    nT: int = 0,
    rem_format: bool = True,
) -> List[Mum]:
    """Vectorized port of getmums_rem / getmums (reveal.c:55-180).

    Returns, for rem_format=True, tuples ``(l, 2, ((0, aStart), (1, bStart)))``;
    otherwise ``(l, (aStart, bStart), rc)`` like getmums.
    """
    n = len(SA)
    if n < 2:
        return []

    # native per-segment scan when available
    try:
        from ..native import pairwise_mums_native

        res = pairwise_mums_native(T, SA, LCP, nsep0, minl, rc, nT)
    except Exception:
        res = None
    if res is not None:
        ls, aa, bb = res
        if rem_format:
            return [
                (li, 2, ((0, ai), (1, bi)))
                for li, ai, bi in zip(ls.tolist(), aa.tolist(), bb.tolist())
            ]
        rcint = 1 if rc else 0
        return [
            (li, (ai, bi), rcint)
            for li, ai, bi in zip(ls.tolist(), aa.tolist(), bb.tolist())
        ]

    l = LCP[1:]
    prev_sa = SA[:-1]
    cur_sa = SA[1:]
    straddle = (cur_sa > nsep0) != (prev_sa > nsep0)
    a = np.minimum(cur_sa, prev_sa)
    b = np.maximum(cur_sa, prev_sa)
    leftmax = _leftmax_vec(T, a, b)
    la = np.empty(n - 1, dtype=LCP.dtype)
    la[: n - 2] = LCP[2:]
    la[n - 2] = 0
    unique = (LCP[:-1] < l) & (la < l)
    keep = (l >= minl) & straddle & leftmax & unique & (l > 0)
    idx = np.nonzero(keep)[0]
    out = []
    ls = l[idx]
    aa = a[idx]
    bb = b[idx]
    if rc:
        bb = nsep0 + (nT - bb - ls)
    if rem_format:
        for li, ai, bi in zip(ls.tolist(), aa.tolist(), bb.tolist()):
            out.append((li, 2, ((0, ai), (1, bi))))
    else:
        rcint = 1 if rc else 0
        for li, ai, bi in zip(ls.tolist(), aa.tolist(), bb.tolist()):
            out.append((li, (ai, bi), rcint))
    return out


def _psv_nsv(LCP: np.ndarray):
    """Previous/next index with strictly smaller LCP, by pointer doubling.

    psv[i] = max{j < i : LCP[j] < LCP[i]} (or -1)
    nsv[i] = min{j > i : LCP[j] < LCP[i]} (or n)
    """
    n = len(LCP)
    psv = np.arange(-1, n - 1, dtype=np.int64)
    converged = False
    for _ in range(2 * int(np.ceil(np.log2(max(n, 2)))) + 8):
        valid = psv >= 0
        tgt = np.where(valid, psv, 0)
        jump = valid & (LCP[tgt] >= LCP)
        if not jump.any():
            converged = True
            break
        psv = np.where(jump, psv[tgt], psv)
    if not converged:  # exact sequential fallback (should not trigger)
        stack = []
        for i in range(n):
            while stack and LCP[stack[-1]] >= LCP[i]:
                stack.pop()
            psv[i] = stack[-1] if stack else -1
            stack.append(i)
    nsv = np.arange(1, n + 1, dtype=np.int64)
    converged = False
    for _ in range(2 * int(np.ceil(np.log2(max(n, 2)))) + 8):
        valid = nsv < n
        tgt = np.where(valid, nsv, n - 1)
        jump = valid & (LCP[tgt] >= LCP)
        if not jump.any():
            converged = True
            break
        nsv = np.where(jump, nsv[tgt], nsv)
    if not converged:
        stack = []
        for i in range(n - 1, -1, -1):
            while stack and LCP[stack[-1]] >= LCP[i]:
                stack.pop()
            nsv[i] = stack[-1] if stack else n
            stack.append(i)
    return psv, nsv


def lcp_intervals(LCP: np.ndarray, minl: int = 1):
    """All distinct lcp-intervals (l, lb, ub) with l >= max(minl,1).

    Suffix range is SA[lb..ub] inclusive; l = min(LCP[lb+1..ub]);
    LCP[lb] < l (or lb==0), LCP[ub+1] < l (or ub==n-1).  This is exactly the
    set the reference's stack walk emits (reveal.c:465-536).
    """
    n = len(LCP)
    minl = max(minl, 1)
    cand = np.nonzero(LCP >= minl)[0]
    if len(cand) == 0:
        return (
            np.empty(0, np.int64),
            np.empty(0, np.int64),
            np.empty(0, np.int64),
        )
    psv, nsv = _psv_nsv(LCP)
    lb = psv[cand]  # suffix range start = psv index itself (LCP[i] relates
    # SA[i-1],SA[i]; run [psv+1..nsv-1] of LCP>=l covers suffixes psv..nsv-1)
    ub = nsv[cand] - 1
    l = LCP[cand]
    # clamp lb: psv==-1 means run starts at SA[0]
    lb = np.where(lb < 0, 0, lb)
    triples = np.stack([l, lb, ub], axis=1)
    uniq = np.unique(triples, axis=0)
    return uniq[:, 0], uniq[:, 1], uniq[:, 2]


def tuples_from_arrays(ls, ws, flat, offs, SO):
    """Materialize (l, w, ((sample, pos), ...)) multiMUM tuples from the
    ragged arrays of getmultimums_arrays (same order)."""
    so_f = SO[flat].tolist()
    sa_f = flat.tolist()
    out = []
    o = offs.tolist()
    for i, (li, wi) in enumerate(zip(ls.tolist(), ws.tolist())):
        s, e = o[i], o[i + 1]
        out.append((li, wi, tuple(zip(so_f[s:e], sa_f[s:e]))))
    return out


def multimums(
    T: np.ndarray,
    SA: np.ndarray,
    LCP: np.ndarray,
    SO: np.ndarray,
    nsamples_main: int,
    minl: int = 0,
    minn: int = 2,
) -> List[Mum]:
    """Vectorized port of getmultimums (reveal.c:436-580).

    Emits (l, n_occ, ((sample, pos), ... in SA order)) for every lcp-interval
    whose suffixes come from n_occ distinct samples (each exactly once),
    with some adjacent pair left-maximal, n_occ in [minn, nsamples_main].
    """
    # native linear stack walk (reveal.c:436-580); results re-sorted to
    # the (l, lb, ub) lexicographic order the vectorized path emits so
    # downstream tie-breaking is identical
    try:
        from ..native import multimums_native

        res = multimums_native(
            T, SA, LCP, SO, nsamples_main, max(minl, 1), minn
        )
    except Exception:
        res = None
    if res is not None:
        ls, lbs, ubs = res
        if len(ls) == 0:
            return []
        order = np.lexsort((ubs, lbs, ls))
        starts = lbs[order]
        widths = (ubs - lbs + 1)[order]
        # vectorized concatenation of all [lb..ub] index ranges
        total = int(widths.sum())
        ends = np.cumsum(widths)
        offs = np.arange(total) - np.repeat(ends - widths, widths)
        flat = np.repeat(starts, widths) + offs
        sa_f = SA[flat].tolist()
        so_f = SO[SA[flat]].tolist()
        ls_o = ls[order].tolist()
        w_l = widths.tolist()
        e_l = ends.tolist()
        out = []
        for li, w, e in zip(ls_o, w_l, e_l):
            s = e - w
            out.append(
                (li, w, tuple(zip(so_f[s:e], sa_f[s:e])))
            )
        return out

    l, lb, ub = lcp_intervals(LCP, minl)
    width = ub - lb + 1
    keep = (width >= minn) & (width <= nsamples_main)
    l, lb, ub, width = l[keep], lb[keep], ub[keep], width[keep]
    if len(l) == 0:
        return []

    W = int(width.max())
    cols = lb[:, None] + np.arange(W)[None, :]
    valid = cols <= ub[:, None]
    cols_c = np.minimum(cols, len(SA) - 1)
    sa_rows = SA[cols_c]
    so_rows = SO[sa_rows].astype(np.int64)
    so_rows = np.where(valid, so_rows, np.int64(-1) - np.arange(W)[None, :])
    # distinct samples: sort each (short) row, adjacent values must differ
    so_sorted = np.sort(so_rows, axis=1)
    distinct = np.all(so_sorted[:, 1:] != so_sorted[:, :-1], axis=1)

    # left-maximality over adjacent pairs within the interval
    a = sa_rows[:, :-1]
    b = sa_rows[:, 1:]
    pair_valid = valid[:, 1:]
    lm = _leftmax_vec(T, np.abs(a), np.abs(b)) & pair_valid
    anymax = lm.any(axis=1) if W > 1 else np.zeros(len(l), bool)

    keep2 = distinct & anymax
    out = []
    for li, lbi, ubi in zip(
        l[keep2].tolist(), lb[keep2].tolist(), ub[keep2].tolist()
    ):
        coords = tuple(
            (int(SO[SA[j]]), int(SA[j])) for j in range(lbi, ubi + 1)
        )
        out.append((li, ubi - lbi + 1, coords))
    return out


def multimems(
    T: np.ndarray,
    SA: np.ndarray,
    LCP: np.ndarray,
    SO: np.ndarray,
    nsamples_main: int,
    minl: int = 0,
    minn: int = 2,
    bucket_width: int = 64,
) -> List[Mum]:
    """Port of getmultimems (reveal.c:292-434): like multimums but samples may
    repeat; n reported = number of distinct samples; requires n >= minn.

    All LCP intervals are enumerated like the reference (no width limit);
    intervals up to ``bucket_width`` wide ride the padded vectorized path,
    wider ones (rare repeat regions) are checked row-by-row."""
    l, lb, ub = lcp_intervals(LCP, minl)
    width = ub - lb + 1
    keep = width >= minn
    l, lb, ub, width = l[keep], lb[keep], ub[keep], width[keep]
    if len(l) == 0:
        return []

    rows = []  # (l, lb, ub, n_distinct)
    wide = width > bucket_width
    # wide intervals: per-row exact check (reference has no width cap)
    for r in np.nonzero(wide)[0].tolist():
        lbi, ubi = int(lb[r]), int(ub[r])
        seg = SA[lbi : ubi + 1]
        if not _leftmax_vec(T, seg[:-1], seg[1:]).any():
            continue
        c = len(np.unique(SO[seg]))
        if c >= minn:
            rows.append((int(l[r]), lbi, ubi, c))

    sel = ~wide
    l, lb, ub, width = l[sel], lb[sel], ub[sel], width[sel]
    if len(l):
        W = int(width.max())
        cols = lb[:, None] + np.arange(W)[None, :]
        valid = cols <= ub[:, None]
        cols_c = np.minimum(cols, len(SA) - 1)
        sa_rows = SA[cols_c]
        so_rows = SO[sa_rows].astype(np.int64)
        so_rows_m = np.where(valid, so_rows, -1)
        a = sa_rows[:, :-1]
        b = sa_rows[:, 1:]
        pair_valid = valid[:, 1:]
        lm = _leftmax_vec(T, a, b) & pair_valid
        anymax = lm.any(axis=1) if W > 1 else np.zeros(len(l), bool)
        for r in np.nonzero(anymax)[0].tolist():
            so_set = set(so_rows_m[r][valid[r]].tolist())
            c = len(so_set)
            if c < minn:
                continue
            rows.append((int(l[r]), int(lb[r]), int(ub[r]), c))

    rows.sort()
    out = []
    for li, lbi, ubi, c in rows:
        coords = tuple(
            (int(SO[SA[j]]), int(SA[j])) for j in range(lbi, ubi + 1)
        )
        out.append((li, c, coords))
    return out


# ---------------------------------------------------------------------------
# device pairwise MUM scan (the building block of the batched recursion
# frontier): all conditions of reveal.c:119-180 as elementwise/gather math
# over device tensors
# ---------------------------------------------------------------------------

def pairwise_mums_device(T, SA, LCP, nsep0: int, minl: int):
    """Pairwise MUM scan of one index on the device its tensors lie on
    (the counterpart of ``reveal_tpu``'s ``pairwise_mums_device``,
    mums.py:366-440): T, SA, LCP tensors of one device (SA and LCP of one
    integer type); returns numpy (l, a, b) in ascending slot order, slot
    i pairing SA[i-1] with SA[i]."""
    import torch

    from .devfrontier import pair_mask

    mask, a, b = pair_mask(T, SA, LCP, int(nsep0), int(minl))
    idx = torch.nonzero(mask).squeeze(1)
    l, a, b = torch.stack([LCP[idx], a[idx], b[idx]]).cpu().numpy()
    return l, a, b


# ---------------------------------------------------------------------------
# direct (slow) port of the reference stack walk — used as a test oracle
# ---------------------------------------------------------------------------

def multimums_oracle(T, SA, LCP, SO, nsamples_main, minl=0, minn=2):
    """Literal re-expression of reveal.c:436-580 for differential testing."""
    n = len(SA)
    res = []

    def ismultimum(l, lb, ub):
        if l <= 0:
            return False
        seen = set()
        for j in range(lb, ub + 1):
            s = int(SO[SA[j]])
            if s in seen:
                return False
            seen.add(s)
        for j in range(lb, ub):
            if SA[j] == 0 or SA[j + 1] == 0:
                return True
            ta, tb = int(T[SA[j] - 1]), int(T[SA[j + 1] - 1])
            if (
                ta != tb
                or ta == N_BYTE
                or ta == SENTINEL
                or (ord("a") <= ta <= ord("z"))
            ):
                return True
        return False

    def emit(l, lb, ub):
        w = ub - lb + 1
        if l >= max(minl, 1) and minn <= w <= nsamples_main:
            if ismultimum(l, lb, ub):
                coords = tuple(
                    (int(SO[SA[j]]), int(SA[j])) for j in range(lb, ub + 1)
                )
                res.append((int(l), w, coords))

    stack = [(0, 0)]  # (lcp, lb)
    for i in range(1, n):
        lb = i - 1
        while LCP[i] < stack[-1][0]:
            l, ilb = stack.pop()
            emit(l, ilb, i - 1)
            lb = ilb
        if LCP[i] > stack[-1][0]:
            stack.append((int(LCP[i]), lb))
    while stack:
        l, ilb = stack.pop()
        emit(l, ilb, n - 1)
    return res
