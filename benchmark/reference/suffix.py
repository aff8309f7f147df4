"""Suffix array and LCP of the text, by prefix doubling in NumPy.

The ``'np'`` build of the port's ``index/suffix.py``: the rank levels of
the doubling rounds give the suffix array, and a descent through the same
levels gives each adjacent pair's common prefix, capped at the first
``'$'`` or ``'N'`` (REVEAL's Kasai pass, reveallib/interface.c:97-114).
"""

from __future__ import annotations

import numpy as np

from .encoding import N_BYTE, SENTINEL


def _rank_levels_np(T: np.ndarray):
    """All doubling rank arrays [(k, rank_k)], for LCP descent."""
    n = len(T)
    levels = []
    # dense single-char ranks (preserves equality & order; makes the
    # "all-distinct" check valid even when no doubling round runs)
    sa0 = np.argsort(T, kind="stable")
    sk = T[sa0].astype(np.int64)
    rank = np.empty(n, dtype=np.int64)
    rank[sa0] = np.cumsum(np.r_[0, (sk[1:] != sk[:-1]).astype(np.int64)])
    levels.append((1, rank))
    k = 1
    while k < n:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        key = (rank << 32) | (key2 + 1)
        sa = np.argsort(key, kind="stable")
        sk = key[sa]
        newrank = np.empty(n, dtype=np.int64)
        newrank[sa] = np.cumsum(np.r_[0, (sk[1:] != sk[:-1]).astype(np.int64)])
        rank = newrank
        k *= 2
        levels.append((k, rank))
        if rank[sa[-1]] == n - 1:
            break
    return levels


def _stop_distance_np(T: np.ndarray) -> np.ndarray:
    """d[i] = distance from i to the first '$' or 'N' at or after i."""
    n = len(T)
    idx = np.where((T == SENTINEL) | (T == N_BYTE), np.arange(n), n)
    # suffix-min
    sufmin = np.minimum.accumulate(idx[::-1])[::-1]
    return sufmin - np.arange(n)


def _lcp_from_levels_np(T, SA, levels) -> np.ndarray:
    n = len(T)
    a = SA[:-1].copy()
    b = SA[1:].copy()
    h = np.zeros(n - 1, dtype=np.int64)
    for k, rank in reversed(levels):
        ok = (a + k <= n) & (b + k <= n)
        # guard gathers
        ai = np.minimum(a, n - 1)
        bi = np.minimum(b, n - 1)
        eq = ok & (rank[ai] == rank[bi])
        h = np.where(eq, h + k, h)
        a = np.where(eq, a + k, a)
        b = np.where(eq, b + k, b)
    d = _stop_distance_np(T)
    plain = h
    lcp = np.minimum(plain, np.minimum(d[SA[:-1]], d[SA[1:]]))
    return np.r_[0, lcp].astype(np.int64)


def build_esa(T_np: np.ndarray):
    """(SA, LCP, SAi) of ``T_np``: one doubling pass whose rank levels feed
    both the suffix array and the LCP descent."""
    n = len(T_np)
    if n == 0:
        z = np.empty(0, np.int64)
        return z, z, z
    levels = _rank_levels_np(T_np)
    _, rank = levels[-1]
    sa = np.empty(n, dtype=np.int64)
    sa[rank] = np.arange(n)
    lcp = _lcp_from_levels_np(T_np, sa, levels)
    sai = rank.copy()
    return sa, lcp, sai
