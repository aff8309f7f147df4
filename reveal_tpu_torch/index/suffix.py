"""Suffix-array + LCP construction on the host.

The reference builds its generalized enhanced suffix array with libdivsufsort
(divsufsort/divsufsort.c:332-358) and a Kasai LCP pass that
stops at '$'/'N' (reveallib/interface.c:97-114).  This is the host part of
``reveal_tpu/index/suffix.py``: the native C++ SA-IS + capped Kasai route
of ``build_esa`` and the numpy prefix-doubling twins used as oracle.  The
device (prefix-doubling) constructions of the reference package are not
ported yet; asking for them raises.
"""

from __future__ import annotations

import numpy as np

from .. import _not_covered
from ..core.encoding import N_BYTE, SENTINEL


# --------------------------------------------------------------------------
# numpy reference/fallback implementations
# --------------------------------------------------------------------------

def suffix_array_np(T: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array (numpy). T: uint8[n] -> int64[n]."""
    n = len(T)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    rank = T.astype(np.int64)
    k = 1
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        key = (rank << 32) | (key2 + 1)
        sa = np.argsort(key, kind="stable")
        sk = key[sa]
        newrank = np.empty(n, dtype=np.int64)
        newrank[sa] = np.cumsum(np.r_[0, (sk[1:] != sk[:-1]).astype(np.int64)])
        rank = newrank
        if rank[sa[-1]] == n - 1:
            return sa.astype(np.int64)
        k *= 2


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


def lcp_from_sa_np(T: np.ndarray, SA: np.ndarray) -> np.ndarray:
    """LCP[i] = capped lcp(suffix SA[i-1], suffix SA[i]); LCP[0]=0.

    Kasai with '$'/'N' cap, matching interface.c:97-114.  Implemented as
    plain-lcp via rank doubling descent, then min() with the stop distance.
    """
    n = len(T)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    return _lcp_from_levels_np(T, SA, _rank_levels_np(T))


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


def sufcheck(T: np.ndarray, SA: np.ndarray) -> bool:
    """Validate that SA is the suffix array of T (like divsufsort's sufcheck,
    divsufsort/utils.c:161, but vectorized)."""
    n = len(T)
    if sorted(SA.tolist()) != list(range(n)):
        return False
    # adjacent order check using doubling ranks
    levels = _rank_levels_np(T)
    _, rank = levels[-1]
    return bool(np.all(rank[SA] == np.arange(n)))


def check_backend(backend: str) -> None:
    """Raise for the device suffix-array builds, which are not ported."""
    if backend == "jax":
        raise _not_covered("the device suffix-array build (backend 'jax')",
                           "4")
    if backend == "jax-dist":
        raise _not_covered("the distributed suffix-array build (backend "
                           "'jax-dist')", "9")


def build_esa(T_np: np.ndarray, backend: str = "auto"):
    """(SA, LCP, SAi) with backend in {'auto','native','np'}.

    Backends: 'native' = C++ SA-IS + capped Kasai (the host path the
    port's entry points use); 'np' = pure-numpy oracle.  'auto' means
    native.  The device routes ('jax', 'jax-dist') are not ported.
    """
    check_backend(backend)
    if backend == "auto":
        # "native", not native-then-numpy: a failed native build raises
        # instead of quietly switching to the numpy suffix sort
        backend = "native"
    if backend == "native":
        from ..native import build_esa_native

        return build_esa_native(T_np)
    if backend == "np":
        n = len(T_np)
        if n == 0:
            z = np.empty(0, np.int64)
            return z, z, z
        # single doubling pass: ranks feed both the SA and the LCP descent
        levels = _rank_levels_np(T_np)
        _, rank = levels[-1]
        sa = np.empty(n, dtype=np.int64)
        sa[rank] = np.arange(n)
        lcp = _lcp_from_levels_np(T_np, sa, levels)
        sai = rank.copy()
        return sa, lcp, sai
    raise ValueError("unknown backend %r" % backend)
