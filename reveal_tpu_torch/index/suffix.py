"""Suffix-array + LCP construction.

The reference builds its generalized enhanced suffix array with libdivsufsort
(divsufsort/divsufsort.c:332-358) and a Kasai LCP pass that
stops at '$'/'N' (reveallib/interface.c:97-114).  This is the port of
``reveal_tpu/index/suffix.py`` on one device: the native C++ SA-IS + capped
Kasai route of ``build_esa``, the numpy prefix-doubling twins used as
oracle, and the device doubling build (``build_esa_device``, backend
``'jax'``; the name is kept so that the reference's scripts and flags still
work) in torch on the device given.  Backend ``'jax-dist'`` and
``build_esa_sharded`` are the distributed build of ``parallel/dsa.py`` over
a mesh of ranks (a world of one unless the caller set up a process group).

A caller that names no device builds on the device of ``build_device``
(the CLI enters it with ``--device``), the card by default.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from ..core.encoding import N_BYTE, SENTINEL
from ..core.torchconfig import resolve_device

# the last device build's counters: n, npad, rounds (doubling rounds run),
# int64 (the 64-bit variant), rounds_seconds, lcp_seconds, copy_seconds
# (a synchronised host clock around each stage)
LAST_STATS = {}

# the device of a build whose caller names none (``build_device``)
_BUILD_DEVICE = ["cuda"]


@contextlib.contextmanager
def build_device(device):
    """Within the block, ``build_esa``'s device builds (``'jax'``,
    ``'jax-dist'``) whose caller passes no device run on ``device``: the
    CLI's ``--device`` for the subcommands that build an index through
    host code that names no device.  Outside any block it is the card."""
    prev = _BUILD_DEVICE[0]
    _BUILD_DEVICE[0] = device
    try:
        yield
    finally:
        _BUILD_DEVICE[0] = prev


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


# --------------------------------------------------------------------------
# the device doubling build
# --------------------------------------------------------------------------

def _num_levels(n: int) -> int:
    return max(1, int(math.ceil(math.log2(max(n, 2)))) + 1)


def _sort_pairs(rank, key2):
    """Stable sort of the slots by (rank, key2); returns (order as int64,
    sorted rank, sorted key2).  ``lax.sort`` with two keys is not stable,
    but slots that tie carry equal pairs, so the ranks derived from the
    order are the same, and the suffix array that is kept comes from a
    round whose pairs are all distinct."""
    if rank.dtype == torch.int32:
        # one packed int64 key: rank < 2^31 and key2 + 1 in [0, 2^31)
        key = (rank.to(torch.int64) << 32) | (key2 + 1).to(torch.int64)
        order = torch.sort(key, stable=True).indices
    else:
        # no room to pack two int64 keys: the minor key first, then the
        # major, both stable
        order = torch.sort(key2, stable=True).indices
        order = order[torch.sort(rank[order], stable=True).indices]
    return order, rank[order], key2[order]


def _doubling_rounds(rank0):
    """``_make_build_body``'s rounds of ``lax.scan`` (suffix.py:160-187):
    sort the slots by (rank, rank[i+k] or -1), re-rank densely, until the
    last rank is npad - 1.  Returns (sa, ranks) with ``ranks[lev]`` the
    ranks of the substrings of length 2^lev.  The JAX scan runs all
    nlev - 1 rounds and stores the frozen ranks of the rounds after the
    last; they are left out here (one host read a round): at a frozen
    level every rank is distinct, so the LCP descent advances no pair
    there."""
    npad = rank0.shape[0]
    sa = torch.sort(rank0, stable=True).indices
    ranks = [rank0]
    if int(rank0[sa[-1]]) == npad - 1:
        return sa, ranks
    rank = rank0
    for lev in range(_num_levels(npad) - 1):
        k = 1 << lev
        key2 = torch.cat([rank[k:], rank.new_full((k,), -1)])
        sa, sk1, sk2 = _sort_pairs(rank, key2)
        diff = (sk1[1:] != sk1[:-1]) | (sk2[1:] != sk2[:-1])
        dense = torch.cat([rank.new_zeros(1),
                           torch.cumsum(diff, 0, dtype=rank.dtype)])
        rank = torch.empty_like(rank).scatter_(0, sa, dense)
        ranks.append(rank)
        if int(dense[-1]) == npad - 1:
            break
    return sa, ranks


def _lcp_descent(T, sa, ranks):
    """LCP of SA-adjacent suffixes by descent over the rank levels, from
    the top one down (at level k, pairs whose k-prefixes agree advance by
    k), capped by the distance to the next '$' or 'N' (suffix.py:189-221)."""
    npad = sa.shape[0]
    idt = ranks[0].dtype
    a = sa[:-1].to(idt)
    b = sa[1:].to(idt)
    h = torch.zeros(npad - 1, dtype=idt, device=sa.device)
    for lev in range(len(ranks) - 1, -1, -1):
        k = 1 << lev
        rk = ranks[lev]
        ok = (a + k <= npad) & (b + k <= npad)
        eq = ok & (torch.index_select(rk, 0, a.clamp(max=npad - 1))
                   == torch.index_select(rk, 0, b.clamp(max=npad - 1)))
        step = eq.to(idt) * k
        h = h + step
        a = a + step
        b = b + step
    iar = torch.arange(npad, dtype=idt, device=sa.device)
    stop = torch.where((T == SENTINEL) | (T == N_BYTE), iar, npad)
    d = torch.cummin(stop.flip(0), 0).values.flip(0) - iar
    lcp = torch.minimum(h, torch.minimum(d[sa[:-1]], d[sa[1:]]))
    lcp = torch.cat([lcp.new_zeros(1), lcp])
    sai = torch.empty_like(iar).scatter_(0, sa, iar)
    return lcp, sai


def build_esa_device(T_np: np.ndarray, device, force64: bool = False):
    """Device construction of (SA, LCP, SAi) for uint8 text, as numpy
    int64: the counterpart of ``reveal_tpu``'s ``build_esa_jax``
    (suffix.py:327-382, with ``_make_build_body``), in torch on
    ``device`` (a ``torch.device``).

    The text is padded with 0x00 to npad = 2^ceil(log2 n); zero sorts
    below every real byte, so the npad - n pad suffixes sort first and
    are stripped.  Ranks are int32 below npad = 2^31, int64 from there
    or with ``force64`` (the device twin of the reference's reveallib64
    build, setup.py:21-31)."""
    n = int(len(T_np))
    if n == 0:
        z = np.empty(0, np.int64)
        return z, z, z
    dev = torch.device(device)
    npad = 1 << max(1, int(math.ceil(math.log2(n))))
    idt = torch.int64 if force64 or npad >= 2**31 else torch.int32
    T_padded = np.zeros(npad, dtype=np.uint8)
    T_padded[:n] = T_np
    t0 = time.perf_counter()
    T = torch.from_numpy(T_padded).to(dev)
    sa, ranks = _doubling_rounds(T.to(idt))
    t1 = time.perf_counter()
    rounds = len(ranks) - 1
    lcp, sai = _lcp_descent(T, sa, ranks)
    del ranks
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    sa, lcp, sai = (x.to(torch.int64).cpu().numpy() for x in (sa, lcp, sai))
    t3 = time.perf_counter()
    LAST_STATS.clear()
    LAST_STATS.update(n=n, npad=npad, rounds=rounds,
                      int64=idt == torch.int64, rounds_seconds=t1 - t0,
                      lcp_seconds=t2 - t1, copy_seconds=t3 - t2)
    # strip the zero-padding: all npad-n pad suffixes sort first
    off = npad - n
    if off:
        sa = sa[off:]
        lcp = lcp[off:].copy()
        lcp[0] = 0
        sai = sai[:n] - off
    return sa, lcp, sai


def build_esa_sharded(T_np: np.ndarray, mesh, force64: bool = False):
    """(SA, LCP, SAi) built over ``mesh``'s ranks: the counterpart of
    ``reveal_tpu``'s GSPMD build (suffix.py:276-325).  Torch has no
    partitioner, so it is the distributed build of ``parallel/dsa.py``,
    whose arrays are the same."""
    from ..parallel.dsa import build_esa_distributed

    return build_esa_distributed(T_np, mesh, force64=force64)


def build_esa(T_np: np.ndarray, backend: str = "auto", device=None):
    """(SA, LCP, SAi) with backend in {'auto','native','jax','jax-dist','np'}.

    Backends: 'native' = C++ SA-IS + capped Kasai (the host path the
    port's entry points use); 'jax' = the device doubling build
    (``build_esa_device``) on ``device``; 'jax-dist' = the distributed
    build over ``make_mesh(device=device)``'s ranks (a world of one
    unless the caller set up a process group; parallel/dsa.py); 'np' =
    pure-numpy oracle.  'auto' means native.  The device builds run on
    ``device``, or ``build_device``'s when the caller names none: the
    card unless the CPU is named.
    """
    device = device or _BUILD_DEVICE[0]
    if backend == "jax-dist":
        import os

        from ..parallel.dsa import build_esa_distributed
        from ..parallel.mesh import make_mesh

        # low-HBM LCP descent knob (int or "sqrt"): regenerate rank
        # levels from sparse checkpoints instead of storing all of them
        stride = os.environ.get("REVEAL_TPU_DSA_LCP_STRIDE") or None
        if stride is not None and stride != "sqrt":
            stride = int(stride)
        return build_esa_distributed(
            T_np, make_mesh(device=device), lcp_ckpt_stride=stride
        )
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
    if backend == "jax":
        return build_esa_device(T_np, resolve_device(device))
    raise ValueError("unknown backend %r" % backend)
