"""Deferred-forest level kernel of the pairwise recursion, in torch.

Port of ``reveal_tpu/index/devloop.py``: ``_build_kernel(...,
chain_width=CW)`` (the dense-chain forest form) and
``rem_device_forest``.  The residual recursion below the native host
prefix runs level by level on the device.  Each level enumerates MUM
candidates, trims them, runs the dense chain DP with the ``largest``
pick, logs anchors, classifies/splits/lowercases, applies the stable
partition and does the boundary repair: on the card one launch of the
CUDA kernel of ``index/repair.py`` a pass, on the CPU the JAX kernel's
batched repair rounds (``repair_rounds_plain``).

Every stage is a module-level function on int32 tensors; all outputs
are bit-identical to the JAX kernel's.  The JAX ``while_loop``s and
``lax.cond``s become Python control flow on values read to the host (one
host sync per loop test), each read counted by a ``HostReads``
(``LAST_STATS["host_syncs"]``).  A level's stages are the spans
``level.enumerate``, ``level.trim``, ``level.chain``, ``level.split``
and ``level.repair`` (``core/trace.py``).  Scatters that the JAX code
makes with ``mode="drop"`` write through a buffer with one spill slot per
element, so every scatter stays unique-indexed, and gathers whose JAX
index could leave the array are clamped as JAX clamps them.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import trace
from ..core.encoding import N_BYTE, SENTINEL
from ..core.torchconfig import INDEX_DTYPE
from . import repair
from .window_resolve import window_resolve_plain

log = logging.getLogger(__name__)

I32 = INDEX_DTYPE
NEG = -(2**31) + 1
BIG = 2**31 - 1
A30 = 2**30

# abort codes
ABORT_CAND_OVERFLOW = 1     # more candidates than K in one level
ABORT_SEG_OVERFLOW = 2      # more live children than SMAX
ABORT_ANCHOR_OVERFLOW = 3   # anchor log full
ABORT_DUP_REF = 4           # duplicate ref starts in one segment's chain
ABORT_LEVEL_OVERFLOW = 5    # runaway level count
ABORT_REPAIR_OVERFLOW = 6   # more repair candidates than CCAP in a pass
ABORT_MAXMUMS = 7           # a segment exceeded maxmums candidates
ABORT_CHAIN_ROUNDS = 8      # chain wavefront exceeded the round cap
ABORT_REPAIR_WINDOW = 9     # a repair insertion point escaped the window
ABORT_SEG_WIDTH = 10        # a segment exceeded the dense chain width CW

_LMAX = 512
_RMAX = 384     # chain wavefront rounds per level
_WREP = 4096    # repair window lookback (insertion point must be inside)
_WRV = 256      # vectorized repair resolve window: the insertion-point
                # search looks back this many slots per candidate (p90
                # lookback is a few hundred on real genomes);
                # window-miss movers fall back to the exact sequential
                # resolve (full WREP window + whole-array deep scan)

# capacity aborts that a re-dispatch with a doubled capacity can fix
_RETRYABLE = {
    ABORT_CAND_OVERFLOW: "K",
    ABORT_SEG_OVERFLOW: "SMAX",
    ABORT_ANCHOR_OVERFLOW: "ACAP",
    ABORT_REPAIR_OVERFLOW: "CCAP",
    ABORT_SEG_WIDTH: "CW",
}

# stats of the most recent rem_device_forest call, with the keys of the
# JAX package's LAST_STATS.  repair_steps counts the last dispatch's
# batched repair rounds on the CPU and its repair launches (one a pass)
# on the card; repair_rounds_total sums repair_steps over every dispatch,
# capacity retries included; repair_launches counts the repair kernel's
# launches of every dispatch (0 on the CPU).  repair_applied,
# repair_chain_max and repair_moved_slots are the repair counters of the
# last dispatch: candidates applied, the longest run of one segment's
# candidates in one pass, and the sum of q - x over the movers.
# host_syncs counts the level loop's reads to the host over every
# dispatch (the CPU's batched repair rounds not included).
LAST_STATS = {}


def _next_pow2(x: int) -> int:
    return 1 << max(1, int(math.ceil(math.log2(max(x, 2)))))


def forest_pop_order(parents: np.ndarray, cls: np.ndarray):
    """Per-root serial pop order for the deferred-forest kernel.

    Root anchors carry parent = -2 - defer_id (see rem_device_forest);
    returns {defer_id: index array} where each array is that subtree's
    anchors in serial LIFO pop order (pre-order walk, trailing subtree
    first — reveal.c:21-27,1295-1324)."""
    A = len(parents)
    lead = np.full(A, -1, np.int64)
    trail = np.full(A, -1, np.int64)
    roots = {}
    for i in range(A):
        p, c = int(parents[i]), int(cls[i])
        if p < -1:
            roots[-2 - p] = i
        elif c == 1:
            lead[p] = i
        else:
            trail[p] = i
    out = {}
    for did, root in roots.items():
        order = []
        stack = [root]
        while stack:
            t = stack.pop()
            order.append(t)
            if lead[t] >= 0:
                stack.append(int(lead[t]))
            if trail[t] >= 0:
                stack.append(int(trail[t]))
        out[did] = np.asarray(order, np.int64)
    return out


# ----------------------------------------------------------------------
# scan and sort helpers (devloop.py:242-282)
# ----------------------------------------------------------------------
def associative_scan(combine, elems):
    """Inclusive scan along dim 0 of a tuple of equal-shape tensors of
    one dtype.

    The recursion is ``jax.lax.associative_scan``'s (combine adjacent
    pairs, scan the halves, fill in the even positions), so each output
    is combined in the same order as in JAX.  That makes it bit-exact
    even for trim's clamped-subtract combine, whose int32 sums can wrap
    and is then not strictly associative.  The tensors travel stacked
    along dim 1 of one tensor, so a level moves them all at once."""
    return _scan_columns(combine, torch.stack(tuple(elems), 1)).unbind(1)


def _scan_columns(combine, E):
    n = E.shape[0]
    if n < 2:
        return E

    def comb(a, b):
        return torch.stack(combine(a.unbind(1), b.unbind(1)), 1)

    odd = _scan_columns(combine, comb(E[0:-1:2], E[1::2]))
    even = comb(odd[:-1] if n % 2 == 0 else odd, E[2::2])
    r = torch.empty_like(E)
    r[0] = E[0]
    r[2::2] = even
    r[1::2] = odd
    return r


def seg_min_scan(values, reset):
    """Running minimum along dim 0 restarted where ``reset`` is set
    (``values`` 1-D, or 2-D for several columns at once)."""
    def combine(x, y):
        (m1, f1), (m2, f2) = x, y
        return torch.where(f2 > 0, m2, torch.minimum(m1, m2)), f1 | f2

    return associative_scan(combine, (values, reset.to(values.dtype)))[0]


def seg_max_scan(values, reset):
    """Running maximum along dim 0 restarted where ``reset`` is set."""
    def combine(x, y):
        (m1, f1), (m2, f2) = x, y
        return torch.where(f2 > 0, m2, torch.maximum(m1, m2)), f1 | f2

    return associative_scan(combine, (values, reset.to(values.dtype)))[0]


def last_value_scan(values, flags):
    """Per row along dim 0: the value of the last row at or before it
    whose flag is set, else of row 0 (the JAX code's associative scan of
    a selection, which is exact in any order): one cumulative maximum of
    the flagged rows' indices.  Only for candidate-sized arrays: torch's
    cummax runs a long 1-D array in one block."""
    n = values.shape[0]
    idx = torch.where(flags, torch.arange(n, device=values.device), 0)
    return values[torch.cummax(idx, 0).values]


def sort_by(keys, vals):
    """Lexicographic sort of ``vals`` by ``keys`` (most significant
    first) as successive stable sorts.  Callers end ``keys`` with an
    arrival index, so the order is total, as in ``lax.sort``."""
    perm = None
    for k in reversed(tuple(keys)):
        kk = k if perm is None else k[perm]
        idx = torch.sort(kk, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return tuple(v[perm] for v in vals)


def shift1(x, fill):
    """x shifted right by one, ``fill`` entering at the front."""
    return torch.cat([x.new_full((1,), fill), x[:-1]])


def shift_left(x, fill):
    """x shifted left by one, ``fill`` entering at the back."""
    return torch.cat([x[1:], x.new_full((1,), fill)])


def cumsum32(x):
    return torch.cumsum(x, 0, dtype=I32)


def arange32(n, device):
    return torch.arange(n, dtype=I32, device=device)


def take(x, idx):
    """x[idx] along dim 0 (indices already in range)."""
    return torch.index_select(x, 0, idx)


def scatter_drop(x, idx, vals):
    """Copy of ``x`` with ``x[idx] = vals``, indices outside [0, len)
    dropped (JAX ``.at[idx].set(vals, mode="drop")`` for indices that
    are unique where they are in range)."""
    n = x.shape[0]
    m = idx.shape[0]
    keep = (idx >= 0) & (idx < n)
    spill = n + torch.arange(m, dtype=idx.dtype, device=idx.device)
    buf = torch.cat([x, x.new_zeros((m,) + tuple(x.shape[1:]))])
    if not torch.is_tensor(vals):
        vals = torch.full((m,), vals, dtype=x.dtype, device=x.device)
    buf.index_copy_(0, torch.where(keep, idx, spill).long(), vals)
    return buf[:n]


def compact(mask, size, fill):
    """First ``size`` positions where ``mask`` is set, padded with
    ``fill`` (``jnp.nonzero(mask, size=size, fill_value=fill)``)."""
    n = mask.shape[0]
    iar = arange32(n, mask.device)
    rank = cumsum32(mask) - 1
    idx = torch.where(mask & (rank < size), rank, size + iar)
    out = torch.full((size + n,), fill, dtype=I32, device=mask.device)
    out.index_copy_(0, idx.long(), iar)
    return out[:size]


def dynamic_slice(x, start: int, size: int):
    """``lax.dynamic_slice``: the start is clamped so the slice fits."""
    s = min(max(start, 0), x.shape[0] - size)
    return x[s:s + size]


# ----------------------------------------------------------------------
# enumerate (devloop.py:991-1049)
# ----------------------------------------------------------------------
def enumerate_candidates(SA, LCP, BWT, SEG, nsep0, minl, maxmums, K,
                         SMAX, abort):
    """The getmums_rem conditions over adjacent slots of every live
    segment, compacted to K candidate rows (seg, l, a, b); dead rows
    have seg == BIG."""
    npad = SA.shape[0]
    dev = SA.device
    iar_n = arange32(npad, dev)
    prev = torch.roll(SA, 1)
    seg_prev = torch.roll(SEG, 1)
    lv = LCP
    straddle = (SA > nsep0) != (prev > nsep0)
    a_ = torch.minimum(SA, prev)
    b_ = torch.maximum(SA, prev)
    unique = (torch.roll(LCP, 1) < lv) & (shift_left(LCP, 0) < lv)
    bwtp = torch.roll(BWT, 1)
    cur_is_a = SA < prev
    ta = torch.where(cur_is_a, BWT, bwtp)
    tb = torch.where(cur_is_a, bwtp, BWT)
    lower = (ta >= ord("a")) & (ta <= ord("z"))
    leftmax = (
        (a_ == 0) | (b_ == 0) | (ta != tb)
        | (ta == N_BYTE) | (ta == SENTINEL) | lower
    )
    mask = (
        (iar_n >= 1) & (SEG >= 0) & (SEG == seg_prev)
        & (lv >= minl) & (lv > 0) & straddle & leftmax & unique
    )
    ccount = mask.sum(dtype=I32)
    abort = torch.where(ccount > K, ABORT_CAND_OVERFLOW, abort)
    slots = compact(mask, K, npad - 1)
    valid = arange32(K, dev) < ccount.clamp(max=K)
    cseg = torch.where(valid, take(SEG, slots), BIG)
    cl = torch.where(valid, take(lv, slots), 0)
    caa = torch.where(valid, take(a_, slots), 0)
    cbb = torch.where(valid, take(b_, slots), 0)
    # maxmums: the host keeps the largest `maxmums` after trim; rare,
    # so abort to the host engine instead of replicating it
    percnt = torch.zeros(SMAX, dtype=I32, device=dev).index_add_(
        0, cseg.clamp(0, SMAX - 1), (cseg < BIG).to(I32)
    )
    abort = torch.where(percnt.max() > maxmums, ABORT_MAXMUMS, abort)
    return cseg, cl, caa, cbb, abort


# ----------------------------------------------------------------------
# trim_overlap, one dimension (devloop.py:283-389)
# ----------------------------------------------------------------------
def trim_dim(seg, l, a, b, coord):
    """Containment drop + overlap trim along coordinate ``coord`` (0: a,
    1: b) as three associative scans.  Rows are K-wide; dead rows have
    seg == BIG.  Returns (seg, l, a, b, n_alive)."""
    K = seg.shape[0]
    iar = arange32(K, seg.device)
    pos = a if coord == 0 else b
    # stable sort by (seg, pos, -l): the arrival index keeps python's
    # list.sort stability on key ties
    seg, l, a, b = sort_by(
        (seg, torch.where(seg < BIG, pos, BIG), -l, iar), (seg, l, a, b)
    )
    pos = a if coord == 0 else b
    alive = seg < BIG
    end = torch.where(alive, pos + l, BIG)
    first = seg != shift1(seg, -9)
    last = seg != shift_left(seg, -9)
    end_prev = shift1(end, 0)
    end_next = shift_left(end, 0)
    # per-segment last end (python's mums[-1] wraparound)
    last_end_rev = last_value_scan(
        torch.flip(torch.where(last, end, 0), (0,)), torch.flip(last, (0,))
    )
    seg_last_end = torch.flip(last_end_rev, (0,))
    keep_first = (~last & (end_next > end)) | (seg_last_end < end)
    keep = alive & torch.where(first, keep_first | last, end_prev < end)
    seg = torch.where(keep, seg, BIG)
    # compact kept rows to the front, preserving order
    seg, l, a, b = sort_by((seg, iar), (seg, l, a, b))
    pos = a if coord == 0 else b
    alive = seg < BIG
    n_alive = alive.sum(dtype=I32)
    first = (seg != shift1(seg, -9)) & alive

    # scan 1: incoming cur_end, a 2-piece step function per row
    pl = pos + l
    T0 = torch.where(first | ~alive, -1, pl)
    Av = torch.where(alive, pl, 0)
    Bv = torch.where(first, pl, torch.where(alive, pos, 0))

    def comb_step(x, y):
        (t1, a1, b1), (t2, a2, b2) = x, y
        return (
            t1,
            torch.where(a1 >= t2, b2, a2),
            torch.where(b1 >= t2, b2, a2),
        )

    Tc, Ac, Bc = associative_scan(
        comb_step, (shift1(T0, -1), shift1(Av, 0), shift1(Bv, 0))
    )
    ce_in = torch.where(Tc <= 0, Bc, Ac)
    ov = torch.where(first, 0, ce_in - pos)
    hit = alive & ~first & (ov > 0)
    ovh = torch.where(hit, ov, 0)
    li = l - ovh
    front = torch.where(hit, ovh, 0)

    # scan 2: incoming cur_len, clamped-subtract maps max(cl - a, b)
    deep = hit & (li <= 0)
    a_r = torch.where(deep, ovh, A30)
    b_r = torch.where(
        alive, torch.where(deep, 0, torch.where(hit, li, l)), 0
    )

    def comb_cl(x, y):
        (a1, b1), (a2, b2) = x, y
        return (a1 + a2).clamp(max=A30), torch.maximum(b1 - a2, b2)

    ac, bc = associative_scan(comb_cl, (shift1(a_r, A30), shift1(b_r, 0)))
    cl_in = torch.maximum(-ac, bc)
    prev_alive = (cl_in - ovh) > 0

    # scan 3: incoming cur_idx (last reset value); K is a scratch row
    reset = (~deep) | (deep & ~prev_alive)
    rval = torch.where(~deep, iar, K)
    ci_in = last_value_scan(shift1(rval, K), shift1(reset, True))
    back = torch.zeros(K + 1, dtype=I32, device=seg.device).index_add_(
        0, torch.where(hit, ci_in, K), ovh
    )[:K]
    newl = l - front - back
    ok = (seg < BIG) & (newl > 0)
    seg = torch.where(ok, seg, BIG)
    return seg, newl, a + front, b + front, n_alive


# ----------------------------------------------------------------------
# chain + pick, dense (SMAX, CW+1) formulation (devloop.py:716-952)
# ----------------------------------------------------------------------
def chain_dense(cseg, cl, caa, cbb, seg_tab, seg_live, abort, ws, wp, CW,
                reads=None):
    """Sparse chaining DP (schemes.py:20-104) and the ``largest`` pick
    for every live segment at once, its host reads counted in ``reads``
    (a ``HostReads``).  Returns (picked, s_l, s_ma, s_mb, abort, rounds)
    with rounds = column steps of the score pass."""
    reads = HostReads() if reads is None else reads
    K = cseg.shape[0]
    SMAX = seg_tab.shape[0]
    dev = cseg.device
    CW1 = CW + 1          # + pseudo column (always last)
    iar = arange32(K, dev)
    cols = arange32(CW1, dev)

    # stable (seg, a) order; per-segment rank
    cseg, cl, caa, cbb = sort_by(
        (cseg, torch.where(cseg < BIG, caa, BIG), iar), (cseg, cl, caa, cbb)
    )
    alive = cseg < BIG
    dup = (cseg[1:] == cseg[:-1]) & (caa[1:] == caa[:-1]) & (cseg[1:] < BIG)
    abort = torch.where(dup.any(), ABORT_DUP_REF, abort)
    first = (cseg != shift1(cseg, -9)) & alive
    firstpos = last_value_scan(torch.where(first, iar, 0), first)
    rank = torch.where(alive, iar - firstpos, 0)
    abort = torch.where((alive & (rank >= CW)).any(), ABORT_SEG_WIDTH, abort)
    csc = cseg.clamp(0, SMAX - 1)
    # dead rows get their own spill slots, so the scatter stays
    # unique-indexed (alive rows collide only under ABORT_SEG_WIDTH,
    # whose results are discarded)
    didx = torch.where(
        alive, csc * CW1 + rank.clamp(max=CW - 1), SMAX * CW1 + iar
    ).long()

    def scat(v):
        buf = torch.zeros(SMAX * CW1 + K, dtype=I32, device=dev)
        buf.index_copy_(0, didx, v)
        return buf[: SMAX * CW1].reshape(SMAX, CW1)

    dA = scat(caa)
    dB = scat(cbb)
    dL = scat(cl)
    dal = scat(alive.to(I32))
    dA[:, CW] = seg_tab[:, 1]
    dB[:, CW] = seg_tab[:, 3]
    dal[:, CW] = seg_live.to(I32)
    dalb = dal > 0
    dEA = dA + dL
    dEB = dB + dL
    dU = dEA - dEB
    dV = dA - dB
    dmul = ws * dL
    ddl = (dA - (seg_tab[:, 0] - 1)[:, None]) - (
        dB - (seg_tab[:, 2] - 1)[:, None]
    )
    dwl = torch.where(dalb, dmul - wp * torch.abs(ddl), NEG)
    candb = dalb & (cols[None, :] < CW)
    candcnt = candb.sum(dim=1, dtype=I32)

    # act: min dominating column (the geometric activation step; the
    # pseudo always dominates, so act <= CW for live columns)
    CB = 16
    act_parts = []
    for c0 in range(0, CW1, CB):
        ce = min(c0 + CB, CW1)
        dom = (
            (dA[:, None, :] >= dEA[:, c0:ce, None])
            & (dB[:, None, :] >= dEB[:, c0:ce, None])
            & dalb[:, None, :]
        )
        act_parts.append(
            torch.where(dom, cols[None, None, :], BIG).amin(dim=2)
        )
    dact = torch.cat(act_parts, dim=1)

    # scores: sequential pass over candidate columns up to the widest
    # live segment
    maxcnt = reads(torch.where(seg_live, candcnt, 0).max())
    score = torch.full((SMAX, CW1), NEG, dtype=I32, device=dev)
    j = 0
    while j < maxcnt:
        a_j, b_j, l_j = dA[:, j], dB[:, j], dL[:, j]
        v_j = a_j - b_j
        compat = (
            dalb
            & (dEA <= a_j[:, None])
            & (dEB <= b_j[:, None])
            & (cols[None, :] < j)
        )
        tw = torch.where(
            compat, score - wp * torch.abs(v_j[:, None] - dU), NEG
        )
        mx = tw.amax(dim=1)
        sc_new = torch.maximum(
            dwl[:, j], torch.where(mx > NEG // 2, mx + ws * l_j, NEG)
        )
        score[:, j] = torch.where(dalb[:, j], sc_new, NEG)
        j += 1
    rounds = j

    # links: exact winner reconstruction, lex key (tmpw, score_j,
    # -act_j, -col_j); the left pseudo wins per the reference's
    # traversal order (schemes.py:64-87)
    link_parts = []
    for c0 in range(0, CW1, CB):
        ce = min(c0 + CB, CW1)
        compat = (
            dalb[:, None, :]
            & (dEA[:, None, :] <= dA[:, c0:ce, None])
            & (dEB[:, None, :] <= dB[:, c0:ce, None])
            & (cols[None, None, :] < cols[None, c0:ce, None])
        )
        tw = torch.where(
            compat,
            score[:, None, :]
            - wp * torch.abs(dV[:, c0:ce, None] - dU[:, None, :]),
            NEG,
        )
        mx = tw.amax(dim=2)
        t1 = tw == mx[:, :, None]
        sc2 = torch.where(t1, score[:, None, :], NEG)
        mx2 = sc2.amax(dim=2)
        t2 = t1 & (sc2 == mx2[:, :, None])
        a3 = torch.where(t2, dact[:, None, :], BIG)
        amn = a3.amin(dim=2)
        t3 = t2 & (a3 == amn[:, :, None])
        brow = torch.argmax(t3.to(torch.uint8), dim=2).to(I32)
        has = mx > NEG
        wl_b = dwl[:, c0:ce]
        mxg = mx + dmul[:, c0:ce]
        use_left = (~has) | (wl_b > mxg) | ((wl_b == mxg) & (mx2 <= 0))
        link_parts.append(torch.where(use_left, -1, brow))
    dlink = torch.where(dalb, torch.cat(link_parts, dim=1), -2)

    # backtrack + largest (schemes.py:298-301): pointer doubling along
    # link chains, sentinel column CW1
    def pad(x, fill):
        return torch.cat(
            [x, torch.full((SMAX, 1), fill, dtype=I32, device=dev)], dim=1
        )

    def gsel(x, idx):  # y[s, i] = x[s, idx[s, i]]
        return torch.gather(x, 1, idx.long())

    nxt = pad(torch.where(dlink >= 0, dlink, CW1), CW1)
    bl = pad(torch.where(candb, dL, -1), -1)
    bs = pad(cols[None, :].expand(SMAX, CW1), -1)
    while reads((nxt[:, :CW1] != CW1).any()):
        bl2 = gsel(bl, nxt)
        bs2 = gsel(bs, nxt)
        take_far = bl2 > bl
        bl = torch.where(take_far, bl2, bl)
        bs = torch.where(take_far, bs2, bs)
        nxt = gsel(nxt, nxt)
    ptr0 = torch.where(seg_live, dlink[:, CW], -1)
    ptr0c = ptr0.clamp(0, CW1)[:, None]
    blp = torch.where(ptr0 >= 0, gsel(bl, ptr0c)[:, 0], -1)
    bs_seg = torch.where(
        (ptr0 >= 0) & (blp > -1), gsel(bs, ptr0c)[:, 0], -1
    )
    # single-candidate segments bypass the chain entirely (picker
    # __call__: len(relmums) == 1); the candidate is rank 0
    bs_seg = torch.where(seg_live & (candcnt == 1), 0, bs_seg)
    picked = seg_live & (bs_seg >= 0)
    bsc = bs_seg.clamp(0, CW1 - 1)[:, None]
    s_l = torch.where(picked, gsel(dL, bsc)[:, 0], 0)
    s_ma = torch.where(picked, gsel(dA, bsc)[:, 0], 0)
    s_mb = torch.where(picked, gsel(dB, bsc)[:, 0], 0)
    return picked, s_l, s_ma, s_mb, abort, rounds


# ----------------------------------------------------------------------
# chain + pick, flat M-row formulation (devloop.py:390-705)
# ----------------------------------------------------------------------
def _comb_aff(x, y):
    """The wavefront's value scan in phi space: maps f(m) = max(m + p,
    q), composed left to right, a set ``r`` starting a run afresh."""
    (p1, q1, r1), (p2, q2, r2) = x, y
    keep = r2 == 0
    return (
        torch.where(keep, (p1 + p2).clamp(max=A30), p2),
        torch.where(keep, torch.maximum(q1 + p2, q2), q2),
        r1 | r2,
    )


def chain_flat(cseg, cl, caa, cbb, seg_tab, seg_live, abort, ws, wp,
               reads=None):
    """Sparse chaining DP (schemes.py:20-104) and the ``largest`` pick of
    every live segment at once, over one flat list of M = K + SMAX rows
    (the candidates and one right pseudo-row a live segment, sorted by
    (segment, a)): the single-root path, where a segment may hold
    thousands of candidates.  Returns (picked, s_l, s_ma, s_mb, abort,
    rounds) as ``chain_dense`` does, with rounds = the wavefront rounds of
    the score pass; past ``_RMAX`` rounds the level aborts with
    ``ABORT_CHAIN_ROUNDS``.

    Scores are computed values first by wavefront rounds: a row commits
    once no compatible predecessor outside its run is pending, and a run
    (consecutively chainable rows) commits its prefix through one scan of
    affine maps.  The JAX kernel's candidate x candidate passes take
    chunks of CH rows against all M columns; here a chunk meets only the
    rows of its own segments (every pass masks other segments and dead
    rows out, and rows are sorted by segment), read once a level with
    one host read, and its masks and gap penalties are built once a level
    instead of once a round.  Results are the JAX kernel's bit for bit.
    One host read a round tests the loop; every read is counted in
    ``reads`` (a ``HostReads``)."""
    reads = HostReads() if reads is None else reads
    K = cseg.shape[0]
    SMAX = seg_tab.shape[0]
    M = K + SMAX
    CH = 2048 if M % 2048 == 0 else 1024
    dev = cseg.device
    iar_m = arange32(M, dev)
    gseg = torch.cat([cseg, torch.where(seg_live, arange32(SMAX, dev), BIG)])
    gl = torch.cat([cl, torch.zeros(SMAX, dtype=I32, device=dev)])
    ga = torch.cat([caa, torch.where(seg_live, seg_tab[:, 1], 0)])
    gb = torch.cat([cbb, torch.where(seg_live, seg_tab[:, 3], 0)])
    gpseudo = torch.cat([torch.zeros(K, dtype=I32, device=dev),
                         torch.ones(SMAX, dtype=I32, device=dev)])
    gseg, gl, ga, gb, gpseudo = sort_by(
        (gseg, torch.where(gseg < BIG, ga, BIG), iar_m),
        (gseg, gl, ga, gb, gpseudo),
    )
    galive = gseg < BIG
    cand = galive & (gpseudo == 0)
    # duplicate ref starts within a segment: the host resolves them
    # through its dict-aliasing path; abort instead
    dup = (
        (gseg[1:] == gseg[:-1]) & (ga[1:] == ga[:-1]) & (gseg[1:] < BIG)
        & (gpseudo[1:] == 0) & (gpseudo[:-1] == 0)
    )
    abort = torch.where(dup.any(), ABORT_DUP_REF, abort)
    gea = ga + gl
    geb = gb + gl
    gu = gea - geb
    gv = ga - gb
    gsc = gseg.clamp(0, SMAX - 1)
    # left pseudo in text coordinates (gap costs are shift-invariant)
    gla = take(seg_tab[:, 0], gsc) - 1
    glb = take(seg_tab[:, 2], gsc) - 1
    gmul = ws * gl
    gwl = torch.where(galive, gmul - wp * torch.abs((ga - gla) - (gb - glb)),
                      NEG)

    # runs: maximal blocks of consecutively chainable rows where every
    # in-run predecessor pair is exactly branch 1 of the |gap| split
    gfirst = (gseg != shift1(gseg, -9)) & galive
    chain_ok = (
        (shift1(gea, BIG) <= ga) & (shift1(geb, BIG) <= gb)
        & (shift1(gu, BIG) <= gv)
    )
    brk0 = (gfirst | ~chain_ok) & galive
    pmu = seg_max_scan(gu, brk0)
    brk = (brk0 | (shift1(pmu, BIG) > gv)) & galive
    runid = torch.where(galive, cumsum32(brk) - 1, -1)

    # the row chunks of the live rows (dead rows sort last), each with
    # the first row of its first segment and the end of its last one
    nch = -(-M // CH)
    starts = arange32(nch, dev) * CH
    lo = torch.searchsorted(gseg, take(gseg, starts))
    hi = torch.searchsorted(gseg, take(gseg, (starts + (CH - 1)).clamp(
        max=M - 1)), right=True)
    bounds = torch.cat([galive.sum(dtype=torch.int64)[None], lo, hi])
    bounds = reads(bounds)
    nlive = bounds[0]
    chunks = [
        (r0, min(r0 + CH, nlive), bounds[1 + c], min(bounds[1 + nch + c],
                                                     nlive))
        for c, r0 in enumerate(range(0, nlive, CH))
    ]
    # per chunk: compatible predecessors (same segment, ends dominated,
    # earlier row), those outside the row's run, and the gap penalty
    pairs = []
    for r0, r1, c0, _c1 in chunks:
        i, j = slice(r0, r1), slice(c0, r1)
        earlier = iar_m[None, j] < iar_m[i, None]
        compat = (
            (gseg[None, j] == gseg[i, None]) & galive[None, j]
            & (gea[None, j] <= ga[i, None]) & (geb[None, j] <= gb[i, None])
            & earlier
        )
        inrun = (runid[None, j] == runid[i, None]) & earlier
        pen = wp * torch.abs(gv[i, None] - gu[None, j])
        pairs.append((compat, compat & ~inrun, pen))

    # wavefront rounds: scores only
    psi = gmul - wp * (gv - gu)
    reset = (brk | (iar_m == 0)).to(I32)
    score = torch.zeros(M, dtype=I32, device=dev)
    done = ~galive
    rounds = 0
    rabort = 0
    more = nlive > 0   # a live row is not done
    while more and rounds < _RMAX and rabort == 0:
        # per row: blocked = a compatible predecessor outside the run is
        # not done; outv = the best done compatible predecessor's score
        blocked = torch.zeros(M, dtype=torch.bool, device=dev)
        outv = torch.full((M,), NEG, dtype=I32, device=dev)
        for (r0, r1, c0, _c1), (compat, outrun, pen) in zip(chunks, pairs):
            dj = done[None, c0:r1]
            blocked[r0:r1] = (outrun & ~dj).any(1)
            outv[r0:r1] = torch.where(compat & dj, score[None, c0:r1] - pen,
                                      NEG).amax(1)
        # commit = per-run prefix of unblocked undone rows
        okrow = done | (~blocked & galive)
        commit = galive & ~done & (seg_min_scan(okrow.to(I32), brk) > 0)
        # exclusive segmented prefix of f(m) = max(m + P, Q): a run start
        # sees an empty prefix
        base = torch.maximum(gwl, outv + gmul)
        P = torch.where(commit, psi.clamp(min=0), 0)
        Q = torch.where(done & galive, score + wp * gu,
                        torch.where(commit, base + wp * gu, NEG))
        _, m_in, _ = associative_scan(_comb_aff, (
            torch.where(brk, 0, shift1(P, 0)),
            torch.where(brk, NEG, shift1(Q, NEG)),
            reset,
        ))
        # an empty prefix (m_in = NEG) must not wrap int32 when the row
        # offset is added
        sc_new = torch.where(m_in > NEG // 2,
                             torch.maximum(base, m_in + gmul - wp * gv), base)
        score = torch.where(commit, sc_new, score)
        done = done | commit
        rounds += 1
        more, progress = reads(torch.stack([(galive & ~done).any(),
                                            commit.any()]))
        if not progress:
            rabort = ABORT_CHAIN_ROUNDS
    if rabort or more:
        abort = torch.where(abort == 0, ABORT_CHAIN_ROUNDS, abort)

    # act: geometric activation step, the least dominating row
    act = torch.full((M,), BIG, dtype=I32, device=dev)
    for r0, r1, c0, c1 in chunks:
        i, j = slice(c0, c1), slice(r0, r1)
        dom = (
            (gseg[i, None] == gseg[None, j]) & galive[i, None]
            & (ga[i, None] >= gea[None, j]) & (gb[i, None] >= geb[None, j])
        )
        act[j] = torch.where(dom, iar_m[i, None], BIG).amin(0)

    # links: exact winner reconstruction, lex key (tmpw, score_j,
    # -act_j, -row_j); the left pseudo wins ties per the reference's
    # traversal order (schemes.py:64-87)
    link = torch.full((M,), -2, dtype=I32, device=dev)
    for (r0, r1, c0, _c1), (compat, _outrun, pen) in zip(chunks, pairs):
        tw = torch.where(compat, score[None, c0:r1] - pen, NEG)
        mx = tw.amax(1)
        t1 = tw == mx[:, None]
        sc2 = torch.where(t1, score[None, c0:r1], NEG)
        mx2 = sc2.amax(1)
        t2 = t1 & (sc2 == mx2[:, None])
        a3 = torch.where(t2, act[None, c0:r1], BIG)
        t3 = t2 & (a3 == a3.amin(1)[:, None])
        brow = torch.argmax(t3.to(torch.uint8), dim=1).to(I32) + c0
        wl_i = gwl[r0:r1]
        mxg = mx + gmul[r0:r1]
        use_left = (mx <= NEG) | (wl_i > mxg) | ((wl_i == mxg) & (mx2 <= 0))
        link[r0:r1] = torch.where(use_left, -1, brow)
    del pairs

    # backtrack + largest (schemes.py:298-301): pointer doubling along
    # the link chains, per row the best (strictly greater wins, nearest
    # wins ties) candidate l on the path to the left pseudo
    def seg_max(vals):
        return torch.full((SMAX,), -1, dtype=I32, device=dev).scatter_reduce_(
            0, gsc.long(), vals, "amax")

    pseudo_pos = seg_max(torch.where((gpseudo == 1) & galive, iar_m, -1))
    ptr0 = torch.where(seg_live & (pseudo_pos >= 0),
                       take(link, pseudo_pos.clamp(0, M - 1)), -1)
    sentinel = torch.full((1,), M, dtype=I32, device=dev)
    nxt = torch.cat([torch.where(link >= 0, link, M), sentinel])
    bl = torch.cat([torch.where(cand, gl, -1), sentinel.new_full((1,), -1)])
    bs = torch.cat([iar_m, sentinel.new_full((1,), -1)])
    while reads((nxt[:M] != M).any()):
        bl2 = take(bl, nxt)
        bs2 = take(bs, nxt)
        take_far = bl2 > bl
        bl = torch.where(take_far, bl2, bl)
        bs = torch.where(take_far, bs2, bs)
        nxt = take(nxt, nxt)
    ptr0c = ptr0.clamp(0, M)
    blp = torch.where(ptr0 >= 0, take(bl, ptr0c), -1)
    bs_seg = torch.where((ptr0 >= 0) & (blp > -1), take(bs, ptr0c), -1)
    # single-candidate segments bypass the chain (picker __call__:
    # len(relmums) == 1)
    candcnt = torch.zeros(SMAX, dtype=I32, device=dev).index_add_(
        0, gsc, cand.to(I32))
    bs_seg = torch.where(seg_live & (candcnt == 1),
                         seg_max(torch.where(cand, iar_m, -1)), bs_seg)
    picked = seg_live & (bs_seg >= 0)
    bsc = bs_seg.clamp(0, M - 1)
    s_l = torch.where(picked, take(gl, bsc), 0)
    s_ma = torch.where(picked, take(ga, bsc), 0)
    s_mb = torch.where(picked, take(gb, bsc), 0)
    return picked, s_l, s_ma, s_mb, abort, rounds


# ----------------------------------------------------------------------
# anchor log and children (devloop.py:1063-1125)
# ----------------------------------------------------------------------
def log_anchors(anchors, acount, picked, s_ma, s_mb, s_l, seg_tab, abort):
    """Append one record (ma, mb, l, a_beg, a_end, b_beg, b_end,
    parent, cls) per picked segment.  Returns (anchors, lslot, npicked,
    abort); row ACAP of ``anchors`` is the spill row."""
    ACAP = anchors.shape[0] - 1
    npicked = picked.sum(dtype=I32)
    abort = torch.where(acount + npicked > ACAP, ABORT_ANCHOR_OVERFLOW, abort)
    prank = cumsum32(picked) - 1
    lslot = torch.where(picked, (acount + prank).clamp(max=ACAP), ACAP)
    rows = torch.stack(
        [s_ma, s_mb, s_l] + [seg_tab[:, c] for c in range(6)], dim=1
    )
    # non-picked rows all write the spill row's own value back
    anchors = anchors.index_put(
        (lslot.long(),),
        torch.where(picked[:, None], rows, take(anchors, lslot)),
    )
    return anchors, lslot, npicked, abort


def children(picked, s_ma, s_mb, s_l, seg_tab, lslot, abort):
    """Leading/trailing child segments of every picked anchor: the
    next level's seg_tab (leads in parent order, then trails)."""
    SMAX = seg_tab.shape[0]
    dev = seg_tab.device
    lead_live = picked & (s_ma > seg_tab[:, 0]) & (s_mb > seg_tab[:, 2])
    trail_live = (
        picked & (s_ma + s_l < seg_tab[:, 1]) & (s_mb + s_l < seg_tab[:, 3])
    )
    nl = cumsum32(lead_live)
    nt = cumsum32(trail_live)
    n_lead = nl[-1]
    lead_id = torch.where(lead_live, nl - 1, SMAX)
    trail_id = torch.where(trail_live, n_lead + nt - 1, SMAX)
    nseg_new = n_lead + nt[-1]
    abort = torch.where(nseg_new > SMAX, ABORT_SEG_OVERFLOW, abort)
    lead_id = lead_id.clamp(max=SMAX)
    trail_id = trail_id.clamp(max=SMAX)
    ones = torch.ones(SMAX, dtype=I32, device=dev)
    lrow = torch.stack(
        [seg_tab[:, 0], s_ma, seg_tab[:, 2], s_mb, lslot, ones, s_ma, s_mb],
        dim=1,
    )
    trow = torch.stack(
        [s_ma + s_l, seg_tab[:, 1], s_mb + s_l, seg_tab[:, 3], lslot,
         2 * ones, s_ma, s_mb],
        dim=1,
    )
    # dead children go to their own spill rows past SMAX
    spill = SMAX + arange32(SMAX, dev)
    new_tab = torch.zeros((2 * SMAX, 8), dtype=I32, device=dev)
    new_tab.index_copy_(0, torch.where(lead_live & (lead_id < SMAX),
                                       lead_id, spill).long(), lrow)
    new_tab.index_copy_(0, torch.where(trail_live & (trail_id < SMAX),
                                       trail_id, spill).long(), trow)
    return (new_tab[:SMAX], nseg_new, lead_live, trail_live,
            lead_id, trail_id, abort)


# ----------------------------------------------------------------------
# classify + split + lowercase, stable partition (devloop.py:1127-1296)
# ----------------------------------------------------------------------
def split_level(T, SA, LCP, BWT, SEG, picked, s_ma, s_mb, s_l, seg_tab,
                lead_live, trail_live, lead_id, trail_id):
    """Classify every slot into the leading/trailing child of its
    segment's anchor, compute the child LCP (per-class segmented
    running min), lowercase matched BWT entries and text, and apply the
    stable partition by new segment id.  Returns (T, SA, LCP, BWT,
    SEG) of the next level's layout (before repair)."""
    npad = SA.shape[0]
    ntext = T.shape[0]
    SMAX = seg_tab.shape[0]
    dev = SA.device
    iar_n = arange32(npad, dev)
    segstart = SEG != shift1(SEG, -9)
    btab = torch.stack(
        [
            picked.to(I32), s_ma, s_mb, s_l,
            seg_tab[:, 0], seg_tab[:, 1], seg_tab[:, 2], seg_tab[:, 3],
            lead_live.to(I32), trail_live.to(I32), lead_id, trail_id,
        ],
        dim=1,
    )
    brows = take(btab, SEG.clamp(0, SMAX - 1))
    pos = SA
    pickedb = brows[:, 0] > 0
    pma = torch.where(pickedb, brows[:, 1], -1)
    pmb = torch.where(pickedb, brows[:, 2], -1)
    pl = brows[:, 3]
    b_t0, b_t1, b_t2, b_t3 = brows[:, 4], brows[:, 5], brows[:, 6], brows[:, 7]
    b_ll = brows[:, 8] > 0
    b_tl = brows[:, 9] > 0
    b_lid, b_tid = brows[:, 10], brows[:, 11]
    in_lead = ((pos >= b_t0) & (pos < pma)) | ((pos >= b_t2) & (pos < pmb))
    in_trail = ((pos >= pma + pl) & (pos < b_t1)) | (
        (pos >= pmb + pl) & (pos < b_t3)
    )
    live_parent = (SEG >= 0) & pickedb
    nsg = torch.where(
        live_parent & in_lead & b_ll, b_lid.clamp(max=SMAX - 1), -1
    )
    nsg = torch.where(
        live_parent & in_trail & b_tl, b_tid.clamp(max=SMAX - 1), nsg
    )
    # lead_id/trail_id == SMAX only for dead children
    nsg = torch.where(live_parent & in_lead & ~b_ll, -1, nsg)
    nsg = torch.where(live_parent & in_trail & ~b_tl, -1, nsg)
    cls = torch.where(live_parent & in_lead, 1, 0)
    cls = torch.where(live_parent & in_trail, 2, cls)

    # child LCP: per-class segmented running min over the parent layout
    # (split(), reveal.c:582-664)
    cls_prev = shift1(cls, 0)
    mm1 = seg_min_scan(LCP, segstart | (cls_prev == 1))
    mm2 = seg_min_scan(LCP, segstart | (cls_prev == 2))
    newlcp = torch.where(cls == 1, mm1, torch.where(cls == 2, mm2, 0))

    # stable partition by new segment id, computed analytically: leads
    # land in slot order first, then trails; dead slots are dropped
    ld = (nsg >= 0) & (cls == 1)
    tr = (nsg >= 0) & (cls == 2)
    ldi = ld.to(I32)
    tri = tr.to(I32)
    egl = cumsum32(ldi) - ldi
    egt = cumsum32(tri) - tri
    nlead_tot = egl[-1] + ldi[-1]
    newpos = torch.where(ld, egl, torch.where(tr, nlead_tot + egt, npad))
    # lowercase the BWT entries whose text position (pos-1) falls in
    # this level's matched regions of the slot's own parent
    pm1 = pos - 1
    bwt_m = ((pm1 >= pma) & (pm1 < pma + pl)) | (
        (pm1 >= pmb) & (pm1 < pmb + pl)
    )
    bwt_up = (BWT >= ord("A")) & (BWT <= ord("Z"))
    BWT = torch.where(bwt_m & bwt_up, BWT + 32, BWT)
    # inverse permutation (a partial permutation: unique targets)
    invp = scatter_drop(torch.full((npad,), npad, dtype=I32, device=dev),
                        newpos, iar_n)
    pvalid = invp < npad
    packed = torch.stack([BWT, SA, newlcp, nsg.clamp(0, SMAX)], dim=1)
    rows2 = take(packed, invp.clamp(max=npad - 1))
    BWT_n = torch.where(pvalid, rows2[:, 0], 0)
    SA_n = torch.where(pvalid, rows2[:, 1], 0)
    lcp_p = torch.where(pvalid, rows2[:, 2], 0)
    segk = torch.where(pvalid, rows2[:, 3], SMAX)
    SEG_n = torch.where(segk >= SMAX, -1, segk)
    firstslot = SEG_n != shift1(SEG_n, -9)
    LCP_n = torch.where(firstslot | (SEG_n < 0), 0, lcp_p)

    # lowercase matched text (every live text position is exactly one
    # slot's SA in the pre-partition layout)
    in_match = live_parent & ~in_lead & ~in_trail & (
        ((pos >= pma) & (pos < pma + pl)) | ((pos >= pmb) & (pos < pmb + pl))
    )
    upmask = scatter_drop(
        torch.zeros(ntext, dtype=torch.bool, device=dev),
        torch.where(in_match, pos, ntext), True,
    )
    isup = (T >= ord("A")) & (T <= ord("Z"))
    T = torch.where(upmask & isup, T + 32, T)
    return T, SA_n, LCP_n, BWT_n, SEG_n


# ----------------------------------------------------------------------
# boundary repair (bubble_sort, reveal.c:666-727; devloop.py:1297-1632)
# ----------------------------------------------------------------------
class HostReads:
    """Counted device-to-host reads: one object counts every read of a
    dispatch, its repair passes' included.  With tracing on, each read's
    seconds are a wait of the innermost open span (``trace.read``)."""

    def __init__(self):
        self.n = 0

    def __call__(self, t):
        """``t`` as Python values: one counted read."""
        return self.sync(t.tolist)

    def sync(self, fn, *args, **kw):
        """``fn(*args, **kw)``, a call that waits for the card (a read, or
        an op that sizes its output on the host): one counted read."""
        self.n += 1
        return trace.read(fn, *args, **kw)


@dataclass
class RepairQueue:
    """The crossing suffixes of one repair pass."""
    cq: torch.Tensor            # (CCAP,) slot of each candidate
    centry_next: torch.Tensor   # (CCAP,) LCP[cq + 1] at pass start
    beg: torch.Tensor           # (npad,) the pass's begin per slot
    SEG: torch.Tensor           # (npad,) segment id per slot
    SMAX: int
    WREP: int
    host: HostReads             # counts the pass's reads


def resolve(SA, LCP, rq: RepairQueue, j: int):
    """One pending candidate on the live state (the exact sequential
    resolve): returns (q, x, move, thr, saq, lcq) as Python ints.  The
    insertion-point search x = max y < q with LCP[y] < thr scans a
    WREP window, with a whole-array scan for the deep tail."""
    q = rq.host(rq.cq[j])
    b, saq, lcq = rq.host(torch.stack([rq.beg[q], SA[q], LCP[q]]))
    thr = b - saq
    move = saq < b and saq + lcq > b
    WREP = rq.WREP
    s0 = max(q - WREP, 0)
    win = dynamic_slice(LCP, s0, WREP + 2)
    widx = s0 + arange32(WREP + 2, LCP.device)
    cand = (widx < q) & (win < thr)
    y = rq.host(torch.where(cand, widx, -1).max())
    found = y >= 0 or s0 == 0
    if move and not found:
        iar_n = arange32(LCP.shape[0], LCP.device)
        y = rq.host(torch.where((iar_n < q) & (LCP < thr), iar_n, -1).max())
    return q, max(y, 0), move, thr, saq, lcq


def apply_one(SA, LCP, moved, rq: RepairQueue, q, x, move, thr, saq, lcq,
              mvals, j, acc):
    """Apply one candidate in place: rotate slots (x, q] right by one
    and insert the mover at x (SA and every array of ``moved``, whose
    values at q are ``mvals``) with LCP[x+1] = thr, then the LCP[q+1]
    update.  (The JAX kernel's window and whole-array branches compute
    this same rotation.)"""
    npad = SA.shape[0]
    do_mv = acc and move
    # one slot is written by fill_: assigning a Python number to a slot
    # of a card tensor copies it from host memory, and that copy waits
    # for the card
    if do_mv:
        for arr, v in zip((SA,) + tuple(moved), (saq,) + tuple(mvals)):
            arr[x + 1:q + 1] = arr[x:q].clone()
            arr[x].fill_(v)
        LCP[x + 1:q + 1] = LCP[x:q].clone()
        LCP[x + 1].fill_(thr)
    qn = min(q + 1, npad - 1)
    lcp_qn, cnext, lcp_q = rq.host(
        torch.stack([LCP[qn], rq.centry_next[j], LCP[q]]))
    b = thr + saq
    mv_upd = do_mv and q < npad - 1 and lcq < lcp_qn
    lcponly = (
        acc and not move and q < npad - 1 and saq < b
        and saq + cnext > b and lcp_qn > lcp_q
    )
    LCP[qn].fill_(lcq if mv_upd else (b - saq if lcponly else lcp_qn))
    return SA, LCP, moved


def repair_round(SA, LCP, moved, pend, rq: RepairQueue, stats, search):
    """One whole-batch repair round (``rbody``); at least one candidate
    is pending.

    ``moved`` are the per-slot arrays that move with SA: (BWT,) in the
    pairwise forest, (BWT, SOA) in the multi-genome loop.  The first RBV
    pending candidates are resolved at once through ``search`` (the
    window-resolve kernel's wrapper, or its plain version); every
    candidate whose edit region is disjoint from its same-segment
    predecessor's is applied in one masked-shift + scatter pass
    (``vec_branch``).  A round that accepts nothing (the head is a
    window-miss mover) applies the head alone by the exact sequential
    resolve (``seq_branch``).  Returns (SA, LCP, moved, pend, more) with
    more = whether a candidate is still pending (read with the round's
    one host read, so that no round runs empty)."""
    npad = SA.shape[0]
    CCAP = rq.cq.shape[0]
    RBV = min(CCAP, 1024)
    dev = SA.device
    npend = pend.sum(dtype=I32)
    heads = compact(pend, RBV, CCAP - 1)
    iar_r = arange32(RBV, dev)
    hvalid = iar_r < npend
    q = take(rq.cq, heads)
    b = take(rq.beg, q)
    saq = take(SA, q)
    lcq = take(LCP, q)
    thr = b - saq
    move = (saq < b) & (saq + lcq > b)
    y = search(LCP, q, thr, _WRV)
    # a window hit IS the global max y; a clipped window (q <= WRV)
    # that misses means x = 0 exactly
    resolved = (y >= 0) | (q - _WRV <= 0)
    x = y.clamp(min=0)
    ok = ~move | resolved
    # accept every pending candidate whose edit region is disjoint from
    # its previous same-segment pending candidate's (heads arrive
    # q-ascending per segment)
    sid = take(rq.SEG, q).clamp(0, rq.SMAX - 1)
    prev_same = (
        (iar_r > 0) & (sid == torch.roll(sid, 1))
        & hvalid & torch.roll(hvalid, 1)
    )
    q_prev = torch.where(prev_same, torch.roll(q, 1), -2)
    region_lo = torch.where(move, x, q)
    acc = hvalid & ok & (region_lo > q_prev + 1)

    npend_h, nacc = rq.host(torch.stack([npend, acc.sum(dtype=I32)]))
    if nacc:
        accm = acc & move
        fillu = npad + iar_r
        xs = torch.where(accm, x, fillu)
        xs1 = torch.where(accm, x + 1, fillu)
        d = torch.zeros(npad + RBV, dtype=I32, device=dev)
        d.index_add_(0, xs1, torch.ones_like(q))
        d.index_add_(0, torch.where(accm, q + 1, fillu), -torch.ones_like(q))
        inrot = cumsum32(d[:npad]) > 0
        # SA, the moved arrays and LCP as the rows of one state, each
        # rotated right by one inside the accepted windows (slot 0 is
        # never in one, so roll's wrap is never taken), then written
        # through spill columns past npad
        state = torch.stack((SA,) + tuple(moved) + (LCP,))
        C = state.shape[0]
        buf = torch.cat([
            torch.where(inrot, torch.roll(state, 1, 1), state),
            state.new_zeros((C, RBV)),
        ], 1)
        # the movers at x (SA and the moved arrays), LCP[x+1] = thr
        buf[:C - 1].index_copy_(1, xs.long(),
                                state.index_select(1, q)[:C - 1])
        buf[C - 1].index_copy_(0, xs1.long(), thr)
        # LCP[q+1] updates (outside every rotation window, so
        # round-start values are live)
        qn = (q + 1).clamp(max=npad - 1)
        lcp_qn = take(LCP, qn)
        mv_upd = accm & (q < npad - 1) & (lcq < lcp_qn)
        lcponly = (
            acc & ~move & (q < npad - 1) & (saq < b)
            & ((saq + take(rq.centry_next, heads)) > b) & (lcp_qn > lcq)
        )
        newv = torch.where(
            mv_upd, lcq, torch.where(lcponly, b - saq, lcp_qn)
        )
        buf[C - 1].index_copy_(
            0, torch.where(mv_upd | lcponly, qn, fillu).long(), newv)
        pend = scatter_drop(pend, torch.where(acc, heads, CCAP + iar_r),
                            False)
        stats[2] += torch.where(accm, q - x, 0).sum()
        return (buf[0, :npad], buf[C - 1, :npad],
                tuple(buf[k, :npad] for k in range(1, C - 1)), pend,
                npend_h > nacc)

    j, valid0 = rq.host(torch.stack([heads[0], hvalid[0].to(I32)]))
    q1, x1, mv1, thr1, saq1, lcq1 = resolve(SA, LCP, rq, j)
    mvals = rq.host(torch.stack([m[q1] for m in moved]))
    SA, LCP, moved = apply_one(
        SA, LCP, moved, rq, q1, x1, mv1, thr1, saq1, lcq1, mvals, j,
        bool(valid0),
    )
    if mv1:
        stats[2] += q1 - x1
    pend = pend.clone()
    pend[j].fill_(False)
    return SA, LCP, moved, pend, npend_h > 1


def repair_rounds(SA, LCP, moved, SEG, beg, cq, centry_next, rc, SMAX,
                  stats, search, reads):
    """The pass's crossing suffixes ``cq[:min(rc, CCAP)]`` applied by
    batched repair rounds (the JAX kernel's ``while_loop`` over
    ``rbody``), ``moved`` moving with SA and the insertion points found
    by ``search``.  Adds to ``stats`` as the repair kernel does and its
    host reads to ``reads`` (a ``HostReads``).
    Returns (SA, LCP, moved, rounds)."""
    npad = SA.shape[0]
    CCAP = cq.shape[0]
    rq = RepairQueue(
        cq=cq, centry_next=centry_next, beg=beg, SEG=SEG, SMAX=SMAX,
        # repair window: full-array on tiny inputs (always exact there)
        WREP=min(_WREP, npad - 2), host=reads,
    )
    n = rq.host(rc.clamp(max=CCAP))
    if n == 0:
        return SA, LCP, moved, 0
    # unique_consecutive sizes its output on the host: a read
    runs = reads.sync(torch.unique_consecutive, take(SEG, cq[:n]),
                      return_counts=True)[1]
    stats[0] += n
    stats[1] = torch.maximum(stats[1], runs.max())
    pend = arange32(CCAP, SA.device) < n
    rounds = 0
    more = True
    while more and rounds < CCAP:
        SA, LCP, moved, pend, more = repair_round(SA, LCP, moved, pend, rq,
                                                  stats, search)
        rounds += 1
    return SA, LCP, moved, rounds


def repair_rounds_plain(SA, LCP, BWT, SEG, beg, cq, centry_next, rc, SMAX,
                        stats):
    """Plain version of ``repair.repair_segments``: ``repair_rounds``
    with the plain insertion-point search.
    Returns (SA, LCP, BWT, rounds)."""
    SA, LCP, (BWT,), rounds = repair_rounds(
        SA, LCP, (BWT,), SEG, beg, cq, centry_next, rc, SMAX, stats,
        window_resolve_plain, HostReads(),
    )
    return SA, LCP, BWT, rounds


def repair_queue(SA, LCP, is_lead, beg, CCAP, abort):
    """The crossing suffixes of one repair pass: every leading child's
    slot whose suffix crosses its begin on one side (``beg``).  Returns
    (cq, centry_next, rc, abort): the first CCAP slots, ascending (padded
    with npad - 1), ``LCP[cq + 1]`` now, their count, and the abort code
    with ``ABORT_REPAIR_OVERFLOW`` set where they do not fit."""
    npad = SA.shape[0]
    lcpn = shift_left(LCP, 0)
    cross0 = is_lead & (SA < beg) & (((SA + LCP) > beg) | ((SA + lcpn) > beg))
    rc = cross0.sum(dtype=I32)
    abort = torch.where(rc > CCAP, ABORT_REPAIR_OVERFLOW, abort)
    cq = compact(cross0, CCAP, npad - 1)
    return cq, take(lcpn, cq), rc, abort


def repair_pass(SA, LCP, BWT, SEG, is_lead, beg, CCAP, SMAX, abort, stats):
    """Repair every leading child's suffixes that cross its begin on
    one side (``beg``): one launch of the repair kernel on the card,
    batched rounds on the CPU.  Returns (SA, LCP, BWT, abort, steps)
    with steps = rounds on the CPU, 1 on the card."""
    cq, centry_next, rc, abort = repair_queue(SA, LCP, is_lead, beg, CCAP,
                                              abort)
    SA, LCP, BWT, steps = repair.repair_segments(
        SA, LCP, BWT, SEG, beg, cq, centry_next, rc, SMAX, stats
    )
    return SA, LCP, BWT, abort, steps


# ----------------------------------------------------------------------
# the level loop (devloop.py:953-1656)
# ----------------------------------------------------------------------
@dataclass
class Caps:
    """Capacities of one dispatch (doubled one at a time on retry)."""
    K: int      # candidates per level
    SMAX: int   # live segments
    ACAP: int   # anchor log rows
    CCAP: int   # repair candidates per pass
    CW: Optional[int]   # dense chain width; None: the flat chain


def forest_run(Tu8, SA, LCP, SEG, seg_tab, nseg0, nsep0, minl, maxmums,
               ws, wp, caps: Caps, reads):
    """Run the whole recursion below the ``nseg0`` live segments of
    ``seg_tab``: the packed forest's, or the single root's.

    ``Tu8``: (ntext,) uint8 text; ``SA``/``LCP``/``SEG``: (npad,) int32
    slots; ``seg_tab``: (SMAX, 8) int32 rows a_beg a_end b_beg b_end
    parent cls ma mb.  A level chains by ``chain_dense`` when ``caps.CW``
    is a width and by ``chain_flat`` when it is None, as the JAX kernel's
    ``chain_width`` selects.  Returns (T_u8, anchors, acount, abort,
    level, steps, repair_stats) with steps = [trim rows, chain steps
    (column steps or wavefront rounds), repair steps] (the JAX kernel's
    ``run``; repair steps are batched rounds on the CPU, launches on the
    card) and repair_stats the repair counters [applied, longest run,
    moved slots].  The loop's reads to the host are counted in ``reads``
    (a ``HostReads``)."""
    dev = SA.device
    T = Tu8.to(I32)
    # BWT column T[SA-1]; SA == 0 wraps to slot 0 (the a_ == 0 guard in
    # enumerate makes the value irrelevant)
    BWT = take(T, (SA - 1).clamp(min=0))
    anchors = torch.zeros((caps.ACAP + 1, 9), dtype=I32, device=dev)
    acount = torch.zeros((), dtype=I32, device=dev)
    abort = torch.zeros((), dtype=I32, device=dev)
    sarange = arange32(caps.SMAX, dev)
    steps = [torch.zeros((), dtype=I32, device=dev), 0, 0]
    rstats = torch.zeros(3, dtype=torch.int64, device=dev)
    nseg = nseg0
    level = 0
    while nseg > 0 and level < _LMAX:
        with trace.span("level.enumerate"):
            cseg, cl, caa, cbb, abort = enumerate_candidates(
                SA, LCP, BWT, SEG, nsep0, minl, maxmums, caps.K, caps.SMAX,
                abort,
            )
        with trace.span("level.trim"):
            cseg, cl, caa, cbb, na0 = trim_dim(cseg, cl, caa, cbb, 0)
            cseg, cl, caa, cbb, na1 = trim_dim(cseg, cl, caa, cbb, 1)
            steps[0] = steps[0] + na0 + na1
        with trace.span("level.chain"):
            seg_live = sarange < nseg
            if caps.CW is None:
                picked, s_l, s_ma, s_mb, abort, rounds = chain_flat(
                    cseg, cl, caa, cbb, seg_tab, seg_live, abort, ws, wp,
                    reads,
                )
            else:
                picked, s_l, s_ma, s_mb, abort, rounds = chain_dense(
                    cseg, cl, caa, cbb, seg_tab, seg_live, abort, ws, wp,
                    caps.CW, reads,
                )
            steps[1] += rounds
        with trace.span("level.split"):
            anchors, lslot, npicked, abort = log_anchors(
                anchors, acount, picked, s_ma, s_mb, s_l, seg_tab, abort
            )
            (new_tab, nseg_new, lead_live, trail_live, lead_id, trail_id,
             abort) = children(picked, s_ma, s_mb, s_l, seg_tab, lslot,
                               abort)
            T, SA, LCP, BWT, SEG = split_level(
                T, SA, LCP, BWT, SEG, picked, s_ma, s_mb, s_l, seg_tab,
                lead_live, trail_live, lead_id, trail_id,
            )
        with trace.span("level.repair"):
            # per-slot views of the new children's (cls, ma, mb)
            brows2 = take(new_tab[:, 5:8], SEG.clamp(0, caps.SMAX - 1))
            is_lead = (SEG >= 0) & (brows2[:, 0] == 1)
            for which in (1, 2):   # A-side begin (parent ma), then B-side
                beg = torch.where(is_lead, brows2[:, which], -1)
                SA, LCP, BWT, abort, iters = repair_pass(
                    SA, LCP, BWT, SEG, is_lead, beg, caps.CCAP, caps.SMAX,
                    abort, rstats,
                )
                steps[2] += iters
        acount = (acount + npicked).clamp(max=caps.ACAP)
        seg_tab = new_tab
        level += 1
        nseg, abort_now = reads(torch.stack([nseg_new, abort]))
        if abort_now:
            break
    abort, trim_rows, acount = reads(torch.stack([abort, steps[0], acount]))
    if abort == 0 and level >= _LMAX:
        abort = ABORT_LEVEL_OVERFLOW
    steps = [trim_rows, steps[1], steps[2]]
    return (T.to(torch.uint8), anchors, acount, abort, level, steps,
            reads(rstats))


def _dispatch(T_p, SA_p, LCP_p, SEG_p, seg_rows, nsep0, minlength, maxmums,
              wscore, wpen, caps: Caps, device, what):
    """``forest_run`` on ``device`` from the padded host arrays, its live
    segments the rows ``seg_rows`` of seg_tab, until a dispatch ends on
    no retryable abort: each retryable abort doubles its capacity (at
    most five dispatches).  Fills ``LAST_STATS`` with the keys of both
    loops and returns the last dispatch's (T_u8, anchors, acount, abort,
    level)."""
    def dev_tensor(a):
        return torch.from_numpy(a).to(device)

    dispatches = 0
    repair_total = 0
    launches0 = repair.LAUNCHES
    reads = HostReads()
    for _attempt in range(5):
        if len(seg_rows) > caps.SMAX:
            caps.SMAX = _next_pow2(len(seg_rows))
        seg_tab = np.zeros((caps.SMAX, 8), dtype=np.int32)
        seg_tab[:len(seg_rows)] = seg_rows
        T_out, anchors, acount, abort, level, steps, rstats = forest_run(
            dev_tensor(T_p), dev_tensor(SA_p), dev_tensor(LCP_p),
            dev_tensor(SEG_p), dev_tensor(seg_tab), len(seg_rows),
            int(nsep0), int(minlength), int(maxmums), int(wscore),
            int(wpen), caps, reads,
        )
        dispatches += 1
        repair_total += steps[2]
        if abort in _RETRYABLE:
            cap = _RETRYABLE[abort]
            setattr(caps, cap, 2 * getattr(caps, cap))
            log.info("%s: %s overflow, retrying with %s=%d", what, cap, cap,
                     getattr(caps, cap))
            continue
        break
    LAST_STATS.update(
        levels=level, dispatches=dispatches, anchors=acount, abort=abort,
        trim_steps=steps[0], chain_steps=steps[1], repair_steps=steps[2],
        repair_rounds_total=repair_total,
        repair_launches=repair.LAUNCHES - launches0,
        repair_applied=rstats[0], repair_chain_max=rstats[1],
        repair_moved_slots=rstats[2], host_syncs=reads.n,
    )
    if abort:
        log.info("%s aborted (code %d)", what, abort)
    return T_out, anchors, acount, abort, level


def rem_device_forest(T, defers, nsep0, minlength, maxmums, wscore=1,
                      wpen=1, *, device):
    """Run the deferred small-segment forest on ``device``.

    ``defers`` comes from ``reveal_tpu.native.rem2_defer_native``: per
    deferred segment ``(k, a_beg, a_end, b_beg, b_end, sa, lcp)``.  All
    segments are packed into one slot array (seg ids 0..F-1) and the
    residual recursion runs through ``forest_run``; a retryable
    capacity abort re-runs with that capacity doubled.

    Returns ``(subtrees, T_out, levels)`` where subtrees maps defer id
    -> (na_i, 7) int64 anchor records in that subtree's serial pop
    order, or None on a non-retryable abort or a text of 2^30 bytes or
    more (the caller declines the input).  Fills ``LAST_STATS``."""
    device = torch.device(device)
    n = len(T)
    total = int(sum(len(d[5]) for d in defers))
    F = len(defers)
    LAST_STATS.clear()
    if F == 0:
        return {}, np.asarray(T, np.uint8), 0
    if n >= 2**30 or minlength < 1:
        return None
    npad = _next_pow2(max(total, 2))
    ntext = _next_pow2(n)
    sum_k = int(sum(d[0] for d in defers))
    max_k = int(max(d[0] for d in defers))
    caps = Caps(
        K=_next_pow2(max(1024, sum_k)),
        # the frontier widens well past the forest size as subtrees branch
        SMAX=_next_pow2(max(2048, 8 * F)),
        ACAP=max(8192, npad // 64),
        CCAP=max(1024, npad // 256),
        # deferred roots hold <= defer_max candidates; children
        # occasionally widen past the parent
        CW=_next_pow2(max(32, 2 * max_k)),
    )

    T_p = np.zeros(ntext, dtype=np.uint8)
    T_p[:n] = np.asarray(T, dtype=np.uint8)
    SA_p = np.full(npad, n - 1, dtype=np.int32)
    LCP_p = np.zeros(npad, dtype=np.int32)
    SEG_p = np.full(npad, -1, dtype=np.int32)
    seg_rows = np.zeros((F, 8), dtype=np.int32)
    off = 0
    for sid, (_k, ab, ae, bb, be, sa, lcp) in enumerate(defers):
        sn = len(sa)
        SA_p[off:off + sn] = sa
        LCP_p[off:off + sn] = lcp
        LCP_p[off] = 0  # first-slot LCP is per-segment 0 (split3)
        SEG_p[off:off + sn] = sid
        off += sn
        seg_rows[sid] = (ab, ae, bb, be, -2 - sid, 0, -1, -1)

    T_out, anchors, acount, abort, level = _dispatch(
        T_p, SA_p, LCP_p, SEG_p, seg_rows, nsep0, minlength, maxmums,
        wscore, wpen, caps, device, "device forest")
    LAST_STATS.update(forest=F, slots=total)
    if abort:
        return None
    anchors = anchors[:acount].cpu().numpy().astype(np.int64)
    T_out = T_out[:n].cpu().numpy()
    if acount == 0:
        return {}, T_out, 0
    orders = forest_pop_order(anchors[:, 7], anchors[:, 8])
    subtrees = {
        did: anchors[idx][:, [0, 1, 2, 3, 4, 5, 6]]
        for did, idx in orders.items()
    }
    log.debug(
        "device forest: %d anchors over %d roots in %d levels",
        acount, F, level,
    )
    return subtrees, T_out, level


def pop_order(parents: np.ndarray, cls: np.ndarray) -> np.ndarray:
    """Serial LIFO pop order from (parent anchor idx, child class) per
    anchor: push order parallel/leading/trailing with pop from the end
    (reveal.c:21-27,1295-1324) == pre-order walk, trailing subtree
    first."""
    A = len(parents)
    lead = np.full(A, -1, np.int64)
    trail = np.full(A, -1, np.int64)
    root = -1
    for i in range(A):
        p, c = int(parents[i]), int(cls[i])
        if p < 0:
            root = i
        elif c == 1:
            lead[p] = i
        else:
            trail[p] = i
    order = np.empty(A, np.int64)
    k = 0
    stack = [root] if root >= 0 else []
    while stack:
        t = stack.pop()
        order[k] = t
        k += 1
        # pop order: trailing first, so push leading first
        if lead[t] >= 0:
            stack.append(int(lead[t]))
        if trail[t] >= 0:
            stack.append(int(trail[t]))
    assert k == A, "anchor tree disconnected"
    return order


def rem_device_loop(T, SA, LCP, nsep0, minlength, maxmums, wscore=1,
                    wpen=1, *, device):
    """Run the whole pairwise recursion from the root on ``device``
    (reveal_tpu/index/devloop.py:1695): one live segment, the root A =
    [0, nsep0), B = [nsep0 + 1, n - 1), over every slot of the text,
    through ``forest_run`` with the flat chain; a retryable capacity
    abort re-runs with that capacity doubled.

    Returns ``(anchors, T_out, levels)``: anchors an int64 array of rows
    (ma, mb, l, a_beg, a_end, b_beg, b_end) in serial LIFO pop order
    (ready for ``align.rem._rem2_replay``), T_out the lowercased text;
    or None on a non-retryable abort or a text of 2^30 bytes or more
    (the caller declines the input).  Fills ``LAST_STATS`` with the JAX
    loop's keys and the repair counters."""
    device = torch.device(device)
    n = len(SA)
    LAST_STATS.clear()
    if n >= 2**30 or minlength < 1:
        return None
    npad = _next_pow2(n)
    caps = Caps(
        K=max(2048, npad // 512),
        SMAX=max(4096, npad // 512),
        ACAP=max(4096, npad // 64),
        # repair candidates per pass grow with text size
        CCAP=max(1024, npad // 1024),
        CW=None,
    )
    T_p = np.zeros(npad, dtype=np.uint8)
    T_p[: len(T)] = np.asarray(T, dtype=np.uint8)
    SA_p = np.full(npad, n - 1, dtype=np.int32)
    SA_p[:n] = np.asarray(SA, dtype=np.int32)
    LCP_p = np.zeros(npad, dtype=np.int32)
    LCP_p[:n] = np.asarray(LCP, dtype=np.int32)
    SEG_p = np.full(npad, -1, dtype=np.int32)
    SEG_p[:n] = 0
    root = np.array([(0, nsep0, nsep0 + 1, n - 1, -1, 0, -1, -1)],
                    dtype=np.int32)
    T_out, anchors, acount, abort, level = _dispatch(
        T_p, SA_p, LCP_p, SEG_p, root, nsep0, minlength, maxmums, wscore,
        wpen, caps, device, "device loop")
    if abort:
        return None
    anchors = anchors[:acount].cpu().numpy().astype(np.int64)
    T_out = T_out[:n].cpu().numpy()
    if acount == 0:
        return np.zeros((0, 7), np.int64), T_out, 0
    order = pop_order(anchors[:, 7], anchors[:, 8])
    log.debug("device loop: %d anchors in %d levels", acount, level)
    return anchors[order][:, [0, 1, 2, 3, 4, 5, 6]], T_out, level
