"""Whole-recursion level loop of the multi-genome recursion, in torch.

Port of ``reveal_tpu/index/devloop.py``: ``_build_kernel_multi``
(:1974-3304), ``forest_pop_order_multi`` (:3307) and ``rem_device_multi``
(:3346).  The complete recursion over 3..8 contig paths runs level by
level on the device.  Each level:

1. ``enumerate_multi``: the windowed PSV/NSV multiMUM enumeration with
   the SAMPLE and PATH bitmasks, the path nibbles in window order
   (``ordp``) and the per-path positions, in the candidate order
   lexsort (l, lb, ub);
2. ``select_subsets``: the all-live-sample filter, else the segment()
   subset pick;
3. ``trim_dim_multi`` once a window coordinate, then the same-path-set
   filter (``same_paths``);
4. ``chain_dense_multi``: the D-dimensional sum-of-pairs chain DP and
   the ``largest`` pick, its score pass in ``chain_score.chain_scores``
   (the CUDA kernel ``csrc/chain_score_multi.cu`` on the card, one
   launch a level);
5. ``log_anchors_multi``, ``children_multi`` and ``split_multi``: the
   anchor log, the leading, trailing and parallel children, the
   three-reset segmented running-min LCP, lowercasing and the 3-way
   stable partition;
6. ``repair_pass_multi`` once a path dimension: batched repair rounds
   whose insertion points come from ``window_resolve.window_resolve``
   (the CUDA kernel ``csrc/window_resolve.cu`` on the card), with SOA
   (the path id of each slot) moving with SA, LCP and BWT.

Candidates travel as one (K, 6 + D) int32 table (``C_*`` columns:
segment, length, sample key, path mask, path nibbles, width, then one
position per path), so a sort moves every field by one gather.  All
outputs are bit-identical to the JAX kernel's, with its one defect
repaired: ``segstart`` is defined (from the SEG of the level before the
partition, as the pairwise kernel defines it).  Where the JAX code
computes over all SMAX segments and CW + 1 chain columns, the port
computes over the live segments and the widest live segment's columns
only, which gives the same values.  Python control flow on host reads
replaces the JAX ``while_loop``s; each read is counted
(``LAST_STATS["host_syncs"]``), and the level loop reads its state once a
level.  A level's stages are the spans ``multi.enumerate`` (1),
``multi.trim`` (2-3, with the read of the segments' candidate counts),
``multi.chain`` (4), ``multi.split`` (5) and ``multi.repair`` (6)
(``core/trace.py``).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..core import trace
from ..core.encoding import N_BYTE, SENTINEL
from . import chain_score
from . import window_resolve as wr
from .chain_score import pair_index, pair_pen
from .devloop import (
    A30,
    ABORT_CAND_OVERFLOW,
    ABORT_DUP_REF,
    ABORT_LEVEL_OVERFLOW,
    ABORT_MAXMUMS,
    ABORT_SEG_OVERFLOW,
    ABORT_ANCHOR_OVERFLOW,
    ABORT_SEG_WIDTH,
    BIG,
    I32,
    NEG,
    _LMAX,
    _RETRYABLE,
    Caps,
    HostReads,
    _next_pow2,
    arange32,
    associative_scan,
    compact,
    cumsum32,
    last_value_scan,
    repair_queue,
    repair_rounds,
    scatter_drop,
    seg_min_scan,
    shift1,
    shift_left,
    sort_by,
    take,
)

log = logging.getLogger(__name__)

# columns of the candidate table
C_SEG, C_L, C_KEY, C_PM, C_ORD, C_W, C_P = range(7)

# stats of the most recent rem_device_multi call, with the keys of the
# JAX package's LAST_STATS (levels, dispatches, anchors, abort,
# trim_steps, chain_steps, repair_steps) and the port's own:
# repair_passes (passes with candidates), window_resolve_launches (the
# kernel's launches; 0 on the CPU), chain_score_launches (the chain score
# kernel's launches in the last dispatch: one a level with live segments
# and candidate columns; 0 on the CPU), host_syncs (device-to-host reads of
# the loop), repair_applied / repair_chain_max / repair_moved_slots (as
# in the pairwise forest), caps (of the last dispatch) and loop_seconds.
LAST_STATS = {}

# elements of the largest intermediate a chunk of the chain may make
_CHUNK_ELEMS = 1 << 24


def _shiftk(x, k, fill):
    """x shifted right by k (left for k < 0), ``fill`` entering."""
    n = x.shape[0]
    k = max(-n, min(n, k))
    if k == 0:
        return x
    if k > 0:
        return torch.cat([x.new_full((k,), fill), x[:n - k]])
    return torch.cat([x[-k:], x.new_full((-k,), fill)])


def _popcount(x, nbits):
    c = torch.zeros_like(x)
    for d in range(nbits):
        c = c + ((x >> d) & 1)
    return c


def _bit(x):
    """1 << x for an int32 tensor x."""
    return torch.bitwise_left_shift(torch.ones_like(x), x)


# ----------------------------------------------------------------------
# enumerate multiMUMs, windowed PSV/NSV (devloop.py:2203-2329)
# ----------------------------------------------------------------------
def enumerate_multi(SA, LCP, BWT, SOA, SEG, sop, minl, minn, maxmums, K,
                    SMAX, abort):
    """Every multiMUM of every live segment as a row of the (K, 6 + D)
    candidate table, in the order lexsort (l, lb, ub) within a segment;
    dead rows have segment BIG.  ``sop`` maps path -> sample.  Returns
    (table, abort)."""
    npad = SA.shape[0]
    dev = SA.device
    D = len(sop)
    DS = max(sop) + 1
    iar_n = arange32(npad, dev)
    iar_k = arange32(K, dev)
    l0 = LCP
    # nearest back/forward strictly-smaller LCP within D steps
    jb = torch.full((npad,), D + 1, dtype=I32, device=dev)
    jf = torch.full((npad,), D + 1, dtype=I32, device=dev)
    for k in range(1, D + 1):
        jb = torch.where((jb > D) & (_shiftk(LCP, k, BIG) < l0), k, jb)
        jf = torch.where((jf > D) & (_shiftk(LCP, -k, 0) < l0), k, jf)
    width = jb + jf
    have = (jb <= D) & (jf <= D)
    # dedup: no slot in (i-jb, i) with the same LCP value
    dup = torch.zeros(npad, dtype=torch.bool, device=dev)
    for k in range(1, D):
        dup = dup | ((k < jb) & (_shiftk(LCP, k, BIG) == l0))
    cand = (
        (SEG >= 0) & (l0 >= max(minl, 1)) & have & (width >= minn)
        & (width <= D) & ~dup
    )
    # distinct samples, left-maximality and the path nibbles over the
    # window [i-jb, i+jf-1]
    lmp = (
        (SA == 0) | (shift_left(SA, 0) == 0) | (BWT != shift_left(BWT, 0))
        | (BWT == N_BYTE) | (BWT == SENTINEL)
        | ((BWT >= ord("a")) & (BWT <= ord("z")))
    )
    sop_t = torch.tensor(sop, dtype=I32, device=dev)
    smpa = torch.where((SOA >= 0) & (SOA < D),
                       take(sop_t, SOA.clamp(0, D - 1)), 0)
    keymask = torch.zeros(npad, dtype=I32, device=dev)   # SAMPLE bits
    pathmask = torch.zeros(npad, dtype=I32, device=dev)  # PATH bits
    ordp = torch.zeros(npad, dtype=I32, device=dev)      # PATH nibbles
    anylm = torch.zeros(npad, dtype=torch.bool, device=dev)
    for rel in range(-D, D):
        inwin = (rel >= -jb) & (rel <= jf - 1)
        co_r = _shiftk(SOA, -rel, 0)
        sm_r = _shiftk(smpa, -rel, 0)
        keymask = torch.where(inwin, keymask | _bit(sm_r.clamp(0, 30)),
                              keymask)
        pathmask = torch.where(inwin, pathmask | _bit(co_r.clamp(0, 30)),
                               pathmask)
        jwin = (rel + jb).clamp(0, 7)
        ordp = torch.where(
            inwin,
            ordp | torch.bitwise_left_shift(co_r.clamp(0, 15), 4 * jwin),
            ordp,
        )
        if rel < D - 1:
            inpair = (rel >= -jb) & (rel <= jf - 2)
            anylm = anylm | (inpair & _shiftk(lmp, -rel, False))
    cand = cand & (_popcount(keymask, DS) == width) & anylm
    ccount = cand.sum(dtype=I32)
    abort = torch.where(ccount > K, ABORT_CAND_OVERFLOW, abort)
    slots = compact(cand, K, npad - 1)
    valid = iar_k < ccount.clamp(max=K)
    cjb = take(jb, slots)
    cjf = take(jf, slots)
    cols = [
        torch.where(valid, take(SEG, slots), BIG),
        torch.where(valid, take(l0, slots), 0),
    ] + [torch.where(valid, take(a, slots), 0)
         for a in (keymask, pathmask, ordp, width)]
    # per-path positions: the window's slots are of distinct samples,
    # so each path is written at most once (dead rows write column D)
    rels = torch.arange(-D, D, dtype=I32, device=dev)
    sl = (slots[:, None] + rels[None, :]).clamp(0, npad - 1)
    inwin = (valid[:, None] & (rels >= -cjb[:, None])
             & (rels <= cjf[:, None] - 1))
    so = SOA[sl]
    P = torch.full((K, D + 1), -1, dtype=I32, device=dev)
    P.scatter_(1, torch.where(inwin & (so >= 0) & (so < D), so, D).long(),
               SA[sl])
    table = torch.cat([torch.stack(cols, 1), P[:, :D]], 1)
    # canonical candidate order: lexsort by (l, lb, ub), the pinned
    # multiMUM emission order (esa_index.getmultimums_arrays); the
    # stable sorts keep the slot order on ties
    clb = torch.where(valid, slots - cjb, BIG)
    cub = slots + cjf - 1
    (table,) = sort_by((table[:, C_SEG], table[:, C_L], clb, cub), (table,))
    # maxmums: the host keeps the largest `maxmums`; abort instead
    cseg = table[:, C_SEG]
    percnt = torch.zeros(SMAX, dtype=I32, device=dev).index_add_(
        0, cseg.clamp(0, SMAX - 1), (cseg < BIG).to(I32)
    )
    abort = torch.where(percnt.max() > maxmums, ABORT_MAXMUMS, abort)
    return table, abort


# ----------------------------------------------------------------------
# subset selection (devloop.py:2330-2373)
# ----------------------------------------------------------------------
def select_subsets(table, live_key, DS):
    """graphmumpicker's filter (schemes.py:107-124,227-231): a segment
    with candidates over all its live samples keeps only those, any
    other keeps the sample set of segment(): the largest sum of l times
    the set's size, ties to the set met first.  Returns the compacted
    table and the number of rows kept."""
    K = table.shape[0]
    SMAX = live_key.shape[0]
    dev = table.device
    iar_k = arange32(K, dev)
    cseg, cl, ckey, cw = (table[:, c] for c in (C_SEG, C_L, C_KEY, C_W))
    alive = cseg < BIG
    segc = cseg.clamp(0, SMAX - 1)
    lcnt = _popcount(live_key, DS)
    isfull = alive & (cw == take(lcnt, segc))
    anyfull = torch.zeros(SMAX, dtype=I32, device=dev).index_add_(
        0, segc, isfull.to(I32)) > 0
    # segment(): per (seg, sample key) sum of l and first row
    NK = 1 << DS
    flat = (segc * NK + ckey.clamp(0, NK - 1)).long()
    gsum = torch.zeros(SMAX * NK, dtype=I32, device=dev).index_add_(
        0, flat, torch.where(alive, cl, 0)).reshape(SMAX, NK)
    gfirst = torch.full((SMAX * NK,), K, dtype=I32, device=dev)
    gfirst = gfirst.scatter_reduce_(
        0, flat, torch.where(alive, iar_k, K), "amin").reshape(SMAX, NK)
    kpop = _popcount(arange32(NK, dev), DS)
    z = gsum * kpop[None, :]
    ztie = z == z.amax(dim=1, keepdim=True)
    bestfirst = torch.where(ztie, gfirst, K).amin(dim=1, keepdim=True)
    bestkey = torch.argmax((ztie & (gfirst == bestfirst)).to(torch.uint8),
                           dim=1).to(I32)
    keep = alive & torch.where(take(anyfull, segc), isfull,
                               ckey == take(bestkey, segc))
    table = torch.cat(
        [torch.where(keep, cseg, BIG)[:, None], table[:, 1:]], 1)
    (table,) = sort_by((table[:, C_SEG],), (table,))
    return table, keep.sum(dtype=I32)


# ----------------------------------------------------------------------
# trim_overlap over one window coordinate (devloop.py:2073-2170)
# ----------------------------------------------------------------------
def _comb_step(x, y):
    (t1, a1, b1), (t2, a2, b2) = x, y
    return t1, torch.where(a1 >= t2, b2, a2), torch.where(b1 >= t2, b2, a2)


def _comb_cl(x, y):
    (a1, b1), (a2, b2) = x, y
    return (a1 + a2).clamp(max=A30), torch.maximum(b1 - a2, b2)


def trim_dim_multi(table, j, D):
    """Containment drop + overlap trim (schemes.py:161-191) along the
    j-th window coordinate of every candidate (its path from nibble j of
    ``ordp``); every path position shifts by the trimmed front.  A
    candidate with fewer than j + 1 coordinates is inert: its position
    is its row and its effective length 0.  Returns (table, rows alive
    after the containment drop)."""
    K = table.shape[0]
    dev = table.device
    iar = arange32(K, dev)
    cseg, cl, cord, cw = (table[:, c] for c in (C_SEG, C_L, C_ORD, C_W))
    sid_j = (cord >> (4 * j)) & 15
    posd = torch.where(
        sid_j < D,
        table[:, C_P:C_P + D].gather(
            1, sid_j.clamp(max=D - 1).long()[:, None])[:, 0],
        0,
    )
    has = (j < cw) & (posd >= 0)
    pos = torch.where(has, posd, iar)
    leff = torch.where(has, cl, 0)
    ext = torch.cat([table, pos[:, None], leff[:, None]], 1)
    (ext,) = sort_by(
        (cseg, torch.where(cseg < BIG, pos, BIG), -cl), (ext,)
    )
    seg_s, pos_s, le_s = ext[:, C_SEG], ext[:, -2], ext[:, -1]
    alive = seg_s < BIG
    end = torch.where(alive, pos_s + le_s, BIG)
    first = seg_s != shift1(seg_s, -9)
    last = seg_s != shift_left(seg_s, -9)
    end_prev = shift1(end, 0)
    end_next = shift_left(end, 0)
    last_end_rev = last_value_scan(
        torch.flip(torch.where(last, end, 0), (0,)), torch.flip(last, (0,))
    )
    seg_last_end = torch.flip(last_end_rev, (0,))
    keep_first = (~last & (end_next > end)) | (seg_last_end < end)
    keep = alive & torch.where(first, keep_first | last, end_prev < end)
    seg_k = torch.where(keep, seg_s, BIG)
    ext = torch.cat([seg_k[:, None], ext[:, 1:]], 1)
    (ext,) = sort_by((seg_k,), (ext,))
    seg_c, l_c = ext[:, C_SEG], ext[:, C_L]
    pos_c, le_c = ext[:, -2], ext[:, -1]
    alive = seg_c < BIG
    n_alive = alive.sum(dtype=I32)
    first = (seg_c != shift1(seg_c, -9)) & alive

    # scan 1: incoming cur_end, a 2-piece step function per row
    pl = pos_c + le_c
    T0 = torch.where(first | ~alive, -1, pl)
    Av = torch.where(alive, pl, 0)
    Bv = torch.where(first, pl, torch.where(alive, pos_c, 0))
    Tc, Ac, Bc = associative_scan(
        _comb_step, (shift1(T0, -1), shift1(Av, 0), shift1(Bv, 0))
    )
    ce_in = torch.where(Tc <= 0, Bc, Ac)
    ov = torch.where(first, 0, ce_in - pos_c)
    hit = alive & ~first & (ov > 0)
    ovh = torch.where(hit, ov, 0)
    li = l_c - ovh
    front = torch.where(hit, ovh, 0)
    # scan 2: incoming cur_len, clamped-subtract maps max(cl - a, b)
    deep = hit & (li <= 0)
    a_r = torch.where(deep, ovh, A30)
    b_r = torch.where(
        alive, torch.where(deep, 0, torch.where(hit, li, l_c)), 0
    )
    ac, bc = associative_scan(_comb_cl, (shift1(a_r, A30), shift1(b_r, 0)))
    prev_alive = (torch.maximum(-ac, bc) - ovh) > 0
    # scan 3: incoming cur_idx (last reset value); K is a scratch row
    reset = (~deep) | (deep & ~prev_alive)
    rval = torch.where(~deep, iar, K)
    ci_in = last_value_scan(shift1(rval, K), shift1(reset, True))
    back = torch.zeros(K + 1, dtype=I32, device=dev).index_add_(
        0, torch.where(hit, ci_in, K), ovh
    )[:K]
    newl = l_c - front - back
    P = ext[:, C_P:C_P + D]
    P = torch.where(P >= 0, P + front[:, None], P)
    out = torch.cat([
        torch.where((seg_c < BIG) & (newl > 0), seg_c, BIG)[:, None],
        newl[:, None], ext[:, C_KEY:C_P], P,
    ], 1)
    return out, n_alive


def same_paths(table, SMAX):
    """The relmums same-keys subset (schemes.py:249): a segment keeps
    only the candidates with the path set of its last candidate in (n,
    l) order, i.e. of its longest, ties to the latest row.  Returns
    (table, segkey) with segkey the kept path set of each segment."""
    K = table.shape[0]
    dev = table.device
    iar = arange32(K, dev)
    cseg, cl, cpm = table[:, C_SEG], table[:, C_L], table[:, C_PM]
    alive = cseg < BIG
    segc = cseg.clamp(0, SMAX - 1)
    maxl = torch.full((SMAX,), -1, dtype=I32, device=dev).scatter_reduce_(
        0, segc.long(), torch.where(alive, cl, -1), "amax")
    ismax = alive & (cl == take(maxl, segc))
    best_row = torch.full((SMAX,), -1, dtype=I32, device=dev).scatter_reduce_(
        0, segc.long(), torch.where(ismax, iar, -1), "amax")
    segkey = torch.where(best_row >= 0,
                         take(cpm, best_row.clamp(0, K - 1)), 0)
    keep = alive & (cpm == take(segkey, segc))
    table = torch.cat([torch.where(keep, cseg, BIG)[:, None], table[:, 1:]],
                      1)
    (table,) = sort_by((table[:, C_SEG],), (table,))
    return table, segkey


# ----------------------------------------------------------------------
# dense chain + pick for D dims (devloop.py:2759-3048)
# ----------------------------------------------------------------------
def chain_dense_multi(table, seg_tab, nseg, segkey, maxcnt, abort, ws, wp,
                      CW, D, reads):
    """Sparse chaining DP (schemes.py:20-104, sum-of-pairs gap cost over
    each segment's path set) and the ``largest`` pick for every live
    segment at once, on dense (live segments, columns) planes: a
    segment's candidates in reference-path order along its row, the
    pseudo column (the right boundary) after the widest segment's last.
    ``maxcnt`` is the most candidates of one segment (read before).
    Returns (picked, s_l, s_ord, s_P, abort, rounds) over all SMAX
    segments, rounds = column steps of the score pass."""
    K = table.shape[0]
    SMAX = seg_tab.shape[0]
    dev = table.device
    R = nseg
    W = min(maxcnt, CW)          # real columns; the pseudo column is W
    W1 = W + 1
    iar = arange32(K, dev)
    cols = arange32(W1, dev)
    darange = arange32(D, dev)

    # ref axis = lowest set bit of the segment's path set
    bits = ((segkey[:, None] >> darange[None, :]) & 1) > 0
    refdim = torch.where(bits.any(1), torch.argmax(bits.to(torch.uint8), 1),
                         0).to(I32)
    cseg = table[:, C_SEG]
    alive0 = cseg < BIG
    segc = cseg.clamp(0, SMAX - 1)
    refpos = table[:, C_P:C_P + D].gather(
        1, take(refdim, segc).long()[:, None])[:, 0]
    ext = torch.cat([table, refpos[:, None]], 1)
    (ext,) = sort_by((cseg, torch.where(alive0, refpos, BIG)), (ext,))
    cseg, refpos = ext[:, C_SEG], ext[:, -1]
    alive = cseg < BIG
    dup = ((cseg[1:] == cseg[:-1]) & (refpos[1:] == refpos[:-1])
           & (cseg[1:] < BIG))
    abort = torch.where(dup.any(), ABORT_DUP_REF, abort)
    first = (cseg != shift1(cseg, -9)) & alive
    firstpos = last_value_scan(torch.where(first, iar, 0), first)
    rank = torch.where(alive, iar - firstpos, 0)
    abort = torch.where((alive & (rank >= CW)).any(), ABORT_SEG_WIDTH, abort)

    picked = torch.zeros(SMAX, dtype=torch.bool, device=dev)
    s_l = torch.zeros(SMAX, dtype=I32, device=dev)
    s_ord = torch.zeros(SMAX, dtype=I32, device=dev)
    s_P = torch.full((SMAX, D), -1, dtype=I32, device=dev)
    if R == 0:
        return picked, s_l, s_ord, s_P, abort, 0

    # scatter the candidates into (R, W1) planes; dead rows to spill
    # slots, so the scatter stays unique-indexed
    didx = torch.where(
        alive, cseg.clamp(0, R - 1) * W1 + rank.clamp(max=W - 1),
        R * W1 + iar,
    ).long()
    vals = torch.cat([ext[:, C_L:C_L + 1], ext[:, C_ORD:C_ORD + 1],
                      alive.to(I32)[:, None], ext[:, C_P:C_P + D]], 1)
    planes = torch.zeros((R * W1 + K, 3 + D), dtype=I32, device=dev)
    planes.index_copy_(0, didx, vals)
    planes = planes[:R * W1].reshape(R, W1, 3 + D).permute(2, 0, 1)
    dL, dOrd = planes[0].contiguous(), planes[1].contiguous()
    dPs = planes[3:].contiguous()                      # (D, R, W1)
    pbeg = seg_tab[:R, 2:2 + D].t()                    # (D, R)
    pend = seg_tab[:R, 2 + D:2 + 2 * D].t()
    haveD = (((segkey[:R][None, :] >> darange[:, None]) & 1) > 0) & (pbeg >= 0)
    dPs[:, :, W] = torch.where(haveD, pend, 0)
    dalb = planes[2] > 0
    dalb[:, W] = True                                  # every row is live
    hv = dalb[None] & haveD[:, :, None]
    dS = torch.where(hv, dPs, 0)
    dE = torch.where(hv, dPs + torch.where(cols < W, dL, 0)[None], 0)
    candb = dalb & (cols[None, :] < W)
    candcnt = candb.sum(dim=1, dtype=I32)
    wseg = haveD.sum(dim=0, dtype=I32)
    cpair = (wseg * (wseg - 1)) // 2
    dmul = ws * dL * cpair[:, None]
    pairs = pair_index(D, dev)
    hbp = haveD[pairs[0]] & haveD[pairs[1]]            # (NPAIR, R)
    # left-pseudo link weight
    penl = pair_pen(dS - (pbeg - 1)[:, :, None], pairs, hbp)
    dwl = torch.where(dalb, dmul - wp * penl, NEG)

    def chunks(per_col):
        step = max(1, _CHUNK_ELEMS // max(1, per_col))
        return [(c0, min(c0 + step, W1)) for c0 in range(0, W1, step)]

    # act: min dominating column (the pseudo always dominates)
    act_parts = []
    for c0, ce in chunks(D * R * W1):
        dom = dalb[:, None, :] & (
            dS[:, :, c0:ce, None] >= dE[:, :, None, :]).all(0)
        act_parts.append(torch.where(dom, cols, BIG).amin(dim=2))
    dact = torch.cat(act_parts, dim=1)

    # scores: one sequential pass over the candidate columns (one kernel
    # launch on the card)
    score = chain_score.chain_scores(dS, dE, dalb, dL, dwl, ws * cpair, hbp,
                                     pairs, wp, W)
    rounds = W

    # links: exact winner reconstruction, lex key (tmpw, score_j,
    # -act_j, -col_j); the left pseudo wins per the reference's
    # traversal order (schemes.py:64-87)
    link_parts = []
    npair = int(hbp.shape[0])
    for c0, ce in chunks((D + npair + 8) * R * W1):
        delta = dS[:, :, c0:ce, None] - dE[:, :, None, :]    # (D, R, c, W1)
        compat = (
            dalb[:, None, :] & (cols[None, None, :] < cols[c0:ce, None])
            & (delta >= 0).all(0)
        )
        tw = torch.where(compat,
                         score[:, None, :] - wp * pair_pen(delta, pairs, hbp),
                         NEG)
        mx = tw.amax(dim=2)
        t1 = tw == mx[:, :, None]
        sc2 = torch.where(t1, score[:, None, :], NEG)
        mx2 = sc2.amax(dim=2)
        t2 = t1 & (sc2 == mx2[:, :, None])
        a3 = torch.where(t2, dact[:, None, :], BIG)
        t3 = t2 & (a3 == a3.amin(dim=2)[:, :, None])
        brow = torch.argmax(t3.to(torch.uint8), dim=2).to(I32)
        wl_b = dwl[:, c0:ce]
        mxg = mx + dmul[:, c0:ce]
        use_left = (mx <= NEG) | (wl_b > mxg) | ((wl_b == mxg) & (mx2 <= 0))
        link_parts.append(torch.where(use_left, -1, brow))
    dlink = torch.where(dalb, torch.cat(link_parts, dim=1), -2)

    # backtrack + largest (schemes.py:298-317): pointer doubling along
    # link chains, sentinel column W1
    def pad(x, fill):
        return torch.cat(
            [x, torch.full((R, 1), fill, dtype=I32, device=dev)], dim=1)

    def gsel(x, idx):  # y[s, i] = x[s, idx[s, i]]
        return torch.gather(x, 1, idx.long())

    nxt = pad(torch.where(dlink >= 0, dlink, W1), W1)
    bl = pad(torch.where(candb, dL, -1), -1)
    bs = pad(cols[None, :].expand(R, W1), -1)
    while reads((nxt[:, :W1] != W1).any()):
        bl2 = gsel(bl, nxt)
        bs2 = gsel(bs, nxt)
        take_far = bl2 > bl
        bl = torch.where(take_far, bl2, bl)
        bs = torch.where(take_far, bs2, bs)
        nxt = gsel(nxt, nxt)
    ptr0 = dlink[:, W]
    ptr0c = ptr0.clamp(0, W1)[:, None]
    blp = torch.where(ptr0 >= 0, gsel(bl, ptr0c)[:, 0], -1)
    bs_seg = torch.where((ptr0 >= 0) & (blp > -1), gsel(bs, ptr0c)[:, 0], -1)
    # single-candidate segments bypass the chain (picker __call__)
    bs_seg = torch.where(candcnt == 1, 0, bs_seg)
    pk = bs_seg >= 0
    bsc = bs_seg.clamp(0, W)[:, None]
    picked[:R] = pk
    s_l[:R] = torch.where(pk, gsel(dL, bsc)[:, 0], 0)
    s_ord[:R] = torch.where(pk, gsel(dOrd, bsc)[:, 0], 0)
    sp = torch.gather(dPs, 2, bsc[None].expand(D, R, 1).long())[:, :, 0]
    s_P[:R] = torch.where(pk[None] & haveD, sp, -1).t()
    return picked, s_l, s_ord, s_P, abort, rounds


# ----------------------------------------------------------------------
# anchor log and children (devloop.py:2424-2553)
# ----------------------------------------------------------------------
def log_anchors_multi(anchors, acount, picked, s_l, s_ord, s_P, seg_tab,
                      abort):
    """Append one record (l, w, parent, cls, ordp, pos.., beg.., end..)
    per picked segment.  Returns (anchors, lslot, npicked, abort); row
    ACAP of ``anchors`` is the spill row."""
    ACAP = anchors.shape[0] - 1
    D = s_P.shape[1]
    npicked = picked.sum(dtype=I32)
    abort = torch.where(acount + npicked > ACAP, ABORT_ANCHOR_OVERFLOW, abort)
    prank = cumsum32(picked) - 1
    lslot = torch.where(picked, (acount + prank).clamp(max=ACAP), ACAP)
    s_w = (s_P >= 0).sum(dim=1, dtype=I32)
    rows = torch.cat([s_l[:, None], s_w[:, None], seg_tab[:, 0:2],
                      s_ord[:, None], s_P, seg_tab[:, 2:2 + 2 * D]], 1)
    # non-picked rows all write the spill row's own value back
    anchors = anchors.index_put(
        (lslot.long(),),
        torch.where(picked[:, None], rows, take(anchors, lslot)),
    )
    return anchors, lslot, npicked, abort


def children_multi(picked, s_l, s_P, seg_tab, lslot, sop, abort):
    """Leading, trailing and parallel children of every picked anchor:
    the next level's seg_tab (leads in parent order, then trails, then
    parallels) and live-sample keys.  A child lives when it spans at
    least two samples.  Returns (new_tab, new_live_key, nseg_new,
    lead_id, trail_id, par_id, abort); dead children have id SMAX."""
    SMAX = seg_tab.shape[0]
    D = s_P.shape[1]
    DS = max(sop) + 1
    dev = seg_tab.device
    pbeg = seg_tab[:, 2:2 + D]
    pend = seg_tab[:, 2 + D:2 + 2 * D]
    insub = s_P >= 0
    lb = s_P > pbeg
    tb = s_P + s_l[:, None] < pend
    pb = ~insub & (pbeg >= 0)
    ivs = (
        (torch.where(insub & lb, pbeg, -1), torch.where(insub & lb, s_P, -1)),
        (torch.where(insub & tb, s_P + s_l[:, None], -1),
         torch.where(insub & tb, pend, -1)),
        (torch.where(pb, pbeg, -1), torch.where(pb, pend, -1)),
    )
    keys = []
    for ivb, _ive in ivs:
        k = torch.zeros(SMAX, dtype=I32, device=dev)
        for d in range(D):
            k = k | ((ivb[:, d] >= 0).to(I32) << sop[d])
        keys.append(k)
    lives = [picked & (_popcount(k, DS) >= 2) for k in keys]
    counts = [cumsum32(lv) for lv in lives]
    base = 0
    ids = []
    for lv, c in zip(lives, counts):
        ids.append(torch.where(lv, base + c - 1, SMAX).clamp(max=SMAX))
        base = base + c[-1]
    nseg_new = base
    abort = torch.where(nseg_new > SMAX, ABORT_SEG_OVERFLOW, abort)
    ones = torch.ones((SMAX, 1), dtype=I32, device=dev)
    none = torch.full((SMAX, D), -1, dtype=I32, device=dev)
    ancs = (torch.where(insub, s_P, -1), none, none)
    # rows: parent, cls, beg.., end.., anc.., live key; dead children go
    # to their own spill rows past SMAX
    new_tab = torch.zeros((4 * SMAX, 3 + 3 * D), dtype=I32, device=dev)
    spill = arange32(SMAX, dev)
    for k, (cls, (ivb, ive), anc) in enumerate(zip((1, 2, 4), ivs, ancs)):
        row = torch.cat([lslot[:, None], cls * ones, ivb, ive, anc,
                         keys[k][:, None]], 1)
        tgt = torch.where(ids[k] < SMAX, ids[k], (k + 1) * SMAX + spill)
        new_tab.index_copy_(0, tgt.long(), row)
    lead_id, trail_id, par_id = ids
    return (new_tab[:SMAX, :2 + 3 * D], new_tab[:SMAX, 2 + 3 * D], nseg_new,
            lead_id, trail_id, par_id, abort)


# ----------------------------------------------------------------------
# classify + split + lowercase, 3-way stable partition
# (devloop.py:2554-2703)
# ----------------------------------------------------------------------
def split_multi(T, SA, LCP, BWT, SOA, SEG, picked, s_l, s_P, seg_tab,
                lead_id, trail_id, par_id):
    """Classify every slot against its segment's anchor in its own path
    (leading, trailing, matched, or parallel where the anchor lacks its
    path; a slot outside its path's live interval dies), compute the
    child LCP (per-class segmented running min), lowercase the matched
    BWT entries and text, and apply the stable partition by new segment
    id.  Returns (T, SA, LCP, BWT, SOA, SEG) of the next level's layout
    (before repair)."""
    npad = SA.shape[0]
    ntext = T.shape[0]
    SMAX = seg_tab.shape[0]
    D = s_P.shape[1]
    dev = SA.device
    iar_n = arange32(npad, dev)
    # segment starts of this level's layout (the JAX kernel leaves
    # segstart undefined here; the pairwise kernel's definition)
    segstart = SEG != shift1(SEG, -9)
    btab = torch.cat([
        torch.stack([picked.to(I32), s_l, lead_id, trail_id, par_id], 1),
        s_P, seg_tab[:, 2:2 + 2 * D],
    ], 1)
    brows = take(btab, SEG.clamp(0, SMAX - 1))
    pos = SA
    pickedb = brows[:, 0] > 0
    pl = brows[:, 1]
    b_lid, b_tid, b_pid = brows[:, 2], brows[:, 3], brows[:, 4]
    ancs = brows[:, 5:5 + D]
    # per-slot own-path anchor and interval bounds (slots outside their
    # path's live interval get no class and die, reveal.c:1117)
    own = torch.stack([ancs, brows[:, 5 + D:5 + 2 * D],
                       brows[:, 5 + 2 * D:5 + 3 * D]], 0)
    inpath = (SOA >= 0) & (SOA < D)
    own = torch.where(
        inpath[None],
        own.gather(2, SOA.clamp(0, D - 1).long()[None, :, None]
                   .expand(3, npad, 1))[:, :, 0],
        -1,
    )
    anc_own, beg_own, end_own = own[0], own[1], own[2]
    live_parent = (SEG >= 0) & pickedb
    inown = (beg_own >= 0) & (pos >= beg_own) & (pos < end_own)
    has_anchor = (anc_own >= 0) & inown
    in_lead = has_anchor & (pos < anc_own)
    in_trail = has_anchor & (pos >= anc_own + pl)
    in_match = has_anchor & ~in_lead & ~in_trail
    in_par = (anc_own < 0) & inown
    nsg = torch.full((npad,), -1, dtype=I32, device=dev)
    for sel, bid in ((in_lead, b_lid), (in_trail, b_tid), (in_par, b_pid)):
        nsg = torch.where(live_parent & sel & (bid < SMAX),
                          bid.clamp(max=SMAX - 1), nsg)
    cls = torch.where(live_parent & in_lead, 1, 0)
    cls = torch.where(live_parent & in_trail, 2, cls)
    cls = torch.where(live_parent & in_par, 4, cls)
    cls = torch.where(nsg < 0, 0, cls)

    # child LCP: one running-min scan of three columns, each restarted
    # at segment starts and after a slot of its class
    cls_prev = shift1(cls, 0)
    resets = torch.stack([segstart | (cls_prev == c) for c in (1, 2, 4)], 1)
    mm = seg_min_scan(LCP[:, None].expand(npad, 3), resets)
    newlcp = torch.where(
        cls == 1, mm[:, 0],
        torch.where(cls == 2, mm[:, 1], torch.where(cls == 4, mm[:, 2], 0)),
    )

    # 3-way stable partition: leads, then trails, then parallels
    ld = (nsg >= 0) & (cls == 1)
    tr = (nsg >= 0) & (cls == 2)
    pr = (nsg >= 0) & (cls == 4)
    egs = [cumsum32(m) - m.to(I32) for m in (ld, tr, pr)]
    nlead_tot = egs[0][-1] + ld[-1].to(I32)
    ntrail_tot = egs[1][-1] + tr[-1].to(I32)
    newpos = torch.where(
        ld, egs[0],
        torch.where(tr, nlead_tot + egs[1],
                    torch.where(pr, nlead_tot + ntrail_tot + egs[2], npad)),
    )
    # lowercase BWT entries whose text pos-1 is in this level's matched
    # regions of the slot's own parent
    pm1 = (pos - 1)[:, None]
    bwt_m = ((ancs >= 0) & (pm1 >= ancs) & (pm1 < ancs + pl[:, None])).any(1)
    bwt_up = (BWT >= ord("A")) & (BWT <= ord("Z"))
    BWT = torch.where(live_parent & bwt_m & bwt_up, BWT + 32, BWT)
    # one inverse-permutation scatter + one packed gather
    invp = scatter_drop(torch.full((npad,), npad, dtype=I32, device=dev),
                        newpos, iar_n)
    pvalid = invp < npad
    packed = torch.stack([BWT, SA, SOA, newlcp, nsg.clamp(0, SMAX)], dim=1)
    rows2 = take(packed, invp.clamp(max=npad - 1))
    BWT_n = torch.where(pvalid, rows2[:, 0], 0)
    SA_n = torch.where(pvalid, rows2[:, 1], 0)
    SOA_n = torch.where(pvalid, rows2[:, 2], 0)
    lcp_p = torch.where(pvalid, rows2[:, 3], 0)
    segk = torch.where(pvalid, rows2[:, 4], SMAX)
    SEG_n = torch.where(segk >= SMAX, -1, segk)
    firstslot = SEG_n != shift1(SEG_n, -9)
    LCP_n = torch.where(firstslot | (SEG_n < 0), 0, lcp_p)

    # lowercase matched text
    upmask = scatter_drop(
        torch.zeros(ntext, dtype=torch.bool, device=dev),
        torch.where(live_parent & in_match, pos, ntext), True,
    )
    isup = (T >= ord("A")) & (T <= ord("Z"))
    T = torch.where(upmask & isup, T + 32, T)
    return T, SA_n, LCP_n, BWT_n, SOA_n, SEG_n


# ----------------------------------------------------------------------
# boundary repair, one pass a path dimension (devloop.py:3055-3304)
# ----------------------------------------------------------------------
def repair_pass_multi(SA, LCP, BWT, SOA, SEG, beg, CCAP, SMAX, abort,
                      rstats, reads):
    """Repair the suffixes of leading children that cross their begin
    ``beg`` in one path (beg < 0 elsewhere): batched rounds whose
    insertion points come from ``window_resolve.window_resolve`` (the
    CUDA kernel on the card, its plain version on the CPU), SOA moving
    with SA and BWT, the host reads counted in ``reads``.  Returns (SA,
    LCP, BWT, SOA, abort, rounds)."""
    cq, centry_next, rc, abort = repair_queue(SA, LCP, beg >= 0, beg, CCAP,
                                              abort)
    SA, LCP, (BWT, SOA), rounds = repair_rounds(
        SA, LCP, (BWT, SOA), SEG, beg, cq, centry_next, rc, SMAX, rstats,
        wr.window_resolve, reads,
    )
    return SA, LCP, BWT, SOA, abort, rounds


# ----------------------------------------------------------------------
# the level loop (devloop.py:2170-2753)
# ----------------------------------------------------------------------
def multi_run(Tu8, SA, LCP, SOA, SEG, seg_tab, live_key, sop, minl, minn,
              maxmums, ws, wp, caps: Caps, level_cap=_LMAX):
    """Run the whole multi-genome recursion from the root layout.

    ``Tu8``: (ntext,) uint8 text; ``SA``/``LCP``/``SOA``/``SEG``: (npad,)
    int32 slots; ``seg_tab``: (SMAX, 2 + 3D) int32 rows parent cls
    beg.. end.. anc..; ``live_key``: (SMAX,) live-sample bitmask per
    segment; ``sop``: sample id of each path.  ``level_cap`` stops the
    loop early (a debugging aid: the state after that many levels).
    Returns a dict: T (uint8), anchors (ACAP + 1, 5 + 3D), acount,
    abort, level, steps [trim rows, chain column steps, repair rounds],
    repair_passes, rstats [applied, longest run, moved slots], syncs,
    and the final SA, LCP, BWT, SOA, SEG."""
    dev = SA.device
    D = len(sop)
    DS = max(sop) + 1
    T = Tu8.to(I32)
    BWT = take(T, (SA - 1).clamp(min=0))
    anchors = torch.zeros((caps.ACAP + 1, 5 + 3 * D), dtype=I32, device=dev)
    acount = torch.zeros((), dtype=I32, device=dev)
    abort = torch.zeros((), dtype=I32, device=dev)
    trim_rows = torch.zeros((), dtype=I32, device=dev)
    chain_steps = repair_steps = passes = 0
    rstats = torch.zeros(3, dtype=torch.int64, device=dev)
    reads = HostReads()
    nseg = 1
    level = 0
    while nseg > 0 and level < level_cap:
        with trace.span("multi.enumerate"):
            table, abort = enumerate_multi(
                SA, LCP, BWT, SOA, SEG, sop, minl, minn, maxmums, caps.K,
                caps.SMAX, abort,
            )
        with trace.span("multi.trim"):
            table, kept = select_subsets(table, live_key, DS)
            trim_rows = trim_rows + kept
            for j in range(D):
                table, na = trim_dim_multi(table, j, D)
                trim_rows = trim_rows + na
            table, segkey = same_paths(table, caps.SMAX)
            cseg = table[:, C_SEG]
            segcnt = torch.zeros(caps.SMAX, dtype=I32,
                                 device=dev).index_add_(
                0, cseg.clamp(0, caps.SMAX - 1), (cseg < BIG).to(I32))
            maxcnt, abort_now = reads(torch.stack([segcnt.max(), abort]))
        if abort_now == ABORT_MAXMUMS:
            # final for this input at any capacity: stop here
            level += 1
            break
        with trace.span("multi.chain"):
            picked, s_l, s_ord, s_P, abort, rounds = chain_dense_multi(
                table, seg_tab, nseg, segkey, maxcnt, abort, ws, wp, caps.CW,
                D, reads,
            )
            chain_steps += rounds
        with trace.span("multi.split"):
            anchors, lslot, npicked, abort = log_anchors_multi(
                anchors, acount, picked, s_l, s_ord, s_P, seg_tab, abort,
            )
            (new_tab, new_live_key, nseg_new, lead_id, trail_id, par_id,
             abort) = children_multi(picked, s_l, s_P, seg_tab, lslot, sop,
                                     abort)
            T, SA, LCP, BWT, SOA, SEG = split_multi(
                T, SA, LCP, BWT, SOA, SEG, picked, s_l, s_P, seg_tab,
                lead_id, trail_id, par_id,
            )
        with trace.span("multi.repair"):
            # one pass a path: begins of leading children (their parent's
            # anchor in that path)
            brows = take(torch.cat([new_tab[:, 1:2], new_tab[:, 2 + 2 * D:]],
                                   1), SEG.clamp(0, caps.SMAX - 1))
            is_lead = (SEG >= 0) & (brows[:, 0] == 1)
            for d in range(D):
                beg = torch.where(is_lead, brows[:, 1 + d], -1)
                SA, LCP, BWT, SOA, abort, r = repair_pass_multi(
                    SA, LCP, BWT, SOA, SEG, beg, caps.CCAP, caps.SMAX, abort,
                    rstats, reads,
                )
                repair_steps += r
                passes += int(r > 0)
        acount = (acount + npicked).clamp(max=caps.ACAP)
        seg_tab = new_tab
        live_key = new_live_key
        level += 1
        nseg, abort_now = reads(torch.stack([nseg_new, abort]))
        if abort_now:
            break
    abort, acount, trim_rows = reads(torch.stack([abort, acount,
                                                  trim_rows]))
    if abort == 0 and level >= _LMAX:
        abort = ABORT_LEVEL_OVERFLOW
    return dict(
        T=T.to(torch.uint8), anchors=anchors, acount=acount, abort=abort,
        level=level, steps=[trim_rows, chain_steps, repair_steps],
        repair_passes=passes, rstats=reads(rstats), syncs=reads.n,
        SA=SA, LCP=LCP, BWT=BWT, SOA=SOA, SEG=SEG,
    )


# ----------------------------------------------------------------------
# host side (devloop.py:3307-3468)
# ----------------------------------------------------------------------
def forest_pop_order_multi(parents: np.ndarray, cls: np.ndarray):
    """Serial LIFO pop order for multi anchors: push order parallel/
    leading/trailing per step (reveal.c:1295-1324) with pop from the
    end => preorder walk with child order trailing, leading, parallel.
    Roots carry parent < 0 (-1 full-root, -2-did deferred forest);
    returns {root_key: order array} with root_key = -1 or defer id."""
    A = len(parents)
    lead = np.full(A, -1, np.int64)
    trail = np.full(A, -1, np.int64)
    par = np.full(A, -1, np.int64)
    roots = {}
    for i in range(A):
        p, c = int(parents[i]), int(cls[i])
        if p < 0:
            roots[-1 if p == -1 else -2 - p] = i
        elif c == 1:
            lead[p] = i
        elif c == 2:
            trail[p] = i
        else:
            par[p] = i
    out = {}
    for key, root in roots.items():
        order = []
        stack = [root]
        while stack:
            t = stack.pop()
            order.append(t)
            # push par, lead, trail -> pop trail first
            if par[t] >= 0:
                stack.append(int(par[t]))
            if lead[t] >= 0:
                stack.append(int(lead[t]))
            if trail[t] >= 0:
                stack.append(int(trail[t]))
        out[key] = np.asarray(order, np.int64)
    return out


def root_caps(npad, root_mums):
    """Capacities of a first dispatch: K and CW from the root's
    multiMUM count, CCAP from the slots (multi repair passes see far
    more crossing suffixes than pairwise ones)."""
    return Caps(
        K=_next_pow2(max(2048, 4 * root_mums)),
        # the JAX kernel starts at 512; here the chain's planes are sized
        # by the live segments, so room for more costs little, and an
        # overflow would rerun every level
        SMAX=4096,
        ACAP=max(4096, npad // 64),
        CCAP=max(4096, npad // 16),
        CW=_next_pow2(max(64, root_mums)),
    )


def rem_device_multi(T, SA, LCP, path_ivs, path_samples, minlength, minn,
                     maxmums, wscore=1, wpen=1, root_mums=256, *, device):
    """Run the whole multi-genome recursion on ``device``.

    ``path_ivs``: [(beg, end), ...] one text interval per contig path
    (dimension); ``path_samples``: the sample id of each path.  A
    retryable capacity abort re-runs with that capacity doubled.
    Returns (anchors, T_out, levels) with anchors int64 (A, 5 + 3D) in
    serial pop order, or None on a non-retryable abort, a text of 2^30
    bytes or more, or anchors whose pop order does not cover the log
    (the caller declines the input).  Fills ``LAST_STATS``."""
    device = torch.device(device)
    t_start = time.perf_counter()
    LAST_STATS.clear()
    n = len(SA)
    D = len(path_ivs)
    sop = [int(s) for s in path_samples]
    if n >= 2**30 or minlength < 1 or max(sop) + 1 < 2 or D > 8:
        return None
    npad = _next_pow2(n)
    ntext = _next_pow2(len(T))
    caps = root_caps(npad, root_mums)
    T_p = np.zeros(ntext, dtype=np.uint8)
    T_p[:len(T)] = np.asarray(T, dtype=np.uint8)
    SA_p = np.full(npad, n - 1, dtype=np.int32)
    SA_p[:n] = np.asarray(SA, dtype=np.int32)
    LCP_p = np.zeros(npad, dtype=np.int32)
    LCP_p[:n] = np.asarray(LCP, dtype=np.int32)
    SEG_p = np.full(npad, -1, dtype=np.int32)
    SEG_p[:n] = 0
    # path id per text position -> per slot
    pof = np.zeros(len(T) + 1, dtype=np.int32)
    for pid, (b, e) in enumerate(path_ivs):
        pof[b:e] = pid
    SOA_p = np.zeros(npad, dtype=np.int32)
    SOA_p[:n] = pof[np.minimum(SA_p[:n], len(T))]
    begs = np.full(D, -1, np.int32)
    ends = np.full(D, -1, np.int32)
    key0 = 0
    for pid, (b, e) in enumerate(path_ivs):
        if e > b:
            begs[pid] = b
            ends[pid] = e
            key0 |= 1 << sop[pid]

    def dev_tensor(a):
        return torch.from_numpy(a).to(device)

    dispatches = repair_total = syncs = 0
    launches0 = wr.LAUNCHES
    for _attempt in range(6):
        chain_launches0 = chain_score.LAUNCHES
        seg_tab = np.zeros((caps.SMAX, 2 + 3 * D), dtype=np.int32)
        seg_tab[0, 0] = -1            # root parent
        seg_tab[0, 2:2 + D] = begs
        seg_tab[0, 2 + D:2 + 2 * D] = ends
        seg_tab[0, 2 + 2 * D:] = -1
        live_key = np.zeros(caps.SMAX, dtype=np.int32)
        live_key[0] = key0
        out = multi_run(
            dev_tensor(T_p), dev_tensor(SA_p), dev_tensor(LCP_p),
            dev_tensor(SOA_p), dev_tensor(SEG_p), dev_tensor(seg_tab),
            dev_tensor(live_key), sop, int(minlength), int(minn),
            int(maxmums), int(wscore), int(wpen), caps,
        )
        dispatches += 1
        repair_total += out["steps"][2]
        syncs += out["syncs"]
        abort = out["abort"]
        if abort in _RETRYABLE:
            cap = _RETRYABLE[abort]
            setattr(caps, cap, 2 * getattr(caps, cap))
            log.info("device multi loop: %s overflow, retry %s=%d", cap, cap,
                     getattr(caps, cap))
            continue
        break

    acount = out["acount"]
    trim_steps, chain_steps, repair_steps = out["steps"]
    LAST_STATS.update(
        levels=out["level"], dispatches=dispatches, anchors=acount,
        abort=abort, trim_steps=trim_steps, chain_steps=chain_steps,
        repair_steps=repair_steps, repair_rounds_total=repair_total,
        repair_passes=out["repair_passes"],
        window_resolve_launches=wr.LAUNCHES - launches0,
        chain_score_launches=chain_score.LAUNCHES - chain_launches0,
        host_syncs=syncs,
        repair_applied=out["rstats"][0], repair_chain_max=out["rstats"][1],
        repair_moved_slots=out["rstats"][2], caps=vars(caps).copy(),
        paths=D, slots=n,
    )
    try:
        if abort:
            log.info("device multi loop aborted (code %d)", abort)
            return None
        anchors = out["anchors"][:acount].cpu().numpy().astype(np.int64)
        T_out = out["T"][:len(T)].cpu().numpy()
        if acount == 0:
            return np.zeros((0, 5 + 3 * D), np.int64), T_out, 0
        order = forest_pop_order_multi(anchors[:, 2], anchors[:, 3]).get(-1)
        if order is None or len(order) != acount:
            LAST_STATS["pop_order_mismatch"] = True
            log.info("device multi loop: pop order does not cover the log")
            return None
        return anchors[order], T_out, out["level"]
    finally:
        LAST_STATS["loop_seconds"] = time.perf_counter() - t_start
