"""Per-level device frontier of ``rem --frontier``, in torch.

Port of ``reveal_tpu/index/devfrontier.py`` (the single-device part).  The
recursion state (T, SA, LCP, per-slot segment id SEG, SO) lives on the
device across levels, padded to a power of two (dead tail: SEG = -1).
Each level runs two device stages, with the host picking anchors and
doing the graph surgery between them:

* ``enumerate_pairwise`` / ``enumerate_multi``: the candidate MUMs of
  every live segment at once.  Pairwise mode evaluates the reveal.c:119-180
  conditions elementwise (straddle, left-maximal, unique); multi mode
  derives LCP intervals by PSV/NSV pointer doubling and applies the
  ismultimum checks (distinct samples, some adjacent pair left-maximal,
  reveal.c:227-259) over interval rows of width ``max(2, nsamples)``.
* ``apply_level``: given the host's decisions as a disjoint interval table
  (begin, end, class) and a (segment x class) -> child map, classify every
  slot by ``searchsorted``, take each class's child LCP as a segmented
  running minimum over the parent layout (split(), reveal.c:582-664),
  partition stably by child id, lowercase the matched text and count, per
  child, the slots whose LCP crosses one of its new match begins (the
  bubble_sort trigger, reveal.c:666-727).

The boundary repairs of a level are fetched in one gather and one copy,
fixed by the native repair walk (``native.repair_leading_native``) child by
child, and written back in one copy and one scatter.

What the JAX module has that this one does not, and why: the K1/K2
capacity loops, ``_SPEC_PREFIX``, ``_fetch_bucket`` and
``_get_prefix_fetch`` serve XLA's static shapes over a remote device link;
``torch.nonzero`` gives the exact candidate count, so the candidates come
back in one copy.  ``_table_bucket`` pads the interval, match, repair-key
and segment tables to few shapes to bound compiles; torch compiles nothing,
and the padding rows (begins past the text, repair keys past every segment
id, seg-map rows of -1) never change a result, so the tables go as they
are.  The power-of-two repair windows bound compiles too; one flat gather
moves fewer bytes.

The mesh frontier (``DeviceFrontier(..., mesh=, nsep=)``, the reference's
``*_mesh`` functions) runs the same stages on one shard of the slots a
rank of a ``parallel/mesh.Mesh``, with the collectives of
``parallel/dsa.CollectiveKit``: ``enumerate_pairwise_mesh`` (halos of one
slot, the text probes by the sort-based gather), ``enumerate_multi_mesh``
and ``multi_windows_mesh`` (radius-W nearest-smaller-value scans over
W-wide halos, sample ids from the replicated sentinel table, window rows
by one all_reduce), ``apply_level_mesh`` (the running minima's
cross-shard carry from one all_gather, the partition as the kit's
network sort, counts by one all_reduce) and ``fetch_slots_mesh`` (the
repair rows by one all_reduce; each rank writes back its own slots).
The candidates come back in ascending global slot order by two
all_gathers (the ranks' counts, then their rows): a rank's ``nonzero``
is in slot order and the shards are in rank order, which gives the rows
the reference compacts by a network sort and fetches by a psum.  Every
rank gets the same candidates, counts and rows, and the host loop's
branches read only those, so every rank posts every collective in the
same order.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import trace
from ..core.encoding import N_BYTE, SENTINEL
from .devloop import (arange32, associative_scan, seg_min_scan, shift1,
                      shift_left, take)

log = logging.getLogger(__name__)

I64 = torch.int64

# the last run's counters (``_align_loop_frontier``): levels, anchor
# steps, apply calls, candidates returned by the enumeration, repair jobs,
# host syncs (the frontier's own copies between host and device and the
# count reads of ``nonzero``), the host seconds of each stage
# (enumerate_seconds, pick_seconds, apply_seconds, repair_seconds,
# order_seconds: the clocks of the spans frontier.enumerate,
# frontier.pick, frontier.apply, frontier.repair and frontier.order, the
# last the graph's snapshot before the loop and its replay in the serial
# order after it; they include the waits at the stage's own reads from
# the card and no others, and with tracing on ``trace.read`` times those
# waits), ``seconds`` (the whole frontier), and ``fallback``: why the frontier ran in place of the
# multi-genome loop (None when it was the route from the start); on a
# mesh also mesh_P, mesh_sh (slots a rank), mesh_padded (dead slots
# added), mesh_replicated (multi enumerations run whole on every rank)
# and the collectives this rank posted (p2p, sends, recvs, all_gathers,
# all_reduces, widest)
LAST_STATS = {}


def _next_pow2(x: int) -> int:
    return 1 << max(1, int(math.ceil(math.log2(max(x, 2)))))


# ---------------------------------------------------------------------------
# segment descriptor (host bookkeeping; no SA/LCP copies)
# ---------------------------------------------------------------------------

@dataclass
class SegDesc:
    """Host-side view of one live segment of the packed device arrays.

    Mirrors the reference RevealIndex recursion fields (reveal.h:17-40)
    minus the array slices, which stay on device; ``start``/``n`` locate
    the segment's contiguous slot range after the level sort."""

    sid: int
    start: int
    n: int
    depth: int
    nsamples: int
    nodes: set = field(default_factory=set)
    left_node: object = None
    right_node: object = None
    skipmums: list = field(default_factory=list)

    # the MumPicker reads idx.main.nsamples via ESAIndex; here the level
    # loop passes the global sample count separately: a compatible shim
    main = None


# ---------------------------------------------------------------------------
# device stages
# ---------------------------------------------------------------------------

def _left_max_test(a, b, ta, tb):
    """The left-maximality test of the pair of suffixes (a, b), given the
    bytes before them, ``ta`` = T[a - 1] and ``tb`` = T[b - 1]."""
    lower = (ta >= ord("a")) & (ta <= ord("z"))
    return ((a == 0) | (b == 0) | (ta != tb) | (ta == N_BYTE)
            | (ta == SENTINEL) | lower)


def _left_maximal(T, a, b):
    """The left-maximality test of the pair of suffixes (a, b)."""
    ta = take(T, (a - 1).clamp(min=0).reshape(-1)).reshape(a.shape)
    tb = take(T, (b - 1).clamp(min=0).reshape(-1)).reshape(b.shape)
    return _left_max_test(a, b, ta, tb)


def pair_mask(T, SA, LCP, nsep0: int, minl: int, SEG=None):
    """getmums_rem's conditions (reveal.c:119-180: straddle, left-maximal,
    unique, ``l >= minl > 0``) on every slot of the last axis, slot i
    pairing SA[..., i-1] with SA[..., i]: (mask, a, b), the pair's
    positions in order.  ``torch.roll`` wraps slot 0 onto the last slot
    as ``jnp.roll`` does; the ``i >= 1`` guard hides it.  With ``SEG``
    (per-slot segment ids, -1 = padding) both slots must lie in one
    segment; a read of the next slot's LCP across a segment's end sees
    that segment's LCP[0] == 0, as the per-segment scan does at its edge.
    The shared body of ``reveal_tpu``'s ``mum_mask`` (mums.py:366-413),
    ``packed_mum_mask`` (frontier.py:45-88) and ``_get_enum_pairwise``."""
    prev = torch.roll(SA, 1, -1)
    l = LCP
    straddle = (SA > nsep0) != (prev > nsep0)
    a = torch.minimum(SA, prev)
    b = torch.maximum(SA, prev)
    lcp_next = torch.cat([LCP[..., 1:], LCP.new_zeros(LCP.shape[:-1] + (1,))],
                         -1)
    unique = (torch.roll(LCP, 1, -1) < l) & (lcp_next < l)
    mask = (
        (arange32(SA.shape[-1], SA.device) >= 1)
        & (l >= minl)
        & (l > 0)
        & straddle
        & _left_maximal(T, a, b)
        & unique
    )
    if SEG is not None:
        mask &= (SEG >= 0) & (SEG == torch.roll(SEG, 1, -1))
    return mask, a, b


def enumerate_pairwise(T, SA, LCP, SEG, nsep0: int, minl: int):
    """Pairwise MUM candidates of every live segment (``_get_enum_pairwise``):
    (slots, l, a, b), int32, in ascending slot order."""
    mask, a, b = pair_mask(T, SA, LCP, nsep0, minl, SEG)
    slots = torch.nonzero(mask).squeeze(1)
    return slots.to(SA.dtype), take(LCP, slots), take(a, slots), take(b, slots)


def _pointer_doubling(LCP, start, stop, rounds):
    """Nearest smaller LCP value by pointer doubling: each pointer that has
    not reached ``stop`` jumps to its target's pointer while the target's
    LCP is not smaller, ``rounds`` times (all pointers at once)."""
    ptr = start
    for _ in range(rounds):
        valid = ptr != stop
        tgt = torch.where(valid, ptr, 0 if stop < 0 else stop - 1)
        jump = valid & (take(LCP, tgt) >= LCP)
        ptr = torch.where(jump, take(ptr, tgt), ptr)
    return ptr


def enumerate_multi(T, SA, LCP, SEG, SO, minl: int, minn: int,
                    nsamples_main: int, W: int):
    """MultiMUM candidates of every live segment (``_get_enum_multi``):
    (l, lb, ub, sa_rows, so_rows, ok) for every LCP interval that passes
    the length and width gates, in ascending slot order; ``sa_rows`` and
    ``so_rows`` are (count, W), and ``ok`` marks the rows of distinct
    samples with an adjacent left-maximal pair.  The pointer doubling
    takes ``ceil(log2(npad)) + 2`` rounds over the padded length, as the
    JAX kernel does (every segment's first slot has LCP 0, which stops
    any run of LCP >= 1 at its segment)."""
    n = SA.shape[0]
    dev = SA.device
    iar = arange32(n, dev)
    rounds = max(2, int(math.ceil(math.log2(max(n, 2)))) + 2)
    psv = _pointer_doubling(LCP, iar - 1, -1, rounds)
    nsv = _pointer_doubling(LCP, iar + 1, n, rounds)
    lb = psv.clamp(min=0)
    ub = nsv - 1
    width = ub - lb + 1
    cand = (
        (SEG >= 0)
        & (LCP >= max(minl, 1))
        & (width >= minn)
        & (width <= nsamples_main)
    )
    slots = torch.nonzero(cand).squeeze(1)
    lbs = take(lb, slots)
    ubs = take(ub, slots)
    ls = take(LCP, slots)

    cols = lbs[:, None] + arange32(W, dev)[None, :]
    inrow = cols <= ubs[:, None]
    sa_rows = take(SA, cols.clamp(max=n - 1).reshape(-1)).reshape(cols.shape)
    so_rows = take(SO, sa_rows.reshape(-1)).reshape(cols.shape)
    # distinct samples: sort each padded row with unique fillers
    so_pad = torch.where(inrow, so_rows, -1 - arange32(W, dev)[None, :])
    so_sorted = torch.sort(so_pad, dim=1).values
    distinct = (so_sorted[:, 1:] != so_sorted[:, :-1]).all(dim=1)
    lm = _left_maximal(T, sa_rows[:, :-1], sa_rows[:, 1:]) & inrow[:, 1:]
    ok = distinct & lm.any(dim=1)
    return ls, lbs, ubs, sa_rows, so_rows, ok


def _classify(SA, begins, ends, cls_tab):
    """Each slot's class by its text position over the disjoint intervals
    (0 outside them)."""
    if not begins.numel():
        return torch.zeros_like(SA)
    ii = torch.searchsorted(begins, SA, right=True) - 1
    ii_c = ii.clamp(0, begins.shape[0] - 1)
    hit = (ii >= 0) & (SA < take(ends, ii_c))
    return torch.where(hit, take(cls_tab, ii_c), 0).to(SA.dtype)


def _child_lcp(cls, mins):
    """Each slot's child LCP: its class's running minimum (columns for
    classes 1, 2 and 4), 0 for the other classes."""
    return torch.where(
        cls == 1, mins[:, 0],
        torch.where(cls == 2, mins[:, 1],
                    torch.where(cls == 4, mins[:, 2], 0)))


def _sort_key(SEG, cls, seg_map):
    """Each slot's child id (``seg_map`` of its segment and class), SCAP
    for a dead slot."""
    SCAP = seg_map.shape[0]
    nseg = torch.where(
        (SEG >= 0) & (cls > 0) & (cls != 3),
        seg_map[SEG.clamp(0, SCAP - 1).long(), cls.long()],
        -1,
    )
    return torch.where(nseg < 0, SCAP, nseg).to(SEG.dtype)


def _lowercase(T, tpos, mbegins, mends):
    """T with its upper-case bytes at text positions ``tpos`` inside the
    match intervals lowercased (reveal.c:1230-1234)."""
    if not mbegins.numel():
        return T
    mi = torch.searchsorted(mbegins, tpos, right=True) - 1
    mi_c = mi.clamp(0, mbegins.shape[0] - 1)
    inm = (mi >= 0) & (tpos < take(mends, mi_c))
    up = (T >= ord("A")) & (T <= ord("Z"))
    return torch.where(inm & up, T + 32, T)


def _repair_flags(new_sa, new_lcp, new_seg, seg_next, lcp_next, mk_key,
                  edges):
    """Per child id, its slots that need a boundary repair (reveal.c:
    666-727 trigger): one of its OWN leading child's new match begins lies
    inside (SA, SA + max(LCP, next LCP)), a bound over the (sid, begin)
    keys from each side; ``edges``: the children's slot ranges."""
    win = torch.maximum(
        new_lcp, torch.where(seg_next == new_seg, lcp_next, new_lcp))
    qkey = new_seg.to(I64) << 32
    klo = torch.searchsorted(mk_key, qkey + new_sa.to(I64), right=True)
    khi = torch.searchsorted(mk_key, qkey + (new_sa + win).to(I64))
    cross = ((khi > klo) & (new_seg >= 0)).to(new_sa.dtype)
    ccum = torch.cat([cross.new_zeros(1),
                      torch.cumsum(cross, 0, dtype=new_sa.dtype)])
    return take(ccum, edges[1:]) - take(ccum, edges[:-1])


def apply_level(T, SA, LCP, SEG, begins, ends, cls_tab, seg_map, mbegins,
                mends, mk_key):
    """One level's split on the device (``_get_apply``): returns (T, SA,
    LCP, SEG, counts, rcount) of the next level's layout.

    ``begins``/``ends``/``cls_tab``: the disjoint text intervals sorted by
    begin and their class (1 leading, 2 trailing, 3 matched, 4 parallel);
    ``seg_map`` (SCAP, 5): parent segment id x class -> child id (-1 dead),
    SCAP above every segment id of SEG and every child id;
    ``mbegins``/``mends``: this level's match intervals, sorted;
    ``mk_key``: the sorted int64 keys ``sid * 2^32 + begin`` of each
    leading child's own match begins.  ``counts`` and ``rcount`` are per
    child id (SCAP entries): its slots, and its slots whose LCP window
    crosses one of its own match begins.  Empty interval and match
    tables classify nothing; an empty key table flags nothing."""
    n = SA.shape[0]
    dev = SA.device
    cls = _classify(SA, begins, ends, cls_tab)

    # ---- per-class child LCP: segmented running-min over parents ------
    segstart = SEG != shift1(SEG, -2)
    cls_prev = shift1(cls, 0)
    resets = torch.stack([segstart | (cls_prev == c) for c in (1, 2, 4)], 1)
    newlcp = _child_lcp(cls, seg_min_scan(LCP[:, None].expand(n, 3), resets))
    sortkey = _sort_key(SEG, cls, seg_map)
    SCAP = seg_map.shape[0]

    # ---- stable partition by child id -----------------------------------
    skey, perm = torch.sort(sortkey, stable=True)
    new_sa = take(SA, perm)
    new_lcp = take(newlcp, perm)
    new_seg = torch.where(skey >= SCAP, -1, skey)
    # first slot of each child gets LCP 0
    first = new_seg != shift1(new_seg, -2)
    new_lcp = torch.where(first | (new_seg < 0), 0, new_lcp)
    # skey is sorted: child s holds the slots [edges[s], edges[s + 1])
    edges = torch.searchsorted(skey, arange32(SCAP + 1, dev))
    counts = edges[1:] - edges[:-1]

    T = _lowercase(T, arange32(T.shape[0], dev), mbegins, mends)
    rcount = _repair_flags(new_sa, new_lcp, new_seg, shift_left(new_seg, -3),
                           shift_left(new_lcp, 0), mk_key, edges)
    return T, new_sa, new_lcp, new_seg, counts.to(SA.dtype), rcount


# ---------------------------------------------------------------------------
# the mesh frontier: the same stages on this rank's shard of the slots
# ---------------------------------------------------------------------------

def _global_slots(kit, device):
    """The global slot indices of this rank's shard."""
    return arange32(kit.sh, device) + kit.me * kit.sh


def _probe_text(kit, T, a, b):
    """(T[a - 1], T[b - 1]) for global positions a, b (one per slot of
    this shard) by the kit's sort-based gather, clamped at 0 as the
    single-device stages read them."""
    idt = kit.idt
    ta, tb = kit.dist_gather2(
        T.to(idt), (a - 1).clamp(min=0).to(idt),
        (b - 1).clamp(min=0).to(idt),
        _global_slots(kit, T.device).to(idt))
    return ta.to(a.dtype), tb.to(a.dtype)


def _gather_rows(kit, rows):
    """Every rank's ``rows`` (k, c_rank) side by side in rank order: the
    ranks' column counts in one all_gather, then the rows padded to the
    largest count in a second.  A rank's rows are in ascending global
    slot order and the shards are in rank order, so the result is in
    ascending global slot order.  Every rank reads the same counts, so
    all skip the second gather together when no rank has a row."""
    counts = kit.all_gather(torch.tensor([rows.shape[1]], dtype=I64,
                                         device=rows.device))[:, 0].tolist()
    width = max(counts)
    if width == 0:
        return rows
    pad = rows.new_zeros((rows.shape[0], width - rows.shape[1]))
    every = kit.all_gather(torch.cat([rows, pad], 1))
    return torch.cat([every[r, :, :c] for r, c in enumerate(counts)], 1)


def enumerate_pairwise_mesh(kit, T, SA, LCP, SEG, nsep0: int, minl: int):
    """``enumerate_pairwise`` over a mesh (``_get_enum_pairwise_mesh``,
    reference devfrontier.py:175-293): this rank's shards of T/SA/LCP/SEG
    in, every rank gets the whole (4, count) int32 tensor of (slot, l, a,
    b) in ascending global slot order.  Collectives, in order: one prev
    halo of (SA, SEG, LCP) and one next halo of LCP (zero on the last
    shard, as the single-device stage reads past the end), the two text
    probes by ``dist_gather2``, and the candidates by ``_gather_rows``
    (the reference compacts by a network sort on ``cand ? slot : BIG``
    and fetches a prefix by a psum: the same rows in the same order)."""
    first, last = kit.me == 0, kit.me == kit.P - 1
    iar_g = _global_slots(kit, SA.device)
    h = kit.prev_halo(torch.stack([SA, SEG, LCP], 1))[0]
    prev = torch.cat([h[0:1], SA[:-1]])
    seg_prev = torch.cat([SEG.new_full((1,), -9) if first else h[1:2],
                          SEG[:-1]])
    lcp_prev = torch.cat([h[2:3], LCP[:-1]])
    nx = kit.next_halo(LCP)
    lcp_next = torch.cat([LCP[1:], LCP.new_zeros(1) if last else nx])
    l = LCP
    straddle = (SA > nsep0) != (prev > nsep0)
    a = torch.minimum(SA, prev)
    b = torch.maximum(SA, prev)
    ta, tb = _probe_text(kit, T, a, b)
    mask = (
        (iar_g >= 1)
        & (SEG >= 0)
        & (SEG == seg_prev)
        & (l >= minl)
        & (l > 0)
        & straddle
        & _left_max_test(a, b, ta, tb)
        & (lcp_prev < l) & (lcp_next < l)
    )
    loc = torch.nonzero(mask).squeeze(1)
    return _gather_rows(kit, torch.stack(
        [take(x, loc) for x in (iar_g, LCP, a, b)]))


def enumerate_multi_mesh(kit, T, SA, LCP, SEG, nsep, nreal: int, minl: int,
                         minn: int, nsamples_main: int, W: int):
    """The candidate intervals of ``enumerate_multi`` over a mesh
    (``_get_enum_multi_mesh``, reference devfrontier.py:442-599): every
    rank gets the (4, count) int32 tensor of (slot, l, lb, ub) of the
    intervals that pass the length and width gates, in ascending global
    slot order, and keeps its shard's per-slot left-maximality flags of
    the pair (slot - 1, slot) and sample ids for ``multi_windows_mesh``.

    A kept interval (width <= ``nsamples_main`` <= W) has its PSV within
    W slots below and its NSV within W above, so a radius-W scan over
    W-wide halo blocks of (LCP, SA) finds them (one stacked exchange a
    direction, LCP -1 past either end: the pointer doubling's stop
    values); a slot whose nearest smaller value lies farther gets the
    sentinel ``slot -+ (W + 1)``, which fails the width gate as the true
    wider interval does.  Needs ``kit.sh >= W``.  Sample ids come from
    ``searchsorted`` over the replicated sentinel table ``nsep`` (the
    reference pads it to a power of two for its compiles; padding
    entries never answer a position below ``nreal``).  Returns (rows,
    lm, ssid)."""
    if kit.sh < W:
        raise ValueError("a shard of %d slots is narrower than the "
                         "multi enumeration's radius %d" % (kit.sh, W))
    iar_g = _global_slots(kit, SA.device)
    lb, ub, a_pair = _radius_intervals(kit, LCP, SA, W)
    width = ub - lb + 1
    cand = (
        (SEG >= 0)
        & (LCP >= max(minl, 1))
        & (width >= minn)
        & (width <= nsamples_main)
    )
    loc = torch.nonzero(cand).squeeze(1)
    rows = torch.stack([take(x, loc) for x in (iar_g, LCP, lb, ub)])
    del width, cand, loc, lb, ub
    ta, tb = _probe_text(kit, T, a_pair, SA)
    lm = _left_max_test(a_pair, SA, ta, tb)
    ssid = torch.searchsorted(nsep, SA.clamp(0, nreal - 1)).to(SA.dtype)
    return _gather_rows(kit, rows), lm, ssid


def _radius_intervals(kit, LCP, SA, W: int):
    """(lb, ub) of each slot's LCP interval by radius-W nearest-smaller-
    value scans over W-wide halo blocks of (LCP, SA), and SA of the slot
    before each slot (``a`` of its adjacent pair)."""
    first, last = kit.me == 0, kit.me == kit.P - 1
    sh = kit.sh
    iar_g = _global_slots(kit, SA.device)
    hp = kit.prev_halo(torch.stack([LCP, SA], 1), W)
    hn = kit.next_halo(torch.stack([LCP, SA], 1), W)
    neg = LCP.new_full((W,), -1)
    lcp_ext = torch.cat([neg if first else hp[:, 0], LCP,
                         neg if last else hn[:, 0]])
    dp = torch.zeros_like(LCP)
    dn = torch.zeros_like(LCP)
    for d in range(W, 0, -1):
        dp = torch.where(lcp_ext[W - d: W - d + sh] < LCP, d, dp)
        dn = torch.where(lcp_ext[W + d: W + d + sh] < LCP, d, dn)
    lb = torch.where(dp > 0, iar_g - dp, iar_g - W - 1).clamp(min=0)
    ub = torch.where(dn > 0, iar_g + dn, iar_g + W + 1) - 1
    return lb, ub, torch.cat([hp[-1:, 1], SA[:-1]])


def multi_windows_mesh(kit, SA, lm, ssid, qlb, qub, W: int, ncols: int):
    """The (K, W) window rows and ``ok`` flags of the fetched intervals
    (``_get_win_multi_mesh``, reference devfrontier.py:602-671): each
    rank adds its overlap of every row's columns [lb, lb + W), clamped
    below ``ncols`` (the single-device stage's padded length), into a
    zero buffer, and one all_reduce of the three stacked planes gives
    every rank (sa_rows, so_rows, ok): distinct samples over the in-row
    window and at least one left-maximal adjacent pair in it."""
    sh = kit.sh
    dev = SA.device
    K = qlb.shape[0]
    cols = qlb[:, None] + arange32(W, dev)[None, :]
    loc = cols.clamp(0, ncols - 1) - kit.me * sh
    own = (loc >= 0) & (loc < sh)
    locc = loc.clamp(0, sh - 1).reshape(-1)
    planes = torch.stack([take(x, locc).reshape(K, W)
                          for x in (SA, ssid, lm.to(SA.dtype))])
    sa_rows, so_rows, lm_rows = kit.all_reduce(
        torch.where(own, planes, 0))
    inrow = cols <= qub[:, None]
    so_pad = torch.where(inrow, so_rows, -1 - arange32(W, dev)[None, :])
    so_sorted = torch.sort(so_pad, dim=1).values
    distinct = (so_sorted[:, 1:] != so_sorted[:, :-1]).all(dim=1)
    ok = distinct & ((lm_rows[:, 1:] > 0) & inrow[:, 1:]).any(dim=1)
    return sa_rows, so_rows, ok


def _child_lcp_mesh(kit, LCP, SEG, cls):
    """The child LCP of each slot of this shard: the three per-class
    segmented running minima with the cross-shard carry."""
    first = kit.me == 0
    h = kit.prev_halo(torch.stack([SEG, cls], 1))[0]
    seg_prev = torch.cat([SEG.new_full((1,), -2) if first else h[0:1],
                          SEG[:-1]])
    cls_prev = torch.cat([h[1:2], cls[:-1]])  # zero-filled on shard 0
    segstart = SEG != seg_prev
    resets = torch.stack([segstart | (cls_prev == c) for c in (1, 2, 4)],
                         1).to(LCP.dtype)

    def combine(x, y):
        (m1, f1), (m2, f2) = x, y
        return torch.where(f2 > 0, m2, torch.minimum(m1, m2)), f1 | f2

    mins, seen = associative_scan(
        combine, (LCP[:, None].expand(LCP.shape[0], 3), resets))
    summ = kit.all_gather(torch.stack([mins[-1], seen[-1]]))  # (P, 2, 3)
    carry = mins.new_full((3,), 2**30)
    for j in range(kit.me):
        carry = torch.where(summ[j, 1] > 0, summ[j, 0],
                            torch.minimum(carry, summ[j, 0]))
    return _child_lcp(cls, torch.where(seen > 0, mins,
                                       torch.minimum(carry[None, :], mins)))


def apply_level_mesh(kit, T, SA, LCP, SEG, begins, ends, cls_tab, seg_map,
                     mbegins, mends, mk_key):
    """``apply_level`` over a mesh (``_get_apply_mesh``, reference
    devfrontier.py:814-1041): this rank's shards in and out, the tables
    replicated; ``counts`` and ``rcount`` summed over the ranks.

    Collectives, in order: a prev halo of (SEG, class); one all_gather of
    the (2, 3) per-shard summaries of the three running minima (the last
    minimum, and whether the shard has a reset), from which a shard's
    carry is the latest earlier shard with a reset and the minimum over
    the reset-free shards after it; the global stable partition by
    (child id, global slot) as the kit's network sort (dead slots under
    key SCAP sort last); a prev halo of the new SEG (a child's first
    slot gets LCP 0); a next halo of (new SEG, new LCP) for the repair
    flags; one all_reduce of (counts, rcount)."""
    first, last = kit.me == 0, kit.me == kit.P - 1
    dev = SA.device
    iar_g = _global_slots(kit, dev)
    cls = _classify(SA, begins, ends, cls_tab)
    newlcp = _child_lcp_mesh(kit, LCP, SEG, cls)
    sortkey = _sort_key(SEG, cls, seg_map)
    del cls
    SCAP = seg_map.shape[0]

    # ---- global stable partition by child id ----------------------------
    skey, _slot, new_sa, new_lcp = kit.make_net_sort(kit.sh)(
        (sortkey, iar_g, SA, newlcp), 2)
    del sortkey, newlcp, _slot
    new_seg = torch.where(skey >= SCAP, -1, skey)
    h2 = kit.prev_halo(new_seg)
    sprev = torch.cat([new_seg.new_full((1,), -2) if first else h2,
                       new_seg[:-1]])
    new_lcp = torch.where((new_seg != sprev) | (new_seg < 0), 0, new_lcp)
    # skey is sorted: this shard holds child s's slots [edges[s], edges[s+1])
    edges = torch.searchsorted(skey, arange32(SCAP + 1, dev))
    counts = edges[1:] - edges[:-1]

    T = _lowercase(T, iar_g, mbegins, mends)
    nh = kit.next_halo(torch.stack([new_seg, new_lcp], 1))[0]
    seg_next = torch.cat([new_seg[1:], new_seg.new_full((1,), -3) if last
                          else nh[0:1]])
    lcp_next = torch.cat([new_lcp[1:], new_lcp.new_zeros(1) if last
                          else nh[1:2]])
    rcount = _repair_flags(new_sa, new_lcp, new_seg, seg_next, lcp_next,
                           mk_key, edges)
    both = kit.all_reduce(torch.stack([counts.to(SA.dtype), rcount]))
    return T, new_sa, new_lcp, new_seg, both[0], both[1]


def fetch_slots_mesh(kit, arrays, idx):
    """The values of ``arrays`` (this rank's shards, int32) at the global
    slots ``idx`` (replicated, int64), on every rank: each rank fills in
    the slots it holds and one all_reduce adds them up
    (``_get_repair_rows_mesh``'s fetch, reference devfrontier.py:1511-
    1521).  Returns (values (len(arrays), len(idx)), this rank's local
    indices of the slots it holds)."""
    loc = idx - kit.me * kit.sh
    own = (loc >= 0) & (loc < kit.sh)
    locc = loc.clamp(0, kit.sh - 1)
    planes = torch.stack([take(a, locc) for a in arrays])
    mine = torch.nonzero(own).squeeze(1)
    return kit.all_reduce(torch.where(own, planes, 0)), mine, take(loc, mine)


# ---------------------------------------------------------------------------
# host repair
# ---------------------------------------------------------------------------

def _repair_host(SA: np.ndarray, LCP: np.ndarray, begins,
                 scratch=None) -> None:
    """bubble_sort (reveal.c:666-727) on a detached child slice by the
    native repair walk, with a scratch inverse array (the packed design
    derives classification from positions, so no global SAi is
    maintained).  The walk only writes the scratch, so one int64 array of
    at least ``SA.max() + 2`` entries may serve every call (a new one a
    call pays its page faults again).  Raises when the native library did
    not build."""
    if scratch is None:
        scratch = np.empty(int(SA.max()) + 2 if len(SA) else 1,
                           dtype=np.int64)
    from ..native import repair_leading_native

    if not repair_leading_native(SA, LCP, scratch, list(begins)):
        raise RuntimeError("the native repair walk "
                           "(reveal_tpu_torch/native) failed to build or "
                           "load, or was given arrays it cannot take")


def _repair_host_plain(SA: np.ndarray, LCP: np.ndarray, begins) -> None:
    """The same repair as ``_repair_host`` in numpy: the reference the
    native walk is tested against."""
    # numpy fallback: same walk as esa_index._repair_leading_py
    n = len(SA)
    for begin in begins:
        cross_cur = (SA < begin) & (SA + LCP > begin)
        lcp_next = np.empty(n, dtype=LCP.dtype)
        lcp_next[: n - 1] = LCP[1:]
        lcp_next[n - 1] = 0
        cross_next = (SA < begin) & (SA + lcp_next > begin)
        cand = np.nonzero(cross_cur | cross_next)[0]
        for i in cand.tolist():
            if SA[i] < begin and SA[i] + LCP[i] > begin:
                tmp_sa = SA[i]
                tmp_lcp = LCP[i]
                thr = begin - tmp_sa
                x = i
                while x > 0 and LCP[x] >= thr:
                    x -= 1
                if x < i:
                    SA[x + 1 : i + 1] = SA[x:i]
                    LCP[x + 1 : i + 1] = LCP[x:i]
                SA[x] = tmp_sa
                LCP[x + 1] = thr
                if i < n - 1 and tmp_lcp < LCP[i + 1]:
                    LCP[i + 1] = tmp_lcp
            else:
                if (
                    i < n - 1
                    and SA[i] < begin
                    and SA[i] + lcp_next[i] > begin
                    and LCP[i + 1] > LCP[i]
                ):
                    LCP[i + 1] = begin - SA[i]


# ---------------------------------------------------------------------------
# the frontier's device state
# ---------------------------------------------------------------------------

class DeviceFrontier:
    """Owns the packed device arrays of the recursion on ``device`` and
    the per-level stages.  ``stats`` (a dict) receives the host syncs it
    makes and the candidates and repair jobs it handles.

    With ``mesh`` (``parallel/mesh.Mesh``) the slots are sharded over the
    mesh's ranks: every rank of it builds the frontier from the same
    arrays, uploads only its shard (slots ``[rank * sh, (rank + 1) *
    sh)``) to ``mesh.device`` and runs the ``*_mesh`` stages; what comes
    back to the host (candidates, counts, repaired rows) is the same on
    every rank, so the host loop makes the same calls everywhere.
    ``device`` is None or ``mesh.device``.  The padded length is raised
    to a multiple of the ranks, and to ``max(2, nsamples)`` slots a rank
    for the multi enumeration's halo (``stats["mesh_padded"]``: the dead
    slots added, SEG = -1; no stage reads them as more than the padding
    the single-device frontier has).  ``nsep`` (the sample sentinel
    table) gives the multi enumeration its sample ids; without it every
    multi enumeration gathers the shards and runs ``enumerate_multi`` on
    every rank (``stats["mesh_replicated"]`` counts them).  ``stats``
    also gets the mesh's collectives: p2p, all_gathers, all_reduces and
    the widest exchange (slots of one array)."""

    def __init__(self, T, SA, LCP, SO, nsep0: int, nsamples: int, device,
                 stats=None, mesh=None, nsep=None):
        self.mesh = mesh
        if mesh is not None:
            if device is not None and not same_device(device, mesh.device):
                raise ValueError("device %s contradicts the mesh's device %s"
                                 % (device, mesh.device))
            device = mesh.device
        self.device = torch.device(device)
        self.n = int(len(SA))
        self.nsep0 = int(nsep0)
        self.nsamples = int(nsamples)
        self.stats = {} if stats is None else stats
        for k in ("host_syncs", "candidates", "repair_jobs"):
            self.stats.setdefault(k, 0)
        # pad every device array to a power of two (dead tail: SEG = -1):
        # the multi enumeration's round count depends on the padded length
        npad = self.npad = _next_pow2(self.n)
        if npad > 2**30:
            raise ValueError("a text of %d bytes is past the int32 state of "
                             "the frontier (2^30 slots at most)" % self.n)
        lo, width = 0, npad
        if mesh is not None:
            from ..parallel.dsa import CollectiveKit

            P = mesh.size
            width = max(-(-npad // P), 2, self.nsamples)
            lo = mesh.rank * width
            self.nsep = (None if nsep is None else
                         torch.as_tensor(np.asarray(nsep, dtype=np.int32),
                                         device=self.device))
            # the gather's sort-back key reaches 3 * P * sh
            self.kit = CollectiveKit(
                mesh, width, I64 if 3 * P * width >= 2**31 else torch.int32)
            self.stats.update(mesh_P=P, mesh_sh=width,
                              mesh_padded=P * width - npad,
                              mesh_replicated=0)
            self.stats.update(self.kit.stats)
            if P * width > npad:
                log.info("mesh frontier: %d slots padded to %d (%d ranks of "
                         "%d slots)", npad, P * width, P, width)
        hi = lo + width

        def local(arr, fill, dtype):
            """This rank's slots [lo, hi) of ``arr`` padded with ``fill``."""
            out = np.full(width, fill, dtype=dtype)
            part = np.asarray(arr)[lo:hi]
            out[: len(part)] = part
            return out

        n = self.n
        SEG_p = local(np.zeros(n, np.int32), -1, np.int32)
        words = self._upload(np.concatenate([
            local(SA, n - 1, np.int32), local(LCP, 0, np.int32),
            local(SO, 0, np.int32), SEG_p]))
        self.SA, self.LCP, self.SO, self.SEG = words.view(4, width)
        self.T = self._upload(local(T, 0, np.uint8))
        # segment ids SEG may hold: 0 only at the root
        self._seg_ids = 1
        # the repair walks' scratch inverse array (every SA value < n;
        # its pages are touched only where a walk writes)
        self._scratch = np.empty(self.n + 2, dtype=np.int64)

    def _upload(self, arr):
        self.stats["host_syncs"] += 1
        return torch.from_numpy(arr).to(self.device)

    def _fetch(self, x):
        self.stats["host_syncs"] += 1
        return trace.read(x.cpu).numpy()

    def _posted(self):
        """Copy the mesh's collective counts into ``stats``."""
        if self.mesh is not None:
            self.stats.update(self.kit.stats)

    def state(self):
        """(T, SA, LCP, SEG) of the whole padded layout as numpy arrays
        (``npad`` slots; on a mesh one all_gather of the shards, the same
        on every rank)."""
        words = torch.stack([self.T.to(self.SA.dtype), self.SA, self.LCP,
                             self.SEG])
        if self.mesh is not None:
            words = self.kit.all_gather(words).permute(1, 0, 2).reshape(4, -1)
            self._posted()
        T, SA, LCP, SEG = self._fetch(words[:, : self.npad])
        return T.astype(np.uint8), SA, LCP, SEG

    def load(self, T, SA, LCP, SEG):
        """Replace the layout by ``state()``'s arrays (``npad`` slots):
        this rank's shard of them (the mesh's padding slots dead)."""
        width = self.SA.shape[0]
        lo = width * (0 if self.mesh is None else self.mesh.rank)

        def local(arr, fill):
            out = torch.full((width,), fill, dtype=torch.int32)
            part = torch.as_tensor(
                np.asarray(arr, dtype=np.int32)[lo: lo + width])
            out[: len(part)] = part
            return out.to(self.device)

        self.T = local(T, 0).to(torch.uint8)
        self.SA = local(SA, self.n - 1)
        self.LCP = local(LCP, 0)
        self.SEG = local(SEG, -1)
        self._seg_ids = max(int(np.max(SEG)) + 1, 1)

    # -- enumeration ------------------------------------------------------
    def enumerate_pairwise(self, minl: int):
        """(slots, l, a, b) numpy int32 of every live segment's candidates
        in ascending slot order: per segment, getmums_rem's order."""
        if self.mesh is not None:
            out = enumerate_pairwise_mesh(self.kit, self.T, self.SA,
                                          self.LCP, self.SEG, self.nsep0,
                                          minl)
            self._posted()
            self.stats["host_syncs"] += 1  # the all-gathered counts
        else:
            out = torch.stack(enumerate_pairwise(
                self.T, self.SA, self.LCP, self.SEG, self.nsep0, minl))
            self.stats["host_syncs"] += 1  # nonzero's count
        slots, l, a, b = self._fetch(out)
        self.stats["candidates"] += len(slots)
        return slots, l, a, b

    def enumerate_multi(self, minl: int, minn: int):
        """LCP-interval multiMUM candidates: (l, lb, ub, sa_rows, so_rows)
        numpy int32 of the intervals that pass (before the host's dedup)."""
        W = max(2, self.nsamples)
        if self.mesh is not None and self.nsep is not None:
            return self._enumerate_multi_mesh(minl, minn, W)
        if self.mesh is not None:
            # no sentinel table: the whole layout on every rank
            T, SA, LCP, SEG, SO = (x[: self.npad] for x in self.kit.all_gather(
                torch.stack([self.T.to(self.SA.dtype), self.SA, self.LCP,
                             self.SEG, self.SO])).permute(1, 0, 2).reshape(
                                 5, -1))
            T = T.to(torch.uint8)
            self.stats["mesh_replicated"] += 1
            self._posted()
        else:
            T, SA, LCP, SEG, SO = self.T, self.SA, self.LCP, self.SEG, self.SO
        ls, lbs, ubs, sa_rows, so_rows, ok = enumerate_multi(
            T, SA, LCP, SEG, SO, minl, minn, self.nsamples, W)
        self.stats["host_syncs"] += 1  # nonzero's count
        rows = self._fetch(torch.cat(
            [torch.stack([ls, lbs, ubs, ok.to(ls.dtype)], 1), sa_rows,
             so_rows], 1))
        rows = rows[rows[:, 3] > 0]
        self.stats["candidates"] += len(rows)
        return (rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 4:4 + W],
                rows[:, 4 + W:])

    def _enumerate_multi_mesh(self, minl, minn, W):
        rows, lm, ssid = enumerate_multi_mesh(
            self.kit, self.T, self.SA, self.LCP, self.SEG, self.nsep,
            self.n, minl, minn, self.nsamples, W)
        self.stats["host_syncs"] += 1  # the all-gathered counts
        if rows.shape[1] == 0:
            self._posted()
            e = np.empty(0, np.int32)
            e2 = np.empty((0, W), np.int32)
            return e, e, e, e2, e2
        sa_rows, so_rows, ok = multi_windows_mesh(
            self.kit, self.SA, lm, ssid, rows[2], rows[3], W, self.npad)
        self._posted()
        got = self._fetch(torch.cat(
            [rows[1:].T, ok.to(rows.dtype)[:, None], sa_rows, so_rows], 1))
        got = got[got[:, 3] > 0]
        self.stats["candidates"] += len(got)
        return (got[:, 0], got[:, 1], got[:, 2], got[:, 4:4 + W],
                got[:, 4 + W:])

    # -- level application ------------------------------------------------
    def apply_level(
        self, intervals, seg_map_rows, match_intervals, repair_jobs=()
    ):
        """intervals: [(begin, end, cls)] disjoint across the text;
        seg_map_rows: (S, 5) int32 parent-sid × class -> new sid (-1 dead);
        match_intervals: sorted [(begin, end)] newly matched this level;
        repair_jobs: [(leading child sid, [match begins])] — candidates
        are detected per child against its OWN begins only.

        Returns (counts, repair_counts) per new sid."""
        S = seg_map_rows.shape[0]
        SCAP = max(S, int(seg_map_rows.max()) + 1, self._seg_ids, 2)
        seg_map = np.full((SCAP, 5), -1, dtype=np.int32)
        seg_map[:S] = seg_map_rows
        iv = np.array(sorted(intervals), dtype=np.int32).reshape(-1, 3)
        mv = np.array(sorted(match_intervals), dtype=np.int32).reshape(-1, 2)
        pairs = np.array(
            sorted((sid, bgn) for sid, bgns in repair_jobs for bgn in bgns),
            dtype=np.int32).reshape(-1, 2)
        # every table in one copy to the device
        parts = (iv[:, 0], iv[:, 1], iv[:, 2], seg_map.reshape(-1),
                 mv[:, 0], mv[:, 1], pairs[:, 0], pairs[:, 1])
        words = self._upload(np.concatenate(parts))
        tabs = list(torch.split(words, [len(p) for p in parts]))
        tabs[3] = tabs[3].view(SCAP, 5)
        mk_key = (tabs[6].to(I64) << 32) + tabs[7].to(I64)
        if self.mesh is not None:
            out = apply_level_mesh(self.kit, self.T, self.SA, self.LCP,
                                   self.SEG, *tabs[:6], mk_key)
            self._posted()
        else:
            out = apply_level(self.T, self.SA, self.LCP, self.SEG, *tabs[:6],
                              mk_key)
        self.T, self.SA, self.LCP, self.SEG, counts, rcount = out
        self._seg_ids = SCAP
        counts, rcount = self._fetch(torch.stack([counts, rcount]))
        return counts, rcount

    # -- boundary repair --------------------------------------------------
    def repair_children(self, jobs):
        """Batched boundary repair (jobs: [(start, n, begins)]): every
        affected child's slots in ONE gather and one copy to the host, the
        native repair walk child by child, then one copy back and ONE
        scatter.  On a mesh the gather is ``fetch_slots_mesh`` (every rank
        walks every child) and each rank writes back the slots it holds."""
        jobs = [(s, n, b) for s, n, b in jobs if n > 0 and b]
        self.stats["repair_jobs"] += len(jobs)
        if not jobs:
            return
        idx = np.concatenate([np.arange(s, s + n, dtype=np.int64)
                              for s, n, _b in jobs])
        idx_d = self._upload(idx)
        if self.mesh is not None:
            rows, mine, loc = fetch_slots_mesh(self.kit, (self.SA, self.LCP),
                                               idx_d)
            self._posted()
        else:
            rows, mine, loc = torch.stack(
                [self.SA[idx_d], self.LCP[idx_d]]), None, idx_d
        sa_all, lcp_all = self._fetch(rows).astype(np.int64)
        off = 0
        for _s, n, begins in jobs:
            sa = sa_all[off: off + n]
            lcp = lcp_all[off: off + n]
            _repair_host(sa, lcp, sorted(begins), self._scratch)
            off += n
        rows = self._upload(np.stack([sa_all, lcp_all]).astype(np.int32))
        if mine is not None:
            rows = rows[:, mine]
        self.SA.index_copy_(0, loc, rows[0])
        self.LCP.index_copy_(0, loc, rows[1])
        if self.device.type == "cuda":
            # the repair stage's clock stops when its writes are done
            torch.cuda.synchronize(self.device)


def same_device(a, b) -> bool:
    """Whether device names ``a`` and ``b`` are one device (a card given
    without its index is the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cpu":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == (
        b.index if b.index is not None else cur)

