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
moves fewer bytes.  The ``*_mesh`` functions are the mesh frontier
(ROADMAP queue 1 item 9b) and are not ported yet.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.encoding import N_BYTE, SENTINEL
from .devloop import arange32, seg_min_scan, shift1, shift_left, take

log = logging.getLogger(__name__)

I64 = torch.int64

# the last run's counters (``_align_loop_frontier``): levels, anchor
# steps, apply calls, candidates returned by the enumeration, repair jobs,
# host syncs (the frontier's own copies between host and device and the
# count reads of ``nonzero``), seconds per stage, and ``fallback``: why the
# frontier ran in place of the multi-genome loop (None when it was the
# route from the start)
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

def _left_maximal(T, a, b):
    """The left-maximality test of the pair of suffixes (a, b)."""
    ta = take(T, (a - 1).clamp(min=0).reshape(-1)).reshape(a.shape)
    tb = take(T, (b - 1).clamp(min=0).reshape(-1)).reshape(b.shape)
    lower = (ta >= ord("a")) & (ta <= ord("z"))
    return ((a == 0) | (b == 0) | (ta != tb) | (ta == N_BYTE)
            | (ta == SENTINEL) | lower)


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

    # ---- classify slots by text position over disjoint intervals ------
    if begins.numel():
        ii = torch.searchsorted(begins, SA, right=True) - 1
        ii_c = ii.clamp(0, begins.shape[0] - 1)
        hit = (ii >= 0) & (SA < take(ends, ii_c))
        cls = torch.where(hit, take(cls_tab, ii_c), 0).to(SA.dtype)
    else:
        cls = torch.zeros_like(SA)

    # ---- per-class child LCP: segmented running-min over parents ------
    segstart = SEG != shift1(SEG, -2)
    cls_prev = shift1(cls, 0)
    resets = torch.stack([segstart | (cls_prev == c) for c in (1, 2, 4)], 1)
    mins = seg_min_scan(LCP[:, None].expand(n, 3), resets)
    newlcp = torch.where(
        cls == 1, mins[:, 0],
        torch.where(cls == 2, mins[:, 1],
                    torch.where(cls == 4, mins[:, 2], 0)))

    # ---- new segment ids ------------------------------------------------
    SCAP = seg_map.shape[0]
    seg_c = SEG.clamp(0, SCAP - 1).long()
    nseg = torch.where(
        (SEG >= 0) & (cls > 0) & (cls != 3),
        seg_map[seg_c, cls.long()],
        -1,
    )
    sortkey = torch.where(nseg < 0, SCAP, nseg)

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

    # ---- lowercase matched text (reveal.c:1230-1234) --------------------
    if mbegins.numel():
        tpos = arange32(T.shape[0], dev)
        mi = torch.searchsorted(mbegins, tpos, right=True) - 1
        mi_c = mi.clamp(0, mbegins.shape[0] - 1)
        inm = (mi >= 0) & (tpos < take(mends, mi_c))
        up = (T >= ord("A")) & (T <= ord("Z"))
        T = torch.where(inm & up, T + 32, T)

    # ---- boundary-repair candidates (reveal.c:666-727 trigger) ----------
    # a slot needs repair when one of ITS OWN leading child's new match
    # begins lies inside (SA, SA + max(LCP, next LCP)): a bound over the
    # (sid, begin) keys from each side
    nxt_same = shift_left(new_seg, -3) == new_seg
    win = torch.maximum(
        new_lcp, torch.where(nxt_same, shift_left(new_lcp, 0), new_lcp))
    qkey = new_seg.to(I64) << 32
    klo = torch.searchsorted(mk_key, qkey + new_sa.to(I64), right=True)
    khi = torch.searchsorted(mk_key, qkey + (new_sa + win).to(I64))
    cross = ((khi > klo) & (new_seg >= 0)).to(SA.dtype)
    ccum = torch.cat([cross.new_zeros(1), torch.cumsum(cross, 0,
                                                       dtype=SA.dtype)])
    rcount = take(ccum, edges[1:]) - take(ccum, edges[:-1])
    return T, new_sa, new_lcp, new_seg, counts.to(SA.dtype), rcount


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
    makes and the candidates and repair jobs it handles."""

    def __init__(self, T, SA, LCP, SO, nsep0: int, nsamples: int, device,
                 stats=None):
        self.device = torch.device(device)
        self.n = int(len(SA))
        self.nsep0 = int(nsep0)
        self.nsamples = int(nsamples)
        self.stats = {} if stats is None else stats
        for k in ("host_syncs", "candidates", "repair_jobs"):
            self.stats.setdefault(k, 0)
        # pad every device array to a power of two (dead tail: SEG = -1):
        # the multi enumeration's round count depends on the padded length
        npad = _next_pow2(self.n)
        if npad > 2**30:
            raise ValueError("a text of %d bytes is past the int32 state of "
                             "the frontier (2^30 slots at most)" % self.n)
        T_p = np.zeros(npad, dtype=np.uint8)
        T_p[: len(T)] = np.asarray(T, dtype=np.uint8)
        SA_p = np.full(npad, self.n - 1, dtype=np.int32)
        SA_p[: self.n] = np.asarray(SA, dtype=np.int32)
        LCP_p = np.zeros(npad, dtype=np.int32)
        LCP_p[: self.n] = np.asarray(LCP, dtype=np.int32)
        SO_p = np.zeros(npad, dtype=np.int32)
        SO_p[: len(SO)] = np.asarray(SO, dtype=np.int32)
        SEG_p = np.full(npad, -1, dtype=np.int32)
        SEG_p[: self.n] = 0
        words = self._upload(np.concatenate([SA_p, LCP_p, SO_p, SEG_p]))
        self.SA, self.LCP, self.SO, self.SEG = words.view(4, npad)
        self.T = self._upload(T_p)
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
        return x.cpu().numpy()

    # -- enumeration ------------------------------------------------------
    def enumerate_pairwise(self, minl: int):
        """(slots, l, a, b) numpy int32 of every live segment's candidates
        in ascending slot order: per segment, getmums_rem's order."""
        out = enumerate_pairwise(self.T, self.SA, self.LCP, self.SEG,
                                 self.nsep0, minl)
        self.stats["host_syncs"] += 1  # nonzero's count
        slots, l, a, b = self._fetch(torch.stack(out))
        self.stats["candidates"] += len(slots)
        return slots, l, a, b

    def enumerate_multi(self, minl: int, minn: int):
        """LCP-interval multiMUM candidates: (l, lb, ub, sa_rows, so_rows)
        numpy int32 of the intervals that pass (before the host's dedup)."""
        W = max(2, self.nsamples)
        ls, lbs, ubs, sa_rows, so_rows, ok = enumerate_multi(
            self.T, self.SA, self.LCP, self.SEG, self.SO, minl, minn,
            self.nsamples, W)
        self.stats["host_syncs"] += 1  # nonzero's count
        rows = self._fetch(torch.cat(
            [torch.stack([ls, lbs, ubs, ok.to(ls.dtype)], 1), sa_rows,
             so_rows], 1))
        rows = rows[rows[:, 3] > 0]
        self.stats["candidates"] += len(rows)
        return (rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 4:4 + W],
                rows[:, 4 + W:])

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
        self.T, self.SA, self.LCP, self.SEG, counts, rcount = apply_level(
            self.T, self.SA, self.LCP, self.SEG, *tabs[:6], mk_key)
        self._seg_ids = SCAP
        counts, rcount = self._fetch(torch.stack([counts, rcount]))
        return counts, rcount

    # -- boundary repair --------------------------------------------------
    def repair_children(self, jobs):
        """Batched boundary repair (jobs: [(start, n, begins)]): every
        affected child's slots in ONE gather and one copy to the host, the
        native repair walk child by child, then one copy back and ONE
        scatter."""
        jobs = [(s, n, b) for s, n, b in jobs if n > 0 and b]
        self.stats["repair_jobs"] += len(jobs)
        if not jobs:
            return
        idx = np.concatenate([np.arange(s, s + n, dtype=np.int64)
                              for s, n, _b in jobs])
        idx_d = self._upload(idx)
        sa_all, lcp_all = self._fetch(
            torch.stack([self.SA[idx_d], self.LCP[idx_d]])).astype(np.int64)
        off = 0
        for _s, n, begins in jobs:
            sa = sa_all[off: off + n]
            lcp = lcp_all[off: off + n]
            _repair_host(sa, lcp, sorted(begins), self._scratch)
            off += n
        rows = self._upload(np.stack([sa_all, lcp_all]).astype(np.int32))
        self.SA.index_copy_(0, idx_d, rows[0])
        self.LCP.index_copy_(0, idx_d, rows[1])


def clock(stats, key, t0):
    """Add the seconds since ``t0`` to ``stats[key]``; returns now."""
    now = time.perf_counter()
    stats[key] = stats.get(key, 0.0) + now - t0
    return now
