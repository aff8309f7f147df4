"""The repair kernel's schedule (reveal_tpu_torch/csrc/repair_pass.cu) on
the CPU.

The CUDA kernel cannot run here, so ``emulate`` below runs, in numpy,
exactly the algorithm the kernel runs: tickets over the candidates, one
run of equal ``SEG[cq]`` a block, the runs in no particular order (here
backwards), each run's candidates in ascending slot order against the
state its predecessors left, the insertion point by the chunked backward
search of ``block_last_below`` (window_resolve.cuh) with no window cap,
and the rotation a chunk of 256 slots at a time from the top.  It is held
bit for bit against the plain version that the CPU path runs
(``devloop.repair_rounds_plain``, the JAX kernel's batched rounds, via
``repair.repair_segments`` on CPU tensors), counters included:

- on the real inputs of every repair pass that ``forest_run`` makes on
  each case of tests/test_torch_devloop.py (the repetitive cases force
  deep searches, the sequential branch and capacity retries with more
  candidates than CCAP);
- on hand-made layouts: many crossers with overlapping regions, deep
  searches, non-movers taking the LCP-only update with a ``centry_next``
  that differs from the live LCP, candidates at a segment's last slot
  and at npad - 1, and more candidates than CCAP.

The kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from reveal_tpu_torch.core.textstore import TextStore
from reveal_tpu_torch.index import devloop, repair
from reveal_tpu_torch.index.esa_index import ESAIndex
from reveal_tpu_torch.native import rem2_defer_native
from torch_support import devloop_case

BLOCK = 256     # threads of one block of the kernel


def block_last_below(lcp, lo, hi, thr):
    """max{j in [lo, hi) : lcp[j] < thr} or -1, a chunk of BLOCK slots
    at a time from the top, stopping at the first chunk with a hit."""
    top = hi
    while top > lo:
        j = np.arange(top - 1, max(top - BLOCK, lo) - 1, -1)
        hit = j[lcp[j] < thr]
        if hit.size:
            return int(hit.max())
        top -= BLOCK
    return -1


def emulate(SA, LCP, BWT, SEG, beg, cq, centry_next, rc):
    """The repair kernel's algorithm on numpy copies.  Returns (SA, LCP,
    BWT, [applied, longest run, moved slots], deepest q - x)."""
    SA, LCP, BWT = SA.copy(), LCP.copy(), BWT.copy()
    npad = len(SA)
    n = min(int(rc), len(cq))
    starts = [j for j in range(n)
              if j == 0 or SEG[cq[j]] != SEG[cq[j - 1]]]
    stats = [0, 0, 0]
    deepest = 0
    for start in reversed(starts):
        sid = SEG[cq[start]]
        j = start
        while j < n and (j == start or SEG[cq[j]] == sid):
            q = int(cq[j])
            b = int(beg[q])
            saq = int(SA[q])
            lcq = int(LCP[q])
            thr = b - saq
            move = saq < b and saq + lcq > b
            if move:
                x = max(block_last_below(LCP, 0, q, thr), 0)
                bwq = BWT[q]
                for top in range(q, x, -BLOCK):
                    d = np.arange(top, max(top - BLOCK, x), -1)
                    vals = SA[d - 1], BWT[d - 1], LCP[d - 1]
                    SA[d], BWT[d], LCP[d] = vals
                SA[x], BWT[x], LCP[x + 1] = saq, bwq, thr
                stats[2] += q - x
                deepest = max(deepest, q - x)
            qn = min(q + 1, npad - 1)
            lcp_qn = int(LCP[qn])
            if move and q < npad - 1 and lcq < lcp_qn:
                LCP[qn] = lcq
            elif (not move and q < npad - 1 and saq < b
                  and saq + int(centry_next[j]) > b and lcp_qn > LCP[q]):
                LCP[qn] = b - saq
            j += 1
        stats[0] += j - start
        stats[1] = max(stats[1], j - start)
    return SA, LCP, BWT, stats, deepest


def plain(SA, LCP, BWT, SEG, beg, cq, centry_next, rc, SMAX):
    """The CPU path: repair.repair_segments on CPU tensors."""
    t = torch.from_numpy
    stats = torch.zeros(3, dtype=torch.int64)
    SA2, LCP2, BWT2, _rounds = repair.repair_segments(
        t(SA.copy()), t(LCP.copy()), t(BWT.copy()), t(SEG), t(beg), t(cq),
        t(centry_next), torch.tensor(int(rc), dtype=torch.int32), SMAX,
        stats,
    )
    return SA2.numpy(), LCP2.numpy(), BWT2.numpy(), stats.tolist()


def assert_same(got, want):
    for name, g, w in zip(("SA", "LCP", "BWT", "counters"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


# ----------------------------------------------------------------------
# the real passes of forest_run
# ----------------------------------------------------------------------
def _capture(name, monkeypatch):
    """Every repair pass forest_run makes on a test_torch_devloop case:
    its inputs and what the CPU path made of them."""
    seqa, seqb, minl = devloop_case(name)
    ts = TextStore()
    for nm, seq in (("a", seqa), ("b", seqb)):
        ts.add_sample(nm)
        ts.add_sequence(seq)
    idx = ESAIndex.construct(ts, backend="native")
    T = idx.main.T.copy()
    res = rem2_defer_native(
        T, idx.SA, idx.LCP, idx.main.SAi.copy(), int(idx.main.nsep[0]),
        minl, True, 10000, 1, 1.0, 1e-8, 16, threads=1,
    )
    assert res is not None
    passes = []
    segments = repair.repair_segments

    def record(SA, LCP, BWT, SEG, beg, cq, centry_next, rc, SMAX, stats):
        args = [a.numpy().copy() for a in (SA, LCP, BWT, SEG, beg, cq,
                                           centry_next)]
        mine = torch.zeros_like(stats)
        out = segments(SA, LCP, BWT, SEG, beg, cq, centry_next, rc, SMAX,
                       mine)
        stats[0::2] += mine[0::2]
        stats[1] = torch.maximum(stats[1], mine[1])
        passes.append((args, int(rc), SMAX,
                       [a.numpy().copy() for a in out[:3]]
                       + [mine.tolist()]))
        return out

    monkeypatch.setattr(repair, "repair_segments", record)
    got = devloop.rem_device_forest(T, res[1], int(idx.main.nsep[0]), minl,
                                    10000, 1, 1, device=torch.device("cpu"))
    assert got is not None
    return passes


@pytest.mark.parametrize(
    "name",
    [
        "fuzz-3-2000-25", "fuzz-7-5000-60", "identical", "no_matches",
        "short_minlength", "repetitive-5", "repetitive-19",
    ],
)
def test_schedule_matches_plain_on_forest_passes(name, monkeypatch):
    passes = _capture(name, monkeypatch)
    if name == "no_matches":
        assert passes == []
        return
    assert passes
    deepest = 0
    over = 0
    for args, rc, SMAX, want in passes:
        *got, deep = emulate(*args, rc)
        assert_same(got, want)
        deepest = max(deepest, deep)
        over += rc > len(args[5])
    if name.startswith("repetitive"):
        # searches beyond the batched rounds' window of 256 slots and
        # passes with more candidates than CCAP were exercised
        assert deepest > 256
        assert over > 0


# ----------------------------------------------------------------------
# hand-made layouts
# ----------------------------------------------------------------------
def layout(rng, seglens, lead, spread=40, lcp_hi=None, npad=None):
    """Consecutive segments of the given lengths (then dead slots up to
    npad): SA near each segment's begin (so that many suffixes cross
    it), LCP in [0, lcp_hi) and 0 at every segment's first slot, as
    split_level leaves them."""
    total = sum(seglens)
    npad = npad or total + 5
    lcp_hi = lcp_hi or 2 * spread
    SA = np.full(npad, 3, np.int32)
    LCP = np.zeros(npad, np.int32)
    BWT = rng.integers(65, 91, size=npad).astype(np.int32)
    SEG = np.full(npad, -1, np.int32)
    beg = np.full(npad, -1, np.int32)
    is_lead = np.zeros(npad, bool)
    off = 0
    for sid, (n, ld) in enumerate(zip(seglens, lead)):
        b = 1000 * (sid + 1)
        SA[off:off + n] = rng.integers(b - spread, b + spread, size=n)
        LCP[off:off + n] = rng.integers(0, lcp_hi, size=n)
        LCP[off] = 0
        SEG[off:off + n] = sid
        if ld:
            beg[off:off + n] = b
            is_lead[off:off + n] = True
        off += n
    return SA, LCP, BWT, SEG, beg, is_lead


def queue(SA, LCP, is_lead, beg, CCAP):
    t = torch.from_numpy
    cq, centry_next, rc, abort = devloop.repair_queue(
        t(SA), t(LCP), t(is_lead), t(beg), CCAP,
        torch.zeros((), dtype=torch.int32),
    )
    return cq.numpy(), centry_next.numpy(), int(rc), int(abort)


def check(SA, LCP, BWT, SEG, beg, is_lead, CCAP=1024, SMAX=64, edit=None):
    cq, centry_next, rc, abort = queue(SA, LCP, is_lead, beg, CCAP)
    if edit is not None:
        centry_next = edit(cq, centry_next)
    want = plain(SA, LCP, BWT, SEG, beg, cq, centry_next, rc, SMAX)
    *got, deep = emulate(SA, LCP, BWT, SEG, beg, cq, centry_next, rc)
    assert_same(got, want)
    return cq, rc, abort, got, deep


@pytest.mark.parametrize("seed", range(6))
def test_overlapping_crossers(seed):
    """Segments of hundreds of slots, most of them crossing their begin:
    regions overlap, so the batched rounds take many rounds and both
    branches, the kernel one run a segment."""
    rng = np.random.default_rng(seed)
    lens = [int(v) for v in rng.integers(1, 700, size=8)]
    SA, LCP, BWT, SEG, beg, is_lead = layout(
        rng, lens, [True, False, True, True, False, True, True, True])
    _cq, rc, _abort, got, _deep = check(SA, LCP, BWT, SEG, beg, is_lead)
    assert rc > 100 and got[3][1] > 20
    assert not np.array_equal(got[0], SA)


def test_deep_searches():
    """LCP above every mover's threshold but at the segment's first
    slot: each insertion point is the segment start, hundreds of slots
    back (beyond one chunk of the search and of the rotation)."""
    rng = np.random.default_rng(3)
    SA, LCP, BWT, SEG, beg, is_lead = layout(
        rng, [900, 1300, 40], [True, True, True], spread=40, lcp_hi=400)
    LCP[np.nonzero(SEG >= 0)] += 100
    LCP[[0, 900, 2200]] = 0
    _cq, rc, _abort, _got, deep = check(SA, LCP, BWT, SEG, beg, is_lead)
    assert rc > 500 and deep > 2 * BLOCK


def test_lcp_only_update_reads_centry_next():
    """Non-movers that take the LCP-only update, read from centry_next;
    here half of it is made to differ from LCP[q + 1] (zeroed), which
    turns their update off in both versions alike."""
    rng = np.random.default_rng(5)
    SA, LCP, BWT, SEG, beg, is_lead = layout(rng, [300, 200], [True, True])
    # non-movers: SA < b, SA + LCP[q] <= b < SA + LCP[q + 1]
    b = beg[:500]
    sa = b - rng.integers(1, 30, size=500)
    SA[:500] = sa
    LCP[1:500] = np.where(np.arange(1, 500) % 2 == 1,
                          rng.integers(0, 3, size=499),
                          rng.integers(40, 60, size=499))
    LCP[[0, 300]] = 0
    cq, rc, _abort, got, _deep = check(SA, LCP, BWT, SEG, beg, is_lead)
    moved_lcp = np.count_nonzero(got[1] != LCP)
    assert rc > 100 and moved_lcp > 20

    def stale(cq, centry_next):
        out = centry_next.copy()
        out[::2] = 0
        return out

    _cq, _rc, _abort, got2, _deep = check(SA, LCP, BWT, SEG, beg, is_lead,
                                          edit=stale)
    assert not np.array_equal(got2[1], got[1])


@pytest.mark.parametrize("dead", [0, 3])
def test_candidates_at_segment_ends(dead):
    """A mover at each lead segment's last slot (its LCP[q + 1] is the
    next segment's first slot, or a dead slot), and, with no dead
    slots, at npad - 1."""
    rng = np.random.default_rng(7 + dead)
    lens = [50, 80, 120]
    SA, LCP, BWT, SEG, beg, is_lead = layout(
        rng, lens, [True, True, True], npad=sum(lens) + dead)
    for end in np.cumsum(lens) - 1:
        SA[end] = beg[end] - 1
        LCP[end] = 9
    cq, rc, _abort, _got, _deep = check(SA, LCP, BWT, SEG, beg, is_lead)
    ends = set((np.cumsum(lens) - 1).tolist())
    assert ends <= set(cq[:rc].tolist())
    assert (len(SA) - 1 in set(cq[:rc].tolist())) == (dead == 0)


@pytest.mark.parametrize("CCAP", [1, 7, 64])
def test_more_candidates_than_ccap(CCAP):
    """rc > CCAP: the abort is set and only the first CCAP candidates
    are applied, by both versions alike."""
    rng = np.random.default_rng(CCAP)
    SA, LCP, BWT, SEG, beg, is_lead = layout(rng, [120, 90, 200],
                                             [True, True, True])
    _cq, rc, abort, got, _deep = check(SA, LCP, BWT, SEG, beg, is_lead,
                                       CCAP=CCAP)
    assert rc > CCAP and abort == devloop.ABORT_REPAIR_OVERFLOW
    assert got[3][0] == CCAP


def test_wrapper_checks_its_arguments():
    z = torch.zeros(8, dtype=torch.int32)
    stats = torch.zeros(3, dtype=torch.int64)
    rc = torch.tensor(0, dtype=torch.int32)
    with pytest.raises(TypeError):
        repair.repair_segments(z.long(), z, z, z, z, z[:4], z[:4], rc, 4,
                               stats)
    with pytest.raises(ValueError):
        repair.repair_segments(z, z, z, z, z, z[:4], z[:3], rc, 4, stats)
    with pytest.raises(ValueError):
        repair.repair_segments(z, z, z, z, z, z[:4], z[:4], rc, 4,
                               stats[:2])
