"""ESA index object: the recursion substrate of the aligner.

Re-expresses the reference's RevealIndex (reveallib/reveal.h,
interface.c) as a host-side object over numpy arrays (the suffix array and LCP from
``suffix.build_esa``):

* global (main-index) state shared by all segments: the mutable text ``T``
  (lowercasing marks aligned positions), the shared inverse array ``SAi``
  (rewritten per child on split, like reveal.c:597,609,630), the
  sample-origin array ``SO`` and sentinel table ``nsep``;
* per-segment state: ``SA``/``LCP`` slices, recursion ``depth``, the node
  intervals covered, bounding left/right nodes and a precomputed-chain
  carry (``skipmums``).

``split`` is the stable 3-way partition with running-min LCP
(reveal.c:582-664) vectorized with reduceat; ``repair_leading`` is the
insertion re-sort fixing suffixes whose LCP crosses a new match boundary
(bubble_sort, reveal.c:666-727).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from . import mums as mums_mod
from .suffix import build_esa


@dataclass
class MainState:
    """State owned by the root index, shared by all segments."""

    T: np.ndarray  # uint8, mutable (lowercasing)
    SAi: np.ndarray  # int64, mutable (rewritten on split)
    SO: np.ndarray
    nsep: np.ndarray  # int64; nsep[k] = final '$' of sample k
    nsamples: int
    nT: int


class ESAIndex:
    """One segment of the recursion (the root segment after construct())."""

    def __init__(
        self,
        main: MainState,
        SA: np.ndarray,
        LCP: np.ndarray,
        depth: int = 0,
        nsamples: Optional[int] = None,
        nodes: Optional[set] = None,
        left_node=None,
        right_node=None,
        skipmums: Optional[list] = None,
    ):
        self.main = main
        self.SA = SA
        self.LCP = LCP
        self.depth = depth
        self.nsamples = main.nsamples if nsamples is None else nsamples
        self.nodes = set() if nodes is None else nodes
        self.left_node = left_node
        self.right_node = right_node
        self.skipmums = [] if skipmums is None else skipmums

    # -- convenience accessors mirroring reveallib getters ------------------
    @property
    def n(self) -> int:
        return len(self.SA)

    @property
    def T(self) -> np.ndarray:
        return self.main.T

    @property
    def nsep(self) -> np.ndarray:
        return self.main.nsep

    # ----------------------------------------------------------------------
    @classmethod
    def construct(cls, textstore) -> "ESAIndex":
        """Build the root index from a TextStore (interface.c:160-291)."""
        T, SO, nsep = textstore.build()
        SA, LCP, SAi = build_esa(T)
        main = MainState(
            T=T,
            SAi=SAi,
            SO=SO,
            nsep=nsep,
            nsamples=textstore.nsamples,
            nT=len(T),
        )
        return cls(main, SA, LCP, depth=0)

    # -- MUM enumeration ----------------------------------------------------
    def getmums_rem(self, minl: int = 0):
        return mums_mod.pairwise_mums(
            self.main.T,
            self.SA,
            self.LCP,
            int(self.main.nsep[0]),
            minl=minl,
            nT=self.main.nT,
            rem_format=True,
        )

    def getmultimums(self, minlength: int = 0, minn: int = 2):
        return mums_mod.multimums(
            self.main.T,
            self.SA,
            self.LCP,
            self.main.SO,
            self.main.nsamples,
            minl=minlength,
            minn=minn,
        )

    # -- sample counting over intervals (reveal.c:1028-1042) ---------------
    def _count_samples(self, intervals) -> int:
        seen = set()
        for begin, _ in intervals:
            seen.add(int(self.main.SO[begin]))
        return len(seen)

    # -- the split ----------------------------------------------------------
    def split_segments(
        self,
        leading: set,
        trailing: set,
        matching: set,
        rest: set,
        mum_positions: List[int],
        mum_l: int,
        newleftnode,
        newrightnode,
        skipleft=None,
        skipright=None,
    ):
        """Classify + 3-way split, mirroring aligner()'s post-callback work
        (reveal.c:1005-1324).  Returns (leading_idx, trailing_idx,
        parallel_idx), any of which may be None.

        Side effects on shared state, matching the C engine:
        * T is lowercased over the matched occurrences;
        * SAi is rewritten for all suffixes that land in a child;
        * the leading child's SA/LCP get the boundary repair pass.
        """
        main = self.main
        n = self.n
        # classification is segment-local: the C engine writes D[SAi[j]]
        # (SAi maps text positions of this segment's nodes to their slot in
        # this segment's SA); class order matters — matched (3) overwrites
        # last
        D_sa = np.zeros(n, dtype=np.uint8)
        for begin, end in leading:
            D_sa[main.SAi[begin:end]] = 1
        for begin, end in trailing:
            D_sa[main.SAi[begin:end]] = 2
        for begin, end in rest:
            D_sa[main.SAi[begin:end]] = 4
        for pos in mum_positions:
            D_sa[main.SAi[pos : pos + mum_l]] = 3
        children = self._split_np(D_sa)

        # lowercase matched text (reveal.c:1230-1234)
        for pos in mum_positions:
            t = main.T[pos : pos + mum_l]
            low = (t >= ord("A")) & (t <= ord("Z"))
            t[low] += 32

        return self._make_children(
            children,
            leading,
            trailing,
            matching,
            rest,
            newleftnode,
            newrightnode,
            skipleft,
            skipright,
        )

    def _split_np(self, D_sa):
        """The stable 3-way split."""
        main = self.main
        children = []
        for cls_id in (1, 2, 4):
            sel = D_sa == cls_id
            cnt = int(sel.sum())
            if cnt == 0:
                children.append(None)
                continue
            pos_in_parent = np.nonzero(sel)[0]
            child_sa = self.SA[pos_in_parent]
            # running-min LCP over the gap (split(), reveal.c:582-664):
            # child_LCP[j] = min(parent_LCP[p_{j-1}+1 .. p_j]), first = 0
            if cnt == 1:
                child_lcp = np.zeros(1, dtype=self.LCP.dtype)
            else:
                starts = pos_in_parent[:-1] + 1
                ends = pos_in_parent[1:]
                # min over [starts_j, ends_j] inclusive via reduceat on the
                # concatenated ranges: segments [p_{j-1}+1, p_j] partition
                # (p_0, p_last], so reduceat boundaries = starts
                mins = np.minimum.reduceat(self.LCP, starts)
                # reduceat's last segment runs to the end of LCP; trim by
                # recomputing it only over [starts[-1], ends[-1]]
                mins[-1] = self.LCP[starts[-1] : ends[-1] + 1].min()
                child_lcp = np.concatenate(
                    [np.zeros(1, dtype=self.LCP.dtype), mins]
                )
            main.SAi[child_sa] = np.arange(cnt)
            children.append((child_sa, child_lcp))

        # reduceat caveat: segments between consecutive starts are
        # [starts[j], starts[j+1]) = [p_{j-1}+1, p_j+1) = [p_{j-1}+1, p_j] ✓
        return children

    def _make_children(
        self,
        children,
        leading,
        trailing,
        matching,
        rest,
        newleftnode,
        newrightnode,
        skipleft,
        skipright,
    ):
        main = self.main
        newdepth = self.depth + 1
        lead_idx = trail_idx = par_idx = None
        if children[0] is not None:
            sa, lcp = children[0]
            lead_idx = ESAIndex(
                main,
                sa,
                lcp,
                depth=newdepth,
                nsamples=self._count_samples(leading),
                nodes=set(leading),
                left_node=self.left_node,
                right_node=newrightnode,
                skipmums=list(skipleft or []),
            )
            _repair_leading(lead_idx, sorted(matching))
        if children[1] is not None:
            sa, lcp = children[1]
            trail_idx = ESAIndex(
                main,
                sa,
                lcp,
                depth=newdepth,
                nsamples=self._count_samples(trailing),
                nodes=set(trailing),
                left_node=newleftnode,
                right_node=self.right_node,
                skipmums=list(skipright or []),
            )
        if children[2] is not None:
            sa, lcp = children[2]
            par_idx = ESAIndex(
                main,
                sa,
                lcp,
                depth=newdepth,
                nsamples=self._count_samples(rest),
                nodes=set(rest),
                left_node=self.left_node,
                right_node=self.right_node,
                skipmums=[],
            )
        return lead_idx, trail_idx, par_idx

def _repair_leading(idx: ESAIndex, matching_intervals):
    """Port of bubble_sort (reveal.c:666-727): for every new matching
    interval, suffixes that start before the match and whose LCP crosses the
    match start are re-inserted at their corrected position with truncated
    LCP; following entries get their LCP capped.  Candidate indices are
    prefiltered (equivalent to the C original's full scan: entries past the
    current scan position never move, and every in-place mutation only
    lowers LCPs or writes values that cannot enable a new firing at an
    already-passed index)."""
    _repair_leading_py(idx, matching_intervals)


def _repair_leading_py(idx: ESAIndex, matching_intervals):
    SA = idx.SA
    LCP = idx.LCP
    SAi = idx.main.SAi
    n = len(SA)
    if n == 0:
        return
    for begin, _end in matching_intervals:
        # candidate scan: only indices where one of the two branches can
        # fire, processed in ascending order on the mutating arrays
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
                # walk back while LCP[x] >= thr
                x = i
                while x > 0 and LCP[x] >= thr:
                    x -= 1
                if x < i:
                    SA[x + 1 : i + 1] = SA[x:i]
                    LCP[x + 1 : i + 1] = LCP[x:i]
                    SAi[SA[x + 1 : i + 1]] = np.arange(x + 1, i + 1)
                SA[x] = tmp_sa
                SAi[tmp_sa] = x
                LCP[x + 1] = thr
                if i < n - 1 and tmp_lcp < LCP[i + 1]:
                    LCP[i + 1] = tmp_lcp
            else:
                if (
                    i < n - 1
                    and SA[i] < begin
                    and SA[i] + LCP[i + 1] > begin
                    and LCP[i + 1] > LCP[i]
                ):
                    LCP[i + 1] = begin - SA[i]
