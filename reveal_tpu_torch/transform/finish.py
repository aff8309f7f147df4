"""Finish: order and orient draft contigs into pseudomolecules.

Functional equivalent of the reference's `reveal finish`
(reveal/transformold.py:100-733), with the full
contig-chain machinery:

* MUM extraction in both orientations (transformold.py:1114-1168) via the
  ESA index (device/native SA build) instead of per-orientation
  re-indexing subprocesses;
* per-(contig, chromosome) diagonal clustering (transformold.py:1242-1312);
* iterative local-MUM cluster extension (transformold.py:1170-1240);
* per-contig chain decomposition in both orientations
  (`mempathsbothdirections`/`decompose_contig`, transformold.py:801-971,
  1379-1540) so chimeric/misassembled contigs are split across
  chromosomes;
* chains- or contigs-to-reference layout (transformold.py:973-1091),
  best non-overlapping path per chromosome with overlap penalties
  (`bestctgpath`, transformold.py:1314-1377);
* joining of consecutive chains and re-insertion of unchained sequence
  (`joinchains`/`addunchained`, transformold.py:735-799);
* fasta or GFA graph output incl. '*'-prefixed original-layout paths
  (transformold.py:347-733), --split, and .unplaced.fasta.

Deviations from the reference, by design:
* predecessor candidates in the chain DP are found with a vectorized
  numpy rectangle query instead of the hand-rolled kd-tree
  (utils.py:983-1033); candidate *tie* order (equal scores) follows mum
  input order rather than kd-tree traversal order;
* `mempathsbothdirections` keeps distinct clusters that share an endpoint
  (the reference's endpoint->mum dict keeps only the last,
  transformold.py:1414-1424).
"""

from __future__ import annotations

import logging
import os
import uuid
from dataclasses import dataclass
from math import log as _ln
from typing import Dict, List, Optional

from ..core.encoding import rc_str
from ..core.io_fasta import fasta_reader, fasta_writer
from ..core.textstore import TextStore
from ..index.esa_index import ESAIndex
from .blocks import addctginfo

log = logging.getLogger(__name__)


@dataclass
class FinishConfig:
    minlength: int = 15  # -m; 0 = auto-determine by coverage
    cutn: int = 1000
    maxdist: int = 90
    mincluster: int = 20
    mineventsize: int = 1500
    minchainsum: int = 1000
    maxmums: int = 0  # 0 = use all
    extiter: int = 3
    maxextend: int = 200
    minlocallength: int = 20
    order: str = "contigs"  # contigs | chains
    outputtype: str = "fasta"  # fasta | graph
    allcontigs: bool = True
    fixedsize: bool = False
    gapsize: int = 100
    outputunmapped: bool = True
    toupper: bool = True  # reference --softmask default (True = uppercase)
    backend: str = "auto"
    # legacy alias used by earlier CLI revisions: fixed gap length
    fixedgapsize: Optional[int] = None

    def __post_init__(self):
        if self.fixedgapsize is not None:
            self.fixedsize = True
            self.gapsize = self.fixedgapsize


# ---------------------------------------------------------------------------
# MUM extraction (transformold.py:1114-1168)
# ---------------------------------------------------------------------------

def extract_mums(reference: str, contigs: str, cfg: FinishConfig):
    """Returns (mums, ref2seq, ctg2seq) where mums are
    (refchrom, refstart, ctg, ctgstart, l, o) with per-sequence relative
    coordinates; for o==1 ctgstart is the leftmost position of the match
    on the forward contig strand (transformold.py:1152-1161)."""
    ts = TextStore()
    names: List[str] = []
    ref2seq: Dict[str, str] = {}
    ctg2seq: Dict[str, str] = {}
    ctg2range = []
    for sample in (reference, contigs):
        ts.add_sample(os.path.basename(sample))
        reader = (
            fasta_reader(sample, toupper=cfg.toupper)
            if sample == reference
            else fasta_reader(sample, cutN=cfg.cutn, toupper=cfg.toupper)
        )
        for name, seq in reader:
            iv = ts.add_sequence(seq)
            ctg2range.append(iv)
            names.append(name)
            if sample == reference:
                ref2seq[name] = seq
            else:
                ctg2seq[name] = seq

    nref = len(ref2seq)
    minl = cfg.minlength if cfg.minlength != 0 else 1

    idx = ESAIndex.construct(ts, backend=cfg.backend)
    raw = addctginfo(idx.getmums(minl), ctg2range)
    idx_rc = ESAIndex.construct(ts, backend=cfg.backend, rc=True)
    raw += addctginfo(idx_rc.getmums(minl), ctg2range)

    mums = []
    for l, (a, b), o, refi, ctgi in raw:
        if refi >= nref or ctgi < nref:
            continue  # ref-ref or ctg-ctg pairs cannot occur (straddle)
        mums.append(
            (
                names[refi],
                a - ctg2range[refi][0],
                names[ctgi],
                b - ctg2range[ctgi][0],
                l,
                o,
            )
        )
    return mums, ref2seq, ctg2seq


def mapmumstocontig(mums):
    """transformold.py:1093-1112: ctg -> ref -> [[refstart,ctgstart,l,o]]."""
    ctg2mums: Dict[str, Dict[str, list]] = {}
    for refchrom, refstart, ctg, ctgstart, l, o in mums:
        ctg2mums.setdefault(ctg, {}).setdefault(refchrom, []).append(
            [int(refstart), int(ctgstart), int(l), int(o)]
        )
    return ctg2mums


# ---------------------------------------------------------------------------
# diagonal clustering (transformold.py:1242-1312)
# ---------------------------------------------------------------------------

def clustermumsbydiagonal(ctg2mums, maxdist=90, minclustsize=65):
    before = after = 0
    ctg2clusters: Dict[str, Dict[str, list]] = {}
    for ctg in ctg2mums:
        ctg2clusters[ctg] = {}
        for ref in ctg2mums[ctg]:
            allmums = ctg2mums[ctg][ref]
            before += len(allmums)
            rcmums = sorted(
                (tuple(m) for m in allmums if m[3] == 1),
                key=lambda m: (m[0] + (m[1] + m[2]), m[0] - (m[1] + m[2])),
            )
            mums = sorted(
                (tuple(m) for m in allmums if m[3] == 0),
                key=lambda m: (m[0] - m[1], m[0] + m[1]),
            )

            clusters = []
            if mums:
                pmum = mums[0]
                clusters = [mums[0]]
                for mum in mums[1:]:
                    if mum[0] - mum[1] == pmum[0] - pmum[1]:  # same diagonal
                        if mum[0] + mum[2] < pmum[0] + pmum[2]:
                            continue  # contained on reference domain
                        ddist = (mum[0] + mum[1]) - (
                            pmum[0] + pmum[2] + pmum[1] + pmum[2]
                        )
                        if ddist < maxdist:
                            active = clusters[-1]
                            clusters[-1] = (
                                active[0],
                                active[1],
                                (mum[0] + mum[2]) - active[0],
                                active[3],
                            )
                        else:
                            clusters.append(mum)
                    else:
                        clusters.append(mum)
                    pmum = mum

            rcclusters = []
            if rcmums:
                pmum = rcmums[0]
                rcclusters = [rcmums[0]]
                for mum in rcmums[1:]:
                    if (mum[0] + (mum[1] + mum[2])) == (
                        pmum[0] + (pmum[1] + pmum[2])
                    ):  # same anti-diagonal
                        if mum[0] + mum[2] < pmum[0] + pmum[2]:
                            continue
                        ddist = (mum[0] - (mum[1] + mum[2])) - (
                            (pmum[0] + pmum[2]) - pmum[1]
                        )
                        if ddist < maxdist:
                            active = rcclusters[-1]
                            rcclusters[-1] = (
                                active[0],
                                mum[1],
                                (mum[0] + mum[2]) - active[0],
                                active[3],
                            )
                        else:
                            rcclusters.append(mum)
                    else:
                        rcclusters.append(mum)
                    pmum = mum

            cl = [c for c in clusters + rcclusters if c[2] > minclustsize]
            after += len(cl)
            ctg2clusters[ctg][ref] = cl
    log.info("Clustered %d mums into %d clusters.", before, after)
    return ctg2clusters


# ---------------------------------------------------------------------------
# local-MUM cluster extension (transformold.py:1170-1240)
# ---------------------------------------------------------------------------

def _local_mums(subref: str, subctg: str, minl: int):
    """Pairwise MUMs between two short strings, coordinates in the
    concatenated 'subref$subctg$' text (matching reveallib getmums
    position semantics: ctg positions offset by len(subref)+1)."""
    ts = TextStore()
    ts.add_sample("ref")
    ts.add_sequence(subref)
    ts.add_sample("ctg")
    ts.add_sequence(subctg)
    T, SO, nsep = ts.build()
    import numpy as np

    from ..index.mums import pairwise_mums
    from ..index.suffix import lcp_from_sa_np, suffix_array_np

    SA = suffix_array_np(T).astype(np.int64)
    LCP = lcp_from_sa_np(T, SA).astype(np.int64)
    return pairwise_mums(
        T, SA, LCP, int(nsep[0]), minl=minl, rem_format=False
    )


def extend(ctg2mums, ctg2seq, ref2seq, maxextend=200, minlocallength=20):
    """Add locally-unique MUMs around every cluster's ends
    (transformold.py:1170-1240, coordinate remaps preserved)."""
    ctg2ext = {}
    for ctg in ctg2mums:
        ctg2ext[ctg] = {}
        for ref in ctg2mums[ctg]:
            ext = [tuple(m) for m in ctg2mums[ctg][ref]]
            for refstart, ctgstart, cl, o in ctg2mums[ctg][ref]:
                if o == 0:
                    subref = ref2seq[ref][max(refstart - maxextend, 0):refstart]
                    subctg = ctg2seq[ctg][max(ctgstart - maxextend, 0):ctgstart]
                    if subctg and subref:
                        for l, sps, _r in _local_mums(
                            subref, subctg, minlocallength
                        ):
                            ext.append(
                                (
                                    sps[0] + refstart - len(subref),
                                    sps[1]
                                    - (len(subref) + 1)
                                    + ctgstart
                                    - len(subctg),
                                    l,
                                    o,
                                )
                            )
                    subref = ref2seq[ref][refstart + cl:refstart + cl + maxextend]
                    subctg = ctg2seq[ctg][ctgstart + cl:ctgstart + cl + maxextend]
                    if subctg and subref:
                        for l, sps, _r in _local_mums(
                            subref, subctg, minlocallength
                        ):
                            ext.append(
                                (
                                    sps[0] + refstart + cl,
                                    sps[1]
                                    + ctgstart
                                    + cl
                                    - (len(subref) + 1),
                                    l,
                                    o,
                                )
                            )
                else:  # reverse complement
                    subref = ref2seq[ref][max(refstart - maxextend, 0):refstart]
                    subctg = rc_str(
                        ctg2seq[ctg][ctgstart + cl:ctgstart + cl + maxextend]
                    )
                    if subctg and subref:
                        for l, sps, _r in _local_mums(
                            subref, subctg, minlocallength
                        ):
                            ext.append(
                                (
                                    sps[0] + refstart - len(subref),
                                    ctgstart
                                    + cl
                                    + (
                                        len(subctg)
                                        - (sps[1] - (len(subref) + 1))
                                        - l
                                    ),
                                    l,
                                    o,
                                )
                            )
                    subref = ref2seq[ref][refstart + cl:refstart + cl + maxextend]
                    subctg = rc_str(
                        ctg2seq[ctg][max(ctgstart - maxextend, 0):ctgstart]
                    )
                    if subctg and subref:
                        for l, sps, _r in _local_mums(
                            subref, subctg, minlocallength
                        ):
                            ext.append(
                                (
                                    sps[0] + refstart + cl,
                                    (ctgstart - len(subctg))
                                    + (
                                        len(subctg)
                                        - (sps[1] - (len(subref) + 1))
                                        - l
                                    ),
                                    l,
                                    o,
                                )
                            )
            ctg2ext[ctg][ref] = [list(m) for m in ext]
    return ctg2ext


# ---------------------------------------------------------------------------
# chain DP per contig (mempathsbothdirections, transformold.py:1379-1540)
# ---------------------------------------------------------------------------

def _gapcost_convex(p1, p2):
    """utils.gapcost(model=sumofpairs, convex=True, lambda_=1, epsilon_=0)
    for 2-D points (utils.py:162-183): log(||dx|-|dy|| + 1)."""
    d0 = abs(p1[0] - p2[0])
    d1 = abs(p1[1] - p2[1])
    return _ln(abs(d0 - d1) + 1)


def mempathsbothdirections(
    mums,
    ctglength,
    n=15000,
    mineventsize=1500,
    minchainsum=1000,
    wscore=1,
    wpen=1,
    all=True,
):
    """Chain clusters into co-linear paths, both orientations competing in
    one score table; repeatedly extract the best chain until the chain sum
    drops below minchainsum (transformold.py:1379-1540).

    mums: [refstart, ctgstart, l, o] cluster tuples.
    Returns [(path, score, o, ctgstart, ctgend, refstart, refend), ...].
    """
    import numpy as np

    mums = [tuple(m) for m in mums]
    if n != 0 and len(mums) > n:
        log.info("Too many mums (%d), taking the %d largest.", len(mums), n)
        mums.sort(key=lambda m: m[2], reverse=True)
        mums = mums[:n]
    if not mums:
        return []

    mums.sort(key=lambda m: m[0] + m[2])  # by reference end position

    init = (None, None, 0, 0, 0, 0)
    link = {}
    score = {init: 0}
    start = init
    end = None

    arr = np.array([[m[0], m[1], m[2], m[3]] for m in mums], dtype=np.int64)
    is_rc = arr[:, 3] == 1
    # endpoint tables per orientation (the kd-tree points,
    # transformold.py:1412-1428)
    ep_ref = arr[:, 0] + arr[:, 2]
    ep_ctg = np.where(is_rc, arr[:, 1], arr[:, 1] + arr[:, 2])

    maxscore = 0
    scores_arr = np.zeros(len(mums), dtype=np.float64)
    for i, mem in enumerate(mums):
        best = init
        w = wscore * mem[2]
        if mem[3] == 1:
            lo = (mem[0] - mineventsize, mem[1])
            hi = (mem[0] + mem[2] - 1, mem[1] + (mem[2] - 1) + mineventsize)
        else:
            lo = (mem[0] - mineventsize, mem[1] - mineventsize)
            hi = (mem[0] + mem[2] - 1, mem[1] + mem[2] - 1)
        cand = np.nonzero(
            (is_rc == (mem[3] == 1))
            & (ep_ref >= lo[0])
            & (ep_ref <= hi[0])
            & (ep_ctg >= lo[1])
            & (ep_ctg <= hi[1])
        )[0]
        if len(cand):
            order = cand[np.argsort(-scores_arr[cand], kind="stable")]
            for j in order.tolist():
                amem = mums[j]
                if scores_arr[j] + (wscore * mem[2]) < w:
                    break
                if mem[3] == 1:
                    p1 = (mem[0], mem[1] + mem[2])
                    p2 = (amem[0] + amem[2], amem[1])
                else:
                    p1 = (amem[0] + amem[2], amem[1] + amem[2])
                    p2 = (mem[0], mem[1])
                penalty = _gapcost_convex(p1, p2)
                tmpw = scores_arr[j] + (wscore * mem[2]) - (wpen * penalty)
                if tmpw > w:
                    w = tmpw
                    best = amem
        link[mem] = best
        score[mem] = w
        scores_arr[i] = w
        if w > maxscore:
            maxscore = w
            end = mem

    paths = []
    while link:
        path = []
        o = end[3]
        while end != start:
            tmp = tuple(end)
            path.append(tmp)
            end = link[tmp]
            del link[tmp]
            del score[tmp]
            if end not in link:
                break

        chainsum = sum(m[2] for m in path)
        if chainsum < minchainsum:
            break

        refstart = path[-1][0]
        refend = path[0][0] + path[0][2]
        if o == 1:
            ctgstart = path[-1][1] + path[-1][2]
            ctgend = path[0][1]
        else:
            ctgstart = path[-1][1]
            ctgend = path[0][1] + path[0][2]
        paths.append((path, maxscore, o, ctgstart, ctgend, refstart, refend))

        if not all:
            return paths

        # re-link surviving mums: scores restart at chain roots
        # (transformold.py:1524-1537)
        mems = sorted(link, key=lambda m: m[0])
        maxscore = None
        score = {}
        for mem in mems:
            if link[mem] not in score:
                score[mem] = mem[2]
                link[mem] = start
            else:
                score[mem] = mem[2] + score[link[mem]]
            if maxscore is None or score[mem] > maxscore:
                maxscore = score[mem]
                end = mem

    log.info("Detected number of chains: %d.", len(paths))
    return paths


# ---------------------------------------------------------------------------
# chain selection per contig (decompose_contig, transformold.py:801-971)
# ---------------------------------------------------------------------------

class _ITree:
    """Minimal interval container with intervaltree-compatible overlap
    queries ([a:b] -> intervals overlapping the half-open range)."""

    def __init__(self):
        self.iv = []

    def add(self, s, e, v):
        self.iv.append((s, e, v))

    def overlap(self, s, e):
        return [(a, b, v) for (a, b, v) in self.iv if a < e and b > s]


def decompose_contig(
    ctg, mums, contiglength, mineventsize=1500, minchainsum=1000, maxmums=15000
):
    """Candidate chains across all chromosomes; greedy selection of
    non-contained chains with overlap trimming (transformold.py:801-971)."""
    paths = []
    for ref in mums:
        for path, score, rcf, ctgstart, ctgend, refstart, refend in (
            mempathsbothdirections(
                mums[ref],
                contiglength,
                n=maxmums,
                mineventsize=mineventsize,
                minchainsum=minchainsum,
            )
        ):
            if path:
                paths.append(
                    (score, ctgstart, ctgend, refstart, refend, ref, rcf, path)
                )
    if not paths:
        return paths

    paths.sort(key=lambda c: c[0], reverse=True)  # by score, best first

    selectedpaths = []
    cit = _ITree()
    # Deviation from the reference: transformold.py:835-836 shares ONE
    # reference-domain interval tree across all chromosomes, so chains of
    # a chimeric contig landing on different chromosomes at overlapping
    # coordinate ranges wrongly trim/drop each other — defeating the
    # purpose of chain decomposition.  We keep one tree per chromosome.
    rits: Dict[str, _ITree] = {}
    for path in paths:
        score, ctgstart, ctgend, refstart, refend, ref, revcomp, p = path
        rit = rits.setdefault(ref, _ITree())
        if revcomp:
            ctgend, ctgstart = ctgstart, ctgend

        # drop mums contained in already-claimed ranges
        np_ = []
        for mum in p:
            contained = False
            for s, e, _v in rit.overlap(mum[0], mum[0] + mum[2]):
                if s <= mum[0] and e >= mum[0] + mum[2]:
                    contained = True
                    break
            if not contained:
                for s, e, _v in cit.overlap(mum[1], mum[1] + mum[2]):
                    if s <= mum[1] and e >= mum[1] + mum[2]:
                        contained = True
                        break
            if not contained:
                np_.append(mum)
        if not np_:
            continue

        refstart = min(m[0] for m in np_)
        refend = max(m[0] + m[2] for m in np_)
        ctgstart = min(m[1] for m in np_)
        ctgend = max(m[1] + m[2] for m in np_)

        if revcomp:
            path = (score, ctgend, ctgstart, refstart, refend, ref, revcomp, p)
        else:
            path = (score, ctgstart, ctgend, refstart, refend, ref, revcomp, p)
        assert ctgstart < ctgend

        s = cit.overlap(ctgstart, ctgend)
        sr = rit.overlap(refstart, refend)

        if not s and not sr:
            cit.add(ctgstart, ctgend, path)
            rit.add(refstart, refend, path)
            selectedpaths.append(path)
            continue

        if any(a <= ctgstart and b >= ctgend for a, b, _v in s):
            continue  # contained on contig domain
        if any(a <= refstart and b >= refend for a, b, _v in sr):
            continue  # contained on reference domain
        if len(s) > 2 or len(sr) > 2:
            continue

        # trim contig-domain overlaps (transformold.py:894-917)
        ok = True
        for a, b, _v in s:
            if ctgstart <= a and ctgend >= b:
                ctgend = ctgstart  # contains a better-scoring chain
                break
            if ctgstart <= a:  # left overlap
                if revcomp:
                    refstart += ctgend - a
                else:
                    refend -= ctgend - a
                ctgend = a
            if ctgend >= b:  # right overlap
                if revcomp:
                    refend -= b - ctgstart
                else:
                    refstart += b - ctgstart
                ctgstart = b
            if ctgend - ctgstart < mineventsize:
                ok = False
                break
            if refend - refstart < mineventsize:
                ok = False
                break
        else:
            ok = True
        if not ok or ctgend <= ctgstart:
            continue
        assert refend >= refstart

        # trim reference-domain overlaps (transformold.py:923-951)
        sr = rit.overlap(refstart, refend)
        ok = True
        for a, b, _v in sr:
            if refstart <= a and refend >= b:
                refend = refstart
                break
            if refstart <= a:
                if revcomp:
                    ctgstart += refend - a
                else:
                    ctgend -= refend - a
                refend = a
            if refend >= b:
                if revcomp:
                    ctgend -= b - refstart
                else:
                    ctgstart += b - refstart
                refstart = b
            if ctgend - ctgstart < mineventsize:
                ok = False
                break
            if refend - refstart < mineventsize:
                ok = False
                break
        if not ok:
            continue
        assert ctgend >= ctgstart

        if ctgend > ctgstart and refend > refstart:
            if (
                refend - refstart > mineventsize
                and ctgend - ctgstart > mineventsize
            ):
                if revcomp:
                    path = (
                        score, ctgend, ctgstart, refstart, refend, ref,
                        revcomp, p,
                    )
                else:
                    path = (
                        score, ctgstart, ctgend, refstart, refend, ref,
                        revcomp, p,
                    )
                cit.add(ctgstart, ctgend, path)
                rit.add(refstart, refend, path)
                selectedpaths.append(path)

    # sort by end position on contig (transformold.py:969)
    return sorted(selectedpaths, key=lambda c: c[1] if c[6] else c[2])


def map_contig(
    ctg, mums, contiglength, mineventsize=1500, minchainsum=1000, maxmums=15000
):
    """Best single chain per chromosome (transformold.py:1042-1051)."""
    paths = []
    for ref in mums:
        mpaths = mempathsbothdirections(
            mums[ref],
            contiglength,
            n=maxmums,
            all=False,
            mineventsize=mineventsize,
            minchainsum=minchainsum,
        )
        if mpaths:
            path, score, o, ctgstart, ctgend, refstart, refend = mpaths[0]
            paths.append(
                (score, ctgstart, ctgend, refstart, refend, ref, o, path)
            )
    return paths


# ---------------------------------------------------------------------------
# layout tables (chainstorefence / contigstorefence, transformold.py:973-1091)
# ---------------------------------------------------------------------------

def chainstorefence(
    ctg2mums,
    contig2length,
    mineventsize=1500,
    minchainsum=1000,
    maxmums=15000,
):
    ref2ctg = {"unchained": {}}
    ctg2ref = {}
    for ctg in ctg2mums:
        unchained = ref2ctg["unchained"].setdefault(ctg, [])
        paths = decompose_contig(
            ctg,
            ctg2mums[ctg],
            contig2length[ctg],
            mineventsize=mineventsize,
            minchainsum=minchainsum,
            maxmums=maxmums,
        )
        if not paths:
            log.info("No valid chains found for contig: %s", ctg)
            unchained.append((0, contig2length[ctg], 0))
            continue
        log.info("Found %d chains for contig: %s", len(paths), ctg)
        offset = 0
        i = 0
        for i, path in enumerate(paths):
            score, ctgstart, ctgend, refstart, refend, ref, revcomp, chain = (
                path
            )
            assert (ctgend < ctgstart) if revcomp else (ctgstart < ctgend)
            entry = (
                ctg, revcomp, score, refstart, refend, ctgstart, ctgend,
                contig2length[ctg], i,
            )
            ref2ctg.setdefault(ref, []).append(entry)
            ctg2ref.setdefault(ctg, []).append(
                (
                    ref, revcomp, score, refstart, refend, ctgstart, ctgend,
                    contig2length[ctg], i,
                )
            )
            if revcomp == 1:
                ctgstart, ctgend = ctgend, ctgstart
            if offset != ctgstart:
                unchained.append((offset, ctgstart, i))
            offset = ctgend
        if offset != contig2length[ctg]:
            assert offset < contig2length[ctg]
            unchained.append((offset, contig2length[ctg], i))
    return ref2ctg, ctg2ref


def contigstorefence(
    ctg2mums,
    contig2length,
    mineventsize=1500,
    minchainsum=1000,
    maxmums=15000,
):
    ref2ctg = {"unplaced": []}
    ctg2ref = {}
    # contigs without any MUM: the reference drops these from every output
    # (transformold.py:1071 iterates ctg2mums only); we report them
    # unplaced so no sequence is silently lost
    for ctg in contig2length:
        if ctg not in ctg2mums:
            ref2ctg["unplaced"].append(ctg)
    for ctg in ctg2mums:
        paths = map_contig(
            ctg,
            ctg2mums[ctg],
            contig2length[ctg],
            mineventsize=mineventsize,
            minchainsum=minchainsum,
            maxmums=maxmums,
        )
        if not paths:
            ref2ctg["unplaced"].append(ctg)
            continue
        paths.sort(key=lambda p: p[0], reverse=True)
        score, ctgstart, ctgend, refstart, refend, ref, revcomp, chain = (
            paths[0]
        )
        ref2ctg.setdefault(ref, []).append(
            (
                ctg, revcomp, score, refstart, refend, ctgstart, ctgend,
                contig2length[ctg], 0,
            )
        )
        ctg2ref.setdefault(ctg, []).append(
            (
                ref, revcomp, score, refstart, refend, ctgstart, ctgend,
                contig2length[ctg], 0,
            )
        )
    return ref2ctg, ctg2ref


# ---------------------------------------------------------------------------
# best non-overlapping layout per chromosome (transformold.py:1314-1377)
# ---------------------------------------------------------------------------

def bestctgpath(chains):
    chains = sorted(chains, key=lambda c: (c[3], c[4]))  # by reference
    start = (0, 0, 0, 0, 0, 0, 0, 0, 0)
    link = {}
    score = {start: 0}
    processed = []
    active = [start]
    maxscore = 0
    end = None

    for chain in chains:
        _n, _rc, cscore, refbegin, refend, _cb, _ce, _cl, _ci = chain
        remove = []
        for pctg in processed:
            if pctg[4] <= refend:
                active.append(pctg)
                remove.append(pctg)
        for r in remove:
            processed.remove(r)

        best = start
        w = 0
        for actg in active:
            arefend = actg[4]
            if arefend >= refend:
                continue
            penalty = arefend - refbegin if arefend > refbegin else 0
            tmpw = score[actg] + cscore - penalty
            if tmpw > w:
                w = tmpw
                best = actg
        link[chain] = best
        score[chain] = w
        if w > maxscore:
            maxscore = w
            end = chain
        processed.append(chain)

    path = []
    if end is not None:
        while end[0] != start[0]:
            path.append(end)
            end = link[end]
    return path[::-1]


# ---------------------------------------------------------------------------
# chain joining + unchained bookkeeping (transformold.py:735-799)
# ---------------------------------------------------------------------------

def joinchains(ref2ctg, ctg2ref, ref2length, contig2length):
    extref2ctg = {}
    extctg2ref = {}
    for ref in ref2ctg:
        if ref == "unchained":
            continue
        ref2ctg[ref] = sorted(ref2ctg[ref], key=lambda c: c[4])
        extref2ctg[ref] = []
        for chain in ref2ctg[ref]:
            ctgname, revcomp, score, refstart, refend, ctgstart, ctgend, l, ci = chain
            if extref2ctg[ref]:
                (
                    pctgname, prevcomp, pscore, prefstart, prefend,
                    pctgstart, pctgend, pl, pci,
                ) = extref2ctg[ref][-1]
                if pctgname == ctgname and revcomp == prevcomp:
                    if (not revcomp and ci == pci + 1) or (
                        revcomp and ci == pci - 1
                    ):  # consecutive chains: merge boundaries
                        merged = (
                            pctgname, prevcomp, pscore + score, prefstart,
                            refend, pctgstart, ctgend, pl, ci,
                        )
                        extref2ctg[ref][-1] = merged
                        extctg2ref[ctgname][-1] = (
                            ref, prevcomp, pscore + score, prefstart, refend,
                            pctgstart, ctgend, pl, ci,
                        )
                        continue
            extref2ctg[ref].append(chain)
            extctg2ref.setdefault(ctgname, []).append(
                (
                    ref, revcomp, score, refstart, refend, ctgstart, ctgend,
                    l, ci,
                )
            )
    return extref2ctg, extctg2ref


def addunchained(defref2ctg, defctg2ref, contig2length):
    defref2ctg["unchained"] = {}
    for ctg in contig2length:
        parts = defref2ctg["unchained"].setdefault(ctg, [])
        offset = 0
        if ctg in defctg2ref:
            defctg2ref[ctg].sort(key=lambda c: c[8])
            for ref, revcomp, score, rs, re_, cs, ce, l, ci in defctg2ref[ctg]:
                if revcomp:
                    cs, ce = ce, cs
                if cs > offset:
                    parts.append((offset, cs))
                offset = ce
        assert offset <= contig2length[ctg]
        if offset < contig2length[ctg]:
            parts.append((offset, contig2length[ctg]))


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def finish(
    reference: str,
    contigs: str,
    cfg: FinishConfig,
    output: Optional[str] = None,
    split: bool = False,
):
    """Full finish pipeline (transformold.transform, :100-733).  Returns
    (primary output path, unplaced fasta path or None)."""
    if output is None:
        parts = []
        for f in (os.path.basename(reference), os.path.basename(contigs)):
            parts.append(f[: f.find(".")] if "." in f else f)
        output = "_".join(parts)

    mums, ref2seq, ctg2seq = extract_mums(reference, contigs, cfg)
    if not mums:
        raise RuntimeError("No mums between reference and contigs.")
    ref2length = {k: len(v) for k, v in ref2seq.items()}
    contig2length = {k: len(v) for k, v in ctg2seq.items()}
    totl = sum(contig2length.values())

    if cfg.minlength == 0:
        # auto minlength: keep the largest MUMs up to 1x coverage
        # (transformold.py:174-188)
        mums = sorted(mums, key=lambda m: m[4], reverse=True)
        cov = 0
        i = len(mums) - 1
        for i, m in enumerate(mums):
            cov += m[4]
            if cov / float(totl) > 1:
                break
        if i < len(mums) - 1:
            mums = mums[: i + 1]
            log.info(
                "Over representation of MUMs, auto determined "
                "min-mum-length to %d for cov. of %f",
                mums[-1][4],
                cov / float(totl),
            )

    ctg2mums = mapmumstocontig(mums)
    log.info(
        "Number of contigs that contain MUMs larger than %d: %d.",
        cfg.minlength,
        len(ctg2mums),
    )
    ctg2mums = clustermumsbydiagonal(
        ctg2mums, maxdist=cfg.maxdist, minclustsize=cfg.mincluster
    )
    for _ in range(cfg.extiter):
        log.info("Extend clusters with local mums")
        ctg2mums = extend(
            ctg2mums,
            ctg2seq,
            ref2seq,
            minlocallength=cfg.minlocallength,
            maxextend=cfg.maxextend,
        )
        ctg2mums = clustermumsbydiagonal(
            ctg2mums, maxdist=cfg.maxdist, minclustsize=cfg.mincluster
        )

    log.info("Using %s to layout the assembly.", cfg.order)
    kw = dict(
        maxmums=cfg.maxmums,
        mineventsize=cfg.mineventsize,
        minchainsum=cfg.minchainsum,
    )
    if cfg.order == "chains":
        ref2ctg, ctg2ref = chainstorefence(ctg2mums, contig2length, **kw)
    else:
        ref2ctg, ctg2ref = contigstorefence(ctg2mums, contig2length, **kw)

    # per-chromosome best path + unused-chain bookkeeping
    # (transformold.py:252-341)
    defref2ctg = {}
    unused = []
    for ref in ref2ctg:
        if ref in ("unchained", "unplaced"):
            defref2ctg[ref] = ref2ctg[ref]
            continue
        b = set(ref2ctg[ref])
        defref2ctg[ref] = bestctgpath(ref2ctg[ref])
        a = set(defref2ctg[ref])
        log.debug(
            "Selected %d out of %d %s for layout on %s",
            len(a), len(b), cfg.order, ref,
        )
        for chain in b - a:
            ctgname, revcomp, score, rb, re_, cb, ce, cl, ci = chain
            if cfg.order == "contigs":
                ref2ctg["unplaced"].append(ctgname)
            else:
                unused.append((ctgname, ci))

    if cfg.order == "chains":
        # remove unused chains and renumber chain indices
        # (transformold.py:304-331)
        defctg2ref = {k: list(v) for k, v in ctg2ref.items()}
        unused.sort(reverse=True)
        for name, i in unused:
            defctg2ref[name] = [
                (
                    (rf, rcf, sc, rb, re_, cb, ce, cl, ci - 1)
                    if ci > i
                    else (rf, rcf, sc, rb, re_, cb, ce, cl, ci)
                )
                for rf, rcf, sc, rb, re_, cb, ce, cl, ci in defctg2ref[name]
                if ci != i
            ]
        for ref in sorted(defref2ctg):
            if ref in ("unchained", "unplaced"):
                continue
            for name, i in unused:
                ctgs = []
                for ctg in defref2ctg[ref]:
                    cn, rcf, sc, rb, re_, cb, ce, cl, ci = ctg
                    assert not (cn == name and ci == i)
                    if cn == name and ci > i:
                        ctg = (cn, rcf, sc, rb, re_, cb, ce, cl, ci - 1)
                    ctgs.append(ctg)
                defref2ctg[ref] = ctgs
        log.debug("Join consecutive chains")
        defref2ctg, defctg2ref = joinchains(
            defref2ctg, defctg2ref, ref2length, contig2length
        )
        log.debug("Derive unchained sequence")
        addunchained(defref2ctg, defctg2ref, contig2length)
    else:
        defctg2ref = ctg2ref

    return _emit(
        defref2ctg, defctg2ref, ref2seq, ctg2seq, contig2length, cfg,
        output, split, contigs,
    )


def _emit(
    defref2ctg, defctg2ref, ref2seq, ctg2seq, contig2length, cfg, output,
    split, contigsfile,
):
    """Fasta/graph emission (transformold.py:347-733)."""
    from ..graph.pangraph import MultiPanGraph

    base = os.path.splitext(os.path.basename(contigsfile))[0]
    G = MultiPanGraph()
    gapi = 0

    fa_records = []  # (pseudomolecule name, per-ref fasta text)
    totseqplaced = 0
    totseq = sum(contig2length.values())

    for ref in sorted(defref2ctg):
        if ref in ("unchained", "unplaced"):
            continue
        ctgs = sorted(defref2ctg[ref], key=lambda c: c[3])
        if not ctgs:
            continue

        ctgchromname = base + "_" + ref
        refid = len(G.graph["paths"])
        G.graph["path2id"][ctgchromname] = refid
        G.graph["id2path"][refid] = ctgchromname
        G.graph["paths"].append(ctgchromname)

        startnode = uuid.uuid4().hex
        G.add_node(startnode, offsets={refid: 0}, endpoint=True)
        G.graph["startnodes"].append(startnode)
        endnode = uuid.uuid4().hex
        G.add_node(endnode, offsets={refid: 0}, endpoint=True)
        G.graph["endnodes"].append(endnode)

        for ctg in ctgs:
            p = "*" + base + "_" + ctg[0]
            if p not in G.graph["path2id"]:
                G.graph["path2id"][p] = len(G.graph["paths"])
                G.graph["id2path"][len(G.graph["paths"])] = p
                G.graph["paths"].append(p)

        chunks = []
        o = 0
        pn = None
        pctg = (None, ctgs[0][1], 0, 0, 0, 0, 0, 0, 0)
        for ctg in ctgs:
            ctgname, revcomp, score, refbegin, refend, ctgbegin, ctgend, ctglength, ci = ctg
            if revcomp:
                ctgbegin, ctgend = ctgend, ctgbegin
            (
                pctgname, prevcomp, pscore, prefbegin, prefend, pctgbegin,
                pctgend, pctglength, pci,
            ) = pctg
            if prevcomp:
                pctgbegin, pctgend = pctgend, pctgbegin

            if refend <= prefend:
                raise AssertionError(
                    "Contained contig in best contig path: %s" % ctgname
                )

            if cfg.order == "chains":
                gapsize = refbegin - prefend
                if gapsize < 0 or cfg.fixedsize:
                    gapsize = cfg.gapsize
                event = None
                firstchain = (ci == 0 and revcomp == 0) or (
                    revcomp == 1 and ci == len(defctg2ref[ctgname]) - 1
                )
                plastchain = pctgname is None or (
                    (pci == len(defctg2ref[pctgname]) - 1 and prevcomp == 0)
                    or (prevcomp == 1 and pci == 0)
                )
                if not (firstchain and plastchain):
                    if pctgname != ctgname:
                        event = "translocation between contigs"
                    elif revcomp != prevcomp:
                        event = "inversion"
                    else:
                        event = "translocation within contig"
                    log.info(
                        "Event of type: '%s' between %d and %d.",
                        event, prefend, refbegin,
                    )

                chunks.append("N" * max(gapsize, 1))
                alength = ctgend - ctgbegin
                assert alength > 0
                seq = (
                    rc_str(ctg2seq[ctgname][ctgbegin:ctgend])
                    if revcomp
                    else ctg2seq[ctgname][ctgbegin:ctgend]
                )
                chunks.append(seq)
                totseqplaced += ctgend - ctgbegin

                if cfg.outputtype == "graph":
                    if event is None and pn is not None:
                        G.nodes[pn]["seq"] += seq
                    else:
                        gapseq = "N" * gapsize if gapsize > 0 else ""
                        n = (ctgname, ctgbegin, ctgend, revcomp)
                        G.add_node(
                            n,
                            seq=gapseq + seq,
                            offsets={
                                refid: o,
                                G.graph["path2id"][
                                    "*" + base + "_" + n[0]
                                ]: n[1],
                            },
                        )
                        if pn is not None:
                            G.add_edge(
                                pn, n, ofrom="+", oto="+", paths={refid}
                            )
                        else:
                            G.add_edge(
                                startnode, n, ofrom="+", oto="+",
                                paths={refid},
                            )
                        pn = n
                l = gapsize + alength
            else:  # order == contigs
                alength = contig2length[ctgname]
                if prevcomp:
                    a_prefend = prefend + pctgbegin
                else:
                    a_prefend = prefend + (pctglength - pctgend)
                if revcomp:
                    a_refbegin = refbegin - (alength - ctgend)
                else:
                    a_refbegin = refbegin - ctgbegin
                gapsize = a_refbegin - a_prefend
                if gapsize == 0:
                    gapsize = 1
                if gapsize < 0 or cfg.fixedsize:
                    gapsize = cfg.gapsize
                if pctgname is not None:
                    chunks.append("N" * gapsize)
                totseqplaced += contig2length[ctgname]
                seq = (
                    rc_str(ctg2seq[ctgname])
                    if revcomp
                    else ctg2seq[ctgname]
                )
                chunks.append(seq)

                if cfg.outputtype == "graph":
                    gapi += 1
                    gn = gapi
                    G.add_node(gn, seq="N" * gapsize, offsets={refid: o})
                    if pn is not None:
                        G.add_edge(pn, gn, ofrom="+", oto="+", paths={refid})
                    else:
                        G.add_edge(
                            startnode, gn, ofrom="+", oto="+", paths={refid}
                        )
                    pn = gn
                    n = (ctgname, 0, contig2length[ctgname], revcomp)
                    G.add_node(
                        n,
                        seq=seq,
                        offsets={
                            refid: o + gapsize,
                            G.graph["path2id"]["*" + base + "_" + n[0]]: n[1],
                        },
                    )
                    G.add_edge(pn, n, ofrom="+", oto="+", paths={refid})
                    pn = n
                assert gapsize > 0
                l = gapsize + contig2length[ctgname]

            o += l
            if revcomp:
                pctg = (
                    ctgname, revcomp, score, refbegin, refend, ctgend,
                    ctgbegin, ctglength, ci,
                )
            else:
                pctg = (
                    ctgname, revcomp, score, refbegin, refend, ctgbegin,
                    ctgend, ctglength, ci,
                )

        if cfg.outputtype == "graph" and pn is not None:
            G.add_edge(pn, endnode, ofrom="+", oto="+", paths={refid})
        fa_records.append((ctgchromname, ref, "".join(chunks)))

    # ---- reconnect chains along the draft layout ('*' original paths,
    # transformold.py:658-695) ------------------------------------------
    if cfg.outputtype == "graph" and cfg.order == "chains":
        ctgswithevents = set()
        sortednodes = sorted(
            [n for n in G.nodes if isinstance(n, tuple)]
        )
        if sortednodes:
            pn = sortednodes[0]
            sn = uuid.uuid4().hex
            G.graph["startnodes"].append(sn)
            pid = G.graph["path2id"]["*" + base + "_" + pn[0]]
            G.add_node(sn, offsets={pid: 0}, endpoint=True)
            G.add_edge(
                sn, pn, ofrom="+", oto="+" if pn[3] == 0 else "-",
                paths={pid},
            )
            for n in sortednodes[1:]:
                pid = G.graph["path2id"]["*" + base + "_" + pn[0]]
                nid = G.graph["path2id"]["*" + base + "_" + n[0]]
                if n[0] != pn[0]:
                    sn = uuid.uuid4().hex
                    G.graph["startnodes"].append(sn)
                    G.add_node(sn, offsets={nid: 0}, endpoint=True)
                    G.add_edge(
                        sn, n, ofrom="+", oto="+" if n[3] == 0 else "-",
                        paths={nid},
                    )
                    en = uuid.uuid4().hex
                    G.graph["endnodes"].append(en)
                    G.add_node(en, offsets={pid: 0}, endpoint=True)
                    G.add_edge(
                        pn, en, ofrom="+" if pn[3] == 0 else "-", oto="+",
                        paths={pid},
                    )
                else:
                    ctgswithevents.add("*" + base + "_" + pn[0])
                    G.add_edge(
                        pn, n,
                        ofrom="+" if pn[3] == 0 else "-",
                        oto="+" if n[3] == 0 else "-",
                        paths={pid},
                    )
                pn = n
            pid = G.graph["path2id"]["*" + base + "_" + pn[0]]
            en = uuid.uuid4().hex
            G.graph["endnodes"].append(en)
            G.add_node(en, offsets={pid: 0}, endpoint=True)
            G.add_edge(
                pn, en, ofrom="+" if pn[3] == 0 else "-", oto="+",
                paths={pid},
            )
        if not cfg.allcontigs:
            G.graph["paths"] = [
                s
                for s in G.graph["paths"]
                if s in ctgswithevents or not s.startswith("*")
            ]

    # ---- write outputs -------------------------------------------------
    def _safe(ref):
        return (
            ref.replace(" ", "_").replace("|", "").replace("/", "")
            .replace(";", "").replace(":", "")
        )

    primary = None
    if cfg.outputtype == "fasta":
        if split:
            for name, ref, seq in fa_records:
                fn = output + "_" + _safe(ref) + ".fasta"
                fasta_writer(fn, [("%s (finished using %s)" % (name, ref), seq)])
                primary = primary or fn
        else:
            primary = output + ".fasta"
            fasta_writer(
                primary,
                [
                    ("%s (finished using %s)" % (name, ref), seq)
                    for name, ref, seq in fa_records
                ],
            )
    else:
        from ..core.io_gfa import write_gfa

        primary = write_gfa(G, None, outputfile=output + ".gfa")

    unplacedfa = None
    totsequnplaced = 0
    unrecords = []
    if "unplaced" in defref2ctg:
        for ctgname in defref2ctg["unplaced"]:
            unrecords.append((ctgname, ctg2seq[ctgname]))
            totsequnplaced += contig2length[ctgname]
    if "unchained" in defref2ctg:
        for name in sorted(defref2ctg["unchained"]):
            for part in defref2ctg["unchained"][name]:
                start, end = part[0], part[1]
                unrecords.append(
                    ("%s[%d:%d]" % (name, start, end),
                     ctg2seq[name][start:end])
                )
                totsequnplaced += end - start
    if cfg.outputunmapped:
        unplacedfa = output + ".unplaced.fasta"
        fasta_writer(unplacedfa, unrecords)

    if totseqplaced == 0:
        log.info("No sequence could be placed!")
    else:
        log.info(
            "%.2f%% (%d out of %d) of the assembly was placed with respect "
            "to the reference.",
            (totseqplaced / float(totseq)) * 100, totseqplaced, totseq,
        )
    return primary, unplacedfa
