"""Synteny-block machinery for the transform subcommand.

Blocks are tuples (s1, e1, s2, e2, rc, score, refid, ctgid) over the
concatenated text: [s1, e1) on the reference axis, [s2, e2) on the query
axis, rc in {0, 1}.  Ports of
reveal/transform.py helpers:

* ``addctginfo``           (:184-203)  — attach ref/ctg interval ids
* ``clustermumsbydiagonal``(:562-600)  — merge co-(anti)diagonal mums
* ``merge_consecutive``    (:713-746)
* ``extendblocks``         (:748-799)
* ``remove_overlap_{greedy,conservative}_blocks`` (:1334-1485)
* ``gapcost``              (:1182-1244)
* ``glocalchain``          (:947-1180) — bounded-backtrack DP along one axis
* ``chainscore``/``optimise`` (:801-935)
"""

from __future__ import annotations

import logging
from typing import List, Tuple

log = logging.getLogger(__name__)

Block = Tuple  # (s1,e1,s2,e2,o,score,refid,ctgid)


def addctginfo(mums, ctg2range):
    mums = list(mums)
    mums.sort(key=lambda m: m[1][0])
    intvidx = 0
    for i in range(len(mums)):
        while mums[i][1][0] > ctg2range[intvidx][1]:
            intvidx += 1
        mums[i] = mums[i] + (intvidx,)
    mums.sort(key=lambda m: m[1][1])
    intvidx = 0
    for i in range(len(mums)):
        while mums[i][1][1] > ctg2range[intvidx][1]:
            intvidx += 1
        mums[i] = mums[i] + (intvidx,)
    return mums


def mums_to_blocks(mums):
    return [
        (m[1][0], m[1][0] + m[0], m[1][1], m[1][1] + m[0], m[2], m[0], m[3], m[4])
        for m in mums
    ]


def clustermumsbydiagonal(mums, maxdist=90, minclustsize=65, rcmums=True):
    if not mums:
        return []
    mums = list(mums)
    if rcmums:
        mums.sort(key=lambda m: (m[1][0] + (m[1][1] + m[0]), m[1][0] - (m[1][1] + m[0])))
    else:
        mums.sort(key=lambda m: (m[1][0] - m[1][1], m[1][0] + m[1][1]))

    l, sps, rc, ctg, ref = mums[0]
    clusters = [(sps[0], sps[0] + l, sps[1], sps[1] + l, rc, l, ctg, ref)]
    for i in range(1, len(mums)):
        l, sps, rc, ctg, ref = mums[i]
        s1, e1, s2, e2, prc, score, pctg, pref = clusters[-1]
        if rcmums:
            d = mums[i][1][0] + (mums[i][1][1] + mums[i][0])
            pd = e1 + s2
        else:
            d = mums[i][1][0] - mums[i][1][1]
            pd = s1 - s2
        if d == pd and pctg == ctg and pref == ref:
            dist = mums[i][1][0] - e1
            assert dist >= 0
            if dist < maxdist:
                if rc == 0:
                    clusters[-1] = (s1, sps[0] + l, s2, sps[1] + l, rc, score + l, ctg, ref)
                else:
                    clusters[-1] = (s1, sps[0] + l, sps[1], e2, rc, score + l, ctg, ref)
            else:
                clusters.append((sps[0], sps[0] + l, sps[1], sps[1] + l, rc, l, ctg, ref))
        else:
            clusters.append((sps[0], sps[0] + l, sps[1], sps[1] + l, rc, l, ctg, ref))
    return [c for c in clusters if c[5] >= minclustsize]


def merge_consecutive(syntenyblocks: List[Block]) -> List[Block]:
    if len(syntenyblocks) < 2:
        return syntenyblocks
    syntenyblocks.sort(key=lambda s: s[0])
    qryorder = sorted(range(len(syntenyblocks)), key=lambda i: syntenyblocks[i][2])
    qryorder_inv = sorted(range(len(syntenyblocks)), key=qryorder.__getitem__)
    head = 0
    ri = 0
    for ri in range(1, len(syntenyblocks)):
        pqi = qryorder_inv[ri - 1]
        qi = qryorder_inv[ri]
        pblock = syntenyblocks[ri - 1]
        block = syntenyblocks[ri]
        po, pctgid = pblock[4], pblock[7]
        s1, e1, s2, e2, o, score, refid, ctgid = block
        es1, ee1, es2, ee2, eo, escore, erefid, ectgid = syntenyblocks[head]
        if ctgid == pctgid:
            if pqi + 1 == qi and o == po == 0:
                syntenyblocks[head] = (es1, e1, es2, e2, eo, escore + score, erefid, ectgid)
            elif pqi - 1 == qi and o == po == 1:
                syntenyblocks[head] = (es1, e1, s2, ee2, eo, escore + score, erefid, ectgid)
            else:
                head += 1
                syntenyblocks[head] = block
        else:
            head += 1
            syntenyblocks[head] = block
    while head != ri:
        syntenyblocks.pop()
        head += 1
    return syntenyblocks


def extendblocks(syntenyblocks: List[Block], ctg2range) -> None:
    syntenyblocks.sort(key=lambda s: s[0])
    for i in range(len(syntenyblocks)):
        s1, e1, s2, e2, o, score, ref, ctg = syntenyblocks[i]
        if i == 0:
            s1 = ctg2range[ref][0]
        else:
            p = syntenyblocks[i - 1]
            s1 = p[1] if p[6] == ref else ctg2range[ref][0]
        if i == len(syntenyblocks) - 1:
            e1 = ctg2range[ref][1]
        else:
            n = syntenyblocks[i + 1]
            if n[6] == ref:
                e1 += (n[0] - e1) // 2
            else:
                e1 = ctg2range[ref][1]
        assert s1 < e1
        syntenyblocks[i] = (s1, e1, s2, e2, o, score, ref, ctg)

    syntenyblocks.sort(key=lambda s: s[2])
    for i in range(len(syntenyblocks)):
        s1, e1, s2, e2, o, score, ref, ctg = syntenyblocks[i]
        if i == 0:
            s2 = ctg2range[ctg][0]
        else:
            p = syntenyblocks[i - 1]
            s2 = p[3] if p[7] == ctg else ctg2range[ctg][0]
        if i == len(syntenyblocks) - 1:
            e2 = ctg2range[ctg][1]
        else:
            n = syntenyblocks[i + 1]
            if n[7] == ctg:
                e2 += (n[2] - e2) // 2
            else:
                e2 = ctg2range[ctg][1]
        assert s2 < e2
        syntenyblocks[i] = (s1, e1, s2, e2, o, score, ref, ctg)


def gapcost(
    block1,
    block2,
    rearrangecost=10000,
    inversioncost=0,
    eps=0,
    _lambda=0.5,
    gapopen=10,
    axis=0,
):
    if axis == 0:
        c1, c2 = 0, 2
    else:
        c1, c2 = 2, 0
    assert block1[c1] <= block2[c1]
    d1 = block2[c1] - block1[c1 + 1]

    if block1[4] == block2[4] == 0:
        if block2[c2] < block1[c2]:
            return gapopen + rearrangecost + eps * (d1 if d1 > 0 else 0)
        d2 = block2[c2] - block1[c2 + 1]
        indelcost = min(rearrangecost, _lambda * abs(d1 - d2))
        substitutioncost = eps * max((d1 if d1 < d2 else d2), 0)
        return gapopen + indelcost + substitutioncost
    if block1[4] == block2[4] == 1:
        if block2[c2] > block1[c2]:
            return gapopen + rearrangecost + eps * (d1 if d1 > 0 else 0)
        d2 = block1[c2] - block2[c2 + 1]
        indelcost = min(rearrangecost, _lambda * abs(d1 - d2))
        substitutioncost = eps * max((d1 if d1 < d2 else d2), 0)
        return gapopen + indelcost + substitutioncost
    # mixed orientations
    d1 = max(0, d1)
    if block2[c2] > block1[c2]:
        d2 = max(0, block2[c2] - block1[c2 + 1])
    else:
        d2 = max(0, block1[c2] - block2[c2 + 1])
    indelcost = min(rearrangecost, _lambda * abs(d1 - d2))
    substitutioncost = eps * max((d1 if d1 < d2 else d2), 0)
    return gapopen + indelcost + substitutioncost + inversioncost


def glocalchain(
    syntenyblocks: List[Block],
    rlength: int,
    qlength: int,
    ctg2range,
    rearrangecost=1000,
    inversioncost=1,
    lastn=50,
    lastbp=10000,
    useheap=False,
    axis=0,
    _lambda=5,
    eps=1,
    alfa=1,
    gapopen=10,
    vectorized=True,
) -> List[Block]:
    sep = rlength
    start = None

    if axis == 0:
        for refid, (refstart, refend) in enumerate(ctg2range):
            if refstart >= sep:
                break
            if refid == 0:
                start = (refstart, refstart, None, None, 0, 0, None, None)
            syntenyblocks.append((refend, refend, None, None, 0, 0, None, None))
        end = syntenyblocks[-1]
    else:
        first = True
        for ctgid, (ctgstart, ctgend) in enumerate(ctg2range):
            if ctgstart < sep:
                continue
            if first:
                start = (None, None, ctgstart, ctgstart, 0, 0, None, None)
                first = False
            syntenyblocks.append((None, None, ctgend, ctgend, 0, 0, None, None))
        end = syntenyblocks[-1]

    if axis == 0:
        c1, c2 = 0, 2
    else:
        c1, c2 = 2, 0

    syntenyblocks.sort(key=lambda s: (s[c1], -s[5]))

    if vectorized and not useheap:
        chain = _glocalchain_vec(
            syntenyblocks,
            start,
            end,
            ctg2range,
            rearrangecost=rearrangecost,
            inversioncost=inversioncost,
            lastn=lastn,
            lastbp=lastbp,
            axis=axis,
            _lambda=_lambda,
            eps=eps,
            alfa=alfa,
            gapopen=gapopen,
        )
        if chain is not None:
            return chain
        # native kernel unavailable: fall through to the scalar scan

    if useheap:
        import sortedcontainers

        heap = sortedcontainers.SortedList()
        heap.add((0, start))
    else:
        heap = [(0, start)] + [None] * len(syntenyblocks)

    G = {b: None for b in syntenyblocks}
    maxscore = None
    n = len(syntenyblocks)
    deepest = 0

    for ri in range(n):
        block = syntenyblocks[ri]
        while syntenyblocks[deepest][c1 + 1] < block[c1]:
            deepest += 1

        s1, e1, s2, e2, o, score, refid, ctgid = block

        bestscore = None
        bestblock = None
        l = 0

        for j in range(n + 1):
            if useheap:
                if j >= len(heap):
                    break
                # note: heap[-0] == heap[0] — the reference's quirk of
                # visiting the lowest-scoring entry first is preserved
                cscore, pblock = heap[-j]
            else:
                i = (ri + 1) - j - 1
                if i < 0:
                    break
                cscore, pblock = heap[i]

            prefid = pblock[6]

            if (pblock[c1] == block[c1] and prefid is not None and refid is not None) or (
                pblock[c1 + 1] >= block[c1 + 1]
                and prefid is not None
                and refid is not None
            ):
                continue
            if (
                pblock[c2] is not None
                and block[c2] is not None
                and pblock[c2] >= block[c2]
                and prefid is not None
                and refid is not None
            ) and (pblock[c2 + 1] <= block[c2 + 1]):
                continue

            l += 1

            if bestscore is not None and cscore <= bestscore:
                if useheap:
                    break
                if (
                    block[c1] - pblock[c1] > lastbp
                    and l >= lastn
                    and pblock[c1] < syntenyblocks[deepest][c1]
                ):
                    break
                continue

            ps1, pe1, ps2, pe2, po, pscore, prefid, pctgid = pblock

            if block[6] is None and pblock[6] is not None:
                if axis == 0:
                    _block = (
                        s1,
                        e1,
                        pe2 if po == 0 else ps2,
                        pe2 if po == 0 else ps2,
                        po,
                        0,
                        prefid,
                        pctgid,
                    )
                else:
                    _block = (
                        pe1 if po == 0 else ps1,
                        pe1 if po == 0 else ps1,
                        s2,
                        e2,
                        po,
                        0,
                        prefid,
                        pctgid,
                    )
            else:
                _block = block

            if pblock[6] is None and block[6] is not None:
                if axis == 0:
                    _pblock = (
                        ps1,
                        pe1,
                        s2 if o == 0 else e2,
                        s2 if o == 0 else e2,
                        o,
                        0,
                        refid,
                        ctgid,
                    )
                else:
                    _pblock = (
                        s1 if o == 0 else e1,
                        s1 if o == 0 else e1,
                        ps2,
                        pe2,
                        o,
                        0,
                        refid,
                        ctgid,
                    )
            else:
                _pblock = pblock

            if _pblock[6] == _block[6] is not None and _pblock[7] == _block[7] is not None:
                c = gapcost(
                    _pblock,
                    _block,
                    rearrangecost=rearrangecost,
                    inversioncost=inversioncost,
                    eps=eps,
                    _lambda=_lambda,
                    gapopen=gapopen,
                    axis=axis,
                )
            elif _pblock[6] is None and _block[6] is None and _pblock[7] is None and _block[7] is None:
                c = gapopen + abs(block[c1] - pblock[c1 + 1]) * eps
            else:
                pblockctgstart, pblockctgend = ctg2range[_pblock[7]]
                blockctgstart, blockctgend = ctg2range[_block[7]]
                pblockrefstart, pblockrefend = ctg2range[_pblock[6]]
                blockrefstart, blockrefend = ctg2range[_block[6]]

                if _pblock[6] == _block[6] and axis == 0:
                    cp = (
                        abs(pblockctgend - _pblock[3])
                        if _pblock[4] == 0
                        else abs(_pblock[2] - pblockctgstart)
                    )
                    cb = (
                        abs(blockctgend - _block[3])
                        if _block[4] == 0
                        else abs(_block[2] - blockctgstart)
                    )
                    c = gapopen + min(rearrangecost, (cp + cb) * eps)
                elif _pblock[7] == _block[7] and axis == 1:
                    cp = (
                        abs(pblockrefend - _pblock[1])
                        if _pblock[4] == 0
                        else abs(_pblock[0] - pblockrefstart)
                    )
                    cb = (
                        abs(_block[0] - blockrefstart)
                        if _block[4] == 0
                        else abs(blockrefend - _block[1])
                    )
                    c = gapopen + min(rearrangecost, (cp + cb) * eps)
                else:
                    c = rearrangecost + gapopen + abs(block[c1] - pblock[c1 + 1]) * eps

            assert c >= 0

            if bestscore is None or cscore - c > bestscore:
                bestscore = cscore - c
                bestblock = pblock

            if not useheap:
                if (
                    block[c1] - pblock[c1] > lastbp
                    and l >= lastn
                    and pblock[c1] < syntenyblocks[deepest][c1]
                ):
                    break

        cscore = bestscore + alfa * score

        if useheap:
            heap.add((cscore, block))
        else:
            heap[ri + 1] = (cscore, block)

        if maxscore is None or maxscore < cscore:
            maxscore = cscore

        G[block] = (bestblock, bestscore)

    node, cscore = G[end]
    chain = []
    while node != start:
        if node[6] is not None:
            chain.append(node)
        nnode, _ = G[node]
        if node == nnode:
            raise RuntimeError("Loop in chain!")
        node = nnode

    log.info(
        "Optimal glocal chain contains %d anchors (score %s)",
        len(chain),
        cscore,
    )
    return chain[::-1]


def _glocalchain_vec(
    syntenyblocks,
    start,
    end,
    ctg2range,
    rearrangecost=1000,
    inversioncost=1,
    lastn=50,
    lastbp=10000,
    axis=0,
    _lambda=5,
    eps=1,
    alfa=1,
    gapopen=10,
):
    """Native bounded-window glocal-chain DP (SURVEY §7 step 8).

    Result-identical to the scalar window scan (glocalchain with
    useheap=False, the transform.py:947-1180 semantics): the validity
    filters (transform.py:1040-1056), the dummy-block coordinate
    substitutions (:1058-1090, which reduce algebraically to
    ``gapopen + min(rearrangecost, lambda*|d1|)``), the orientation /
    cross-contig gap-cost cases (gapcost :1182-1244), the
    lastn/lastbp/deepest early stop and first-improvement tie-breaking
    all run in the C++ kernel (native/esa.cpp glocal_dp); candidates
    whose running score cannot improve the best (the reference's
    ``cscore <= bestscore`` skip) are value-equivalent because costs are
    non-negative.  Returns None when the native library is unavailable
    (caller falls back to the scalar loop).  Logs blocks/sec like the
    reference (transform.py:996-1013)."""
    import time

    import numpy as np

    try:
        from ..native import glocal_dp_native
    except Exception:
        return None

    n = len(syntenyblocks)
    cands = [start] + syntenyblocks

    def col(k):
        return np.array(
            [0 if b[k] is None else b[k] for b in cands], dtype=np.int64
        )

    S1, E1, S2, E2, O, SC = (col(k) for k in (0, 1, 2, 3, 4, 5))
    REF = np.array(
        [-1 if b[6] is None else b[6] for b in cands], dtype=np.int64
    )
    CTG = np.array(
        [-1 if b[7] is None else b[7] for b in cands], dtype=np.int64
    )
    RNG0 = np.array([r[0] for r in ctg2range], dtype=np.int64)
    RNG1 = np.array([r[1] for r in ctg2range], dtype=np.int64)

    t0 = time.time()
    res = glocal_dp_native(
        S1, E1, S2, E2, O, REF, CTG, SC, RNG0, RNG1,
        float(rearrangecost), float(inversioncost), float(_lambda),
        float(eps), float(alfa), float(gapopen), int(lastn), int(lastbp),
        int(axis),
    )
    if res is None:
        return None
    best, bscore = res
    rate = n / max(time.time() - t0, 1e-9)
    log.info("glocalchain: %d blocks at %.0f blocks/sec", n, rate)

    G = {
        b: (cands[int(best[i])], float(bscore[i]))
        for i, b in enumerate(syntenyblocks)
    }

    node, cscore = G[end]
    chain = []
    while node != start:
        if node[6] is not None:
            chain.append(node)
        nnode, _ = G[node]
        if node == nnode:
            raise RuntimeError("Loop in chain!")
        node = nnode

    log.info(
        "Optimal glocal chain contains %d anchors (score %s)",
        len(chain),
        cscore,
    )
    return chain[::-1]


def chainscore(
    chain: List[Block],
    rlength,
    qlength,
    ctg2range,
    rearrangecost=1000,
    inversioncost=1,
    _lambda=5,
    eps=1,
    alfa=1,
    gapopen=10,
):
    if len(chain) == 0:
        start = (0, 0, rlength, rlength, 0, 0, 0, 0)
        end = (rlength, rlength, rlength + qlength, rlength + qlength, 0, 0, 0, 0)
        cost = gapcost(
            start,
            end,
            rearrangecost=rearrangecost,
            inversioncost=inversioncost,
            _lambda=_lambda,
            eps=eps,
            gapopen=gapopen,
            axis=0,
        )
        return 0, cost, [cost]

    chain.sort(key=lambda s: s[0])
    qryorder = sorted(range(len(chain)), key=lambda i: chain[i][2])
    qryorder_inv = sorted(range(len(chain)), key=qryorder.__getitem__)

    lastqstart, lastqend = ctg2range[chain[-1][7]]
    if chain[0][4] == 0:
        end = (rlength, rlength, lastqend, lastqend, chain[0][4])
    else:
        end = (rlength, rlength, lastqstart, lastqstart, chain[0][4])

    firstqstart, firstqend = ctg2range[chain[0][7]]
    if chain[0][4] == 0:
        start = (0, 0, firstqstart, firstqstart, chain[0][4])
    else:
        start = (0, 0, firstqend, firstqend, chain[0][4])

    startcost = gapcost(
        start,
        chain[0],
        rearrangecost=rearrangecost,
        inversioncost=inversioncost,
        _lambda=_lambda,
        eps=eps,
        gapopen=gapopen,
        axis=0,
    )
    cost = startcost
    edgecosts = [startcost]
    weight = alfa * chain[0][5]

    for ri in range(1, len(chain)):
        pblock = chain[ri - 1]
        block = chain[ri]
        po, pctg, pref = pblock[4], pblock[7], pblock[6]
        s1, e1, s2, e2, o, score, ref2, ctg = block
        weight += alfa * score
        pqi = qryorder_inv[ri - 1]
        qi = qryorder_inv[ri]

        if pctg == ctg and pref == ref2:
            if (pqi == qi - 1) or (pqi == qi + 1):
                gc = gapcost(
                    pblock,
                    block,
                    rearrangecost=rearrangecost,
                    inversioncost=inversioncost,
                    _lambda=_lambda,
                    eps=eps,
                    gapopen=gapopen,
                    axis=0,
                )
                cost += gc
                edgecosts.append(gc)
            else:
                cost += gapopen + rearrangecost
                edgecosts.append(gapopen + rearrangecost)
        else:
            if o == 0:
                pq_ctg = chain[qryorder[qi - 1]][7] if qi > 0 else "start"
            else:
                pq_ctg = (
                    chain[qryorder[qi + 1]][7]
                    if qi < len(qryorder) - 1
                    else "end"
                )
            if po == 0:
                nq_ctg = (
                    chain[qryorder[pqi + 1]][7]
                    if pqi < len(qryorder) - 1
                    else "end"
                )
            else:
                nq_ctg = chain[qryorder[pqi - 1]][7] if pqi > 0 else "start"

            if pq_ctg == ctg or nq_ctg == pctg:
                cost += gapopen + rearrangecost
                edgecosts.append(gapopen + rearrangecost)
            else:
                edgecosts.append(gapopen)

    endcost = gapcost(
        chain[-1],
        end,
        rearrangecost=rearrangecost,
        inversioncost=inversioncost,
        _lambda=_lambda,
        eps=eps,
        gapopen=gapopen,
        axis=0,
    )
    cost += endcost
    edgecosts.append(endcost)
    return weight, cost, edgecosts


def optimise(
    syntenyblocks,
    rlength,
    qlength,
    ctg2range,
    **kw,
):
    orgchain = sorted(syntenyblocks, key=lambda c: c[5])
    maxchain = syntenyblocks
    w, c, e = chainscore(maxchain, rlength, qlength, ctg2range, **kw)
    maxchainscore = w - c
    maxres = (maxchain, w, c, e)

    stack = []
    for i in range(len(orgchain)):
        tmp = list(stack + orgchain[i + 1 :])
        w, c, e = chainscore(tmp, rlength, qlength, ctg2range, **kw)
        if w - c < maxchainscore:
            stack.append(orgchain[i])
        else:
            maxchainscore = w - c
            maxres = (tmp, w, c, e)
    return maxres


def remove_overlap_conservative_blocks(anchors):
    for coord in (0, 2):
        if len(anchors) <= 1:
            return anchors
        anchors.sort(key=lambda m: (m[coord], (m[coord + 1] - m[coord]) * -1))
        _anchors = [anchors[0]]
        last = anchors[0]
        for anchor in anchors[1:]:
            if anchor[coord] < last[coord + 1]:
                if anchor[coord + 1] <= last[coord + 1]:
                    continue
            _anchors.append(anchor)
            last = anchor
        anchors = _anchors

        _anchors = [anchors[0]]
        for anchor in anchors[1:]:
            s1, e1, s2, e2, o, score, refid, ctgid = anchor
            ps1, pe1, ps2, pe2, po, pscore, prefid, pctgid = _anchors[-1]
            overlap = _anchors[-1][coord + 1] - anchor[coord]
            pl = pe1 - ps1
            if overlap > 0:
                if score <= overlap:
                    continue
                if o == 0:
                    anchor = (s1 + overlap, e1, s2 + overlap, e2, o, score - overlap, refid, ctgid)
                elif coord == 0:
                    anchor = (s1 + overlap, e1, s2, e2 - overlap, o, score - overlap, refid, ctgid)
                else:
                    anchor = (s1, e1 - overlap, s2 + overlap, e2, o, score - overlap, refid, ctgid)
                assert anchor[coord + 1] > _anchors[-1][coord + 1]
                while pl <= overlap or pscore <= overlap:
                    _anchors.pop()
                    ps1, pe1, ps2, pe2, po, pscore, prefid, pctgid = _anchors[-1]
                    overlap = _anchors[-1][coord + 1] - anchor[coord]
                    if overlap < 0:
                        break
                    pl = pe1 - ps1
                if overlap > 0:
                    if po == 0:
                        _anchors[-1] = (ps1, pe1 - overlap, ps2, pe2 - overlap, po, pscore - overlap if overlap < pscore else 0, prefid, pctgid)
                    elif coord == 0:
                        _anchors[-1] = (ps1, pe1 - overlap, ps2 + overlap, pe2, po, pscore - overlap if overlap < pscore else 0, prefid, pctgid)
                    else:
                        _anchors[-1] = (ps1 + overlap, pe1, ps2, pe2 - overlap, po, pscore - overlap if overlap < pscore else 0, prefid, pctgid)
            _anchors.append(anchor)
        anchors = _anchors
    return anchors


def remove_overlap_greedy_blocks(anchors):
    for coord in (0, 2):
        if len(anchors) <= 1:
            return anchors
        anchors.sort(key=lambda m: (m[coord], (m[coord + 1] - m[coord]) * -1))
        _anchors = [anchors[0]]
        last = anchors[0]
        for anchor in anchors[1:]:
            if anchor[coord] < last[coord + 1]:
                if anchor[coord + 1] <= last[coord + 1]:
                    continue
            _anchors.append(anchor)
            last = anchor
        anchors = _anchors

        _anchors = [anchors[0]]
        for i in range(1, len(anchors)):
            anchor = anchors[i]
            s1, e1, s2, e2, o, score, refid, ctgid = anchor
            ps1, pe1, ps2, pe2, po, pscore, prefid, pctgid = _anchors[-1]
            pl = pe1 - ps1
            overlap = _anchors[-1][coord + 1] - anchor[coord]
            if overlap > 0:
                if pscore > score:
                    if score <= overlap:
                        continue
                    if o == 0:
                        anchor = (s1 + overlap, e1, s2 + overlap, e2, o, score - overlap, refid, ctgid)
                    elif coord == 0:
                        anchor = (s1 + overlap, e1, s2, e2 - overlap, o, score - overlap, refid, ctgid)
                    else:
                        anchor = (s1, e1 - overlap, s2 + overlap, e2, o, score - overlap, refid, ctgid)
                    _anchors.append(anchor)
                else:
                    while pl <= overlap or pscore <= overlap:
                        _anchors.pop()
                        ps1, pe1, ps2, pe2, po, pscore, prefid, pctgid = _anchors[-1]
                        overlap = _anchors[-1][coord + 1] - anchor[coord]
                        if overlap < 0:
                            break
                        pl = pe1 - ps1
                    if overlap > 0:
                        if po == 0:
                            _anchors[-1] = (ps1, pe1 - overlap, ps2, pe2 - overlap, po, pscore - overlap if overlap < pscore else 0, prefid, pctgid)
                        elif coord == 0:
                            _anchors[-1] = (ps1, pe1 - overlap, ps2 + overlap, pe2, po, pscore - overlap if overlap < pscore else 0, prefid, pctgid)
                        else:
                            _anchors[-1] = (ps1 + overlap, pe1, ps2, pe2 - overlap, po, pscore - overlap if overlap < pscore else 0, prefid, pctgid)
                    _anchors.append(anchor)
            else:
                _anchors.append(anchor)
        anchors = _anchors
    return anchors
