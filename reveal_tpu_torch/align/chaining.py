"""Anchor chaining.

Gap cost models (utils.gapcost, reveal/utils.py:162-183) and
the sparse chaining DP over multi-genome anchor coordinates
(schemes.chain, reveal/schemes.py:20-104).  The DP keeps the
reference's traversal and tie-breaking order so chains (and hence graphs)
are reproducible against it.
"""

from __future__ import annotations

from math import log
from typing import Dict, List, Tuple


def gapcost(
    pointa,
    pointb,
    model: str = "sumofpairs",
    convex: bool = False,
    lambda_: float = 1,
    epsilon_: float = 0,
):
    assert len(pointa) == len(pointb)
    if model == "star-avg":
        return abs(sum(pointa[i] - pointb[i] for i in range(len(pointa)))) / len(
            pointa
        )
    if model == "star-med":
        return sorted(abs(pointa[i] - pointb[i]) for i in range(len(pointa)))[
            len(pointa) // 2
        ]
    if model == "sumofpairs":
        p = 0
        D = [abs(pointa[i] - pointb[i]) for i in range(len(pointa))]
        if epsilon_ > 0:
            p += min(D) * epsilon_
        for i in range(len(D)):
            for j in range(i + 1, len(D)):
                if convex:
                    p += log(abs(D[i] - D[j]) + 1) * lambda_
                else:
                    p += abs(D[i] - D[j]) * lambda_
        return p
    return 0


RelMum = Tuple[int, int, Dict[int, int]]  # (l, n, {path_id: offset})


def chain(
    mums: List[RelMum],
    left: RelMum,
    right: RelMum,
    wscore: float = 1,
    wpen: float = 1,
    gcmodel: str = "sumofpairs",
) -> List[Tuple[RelMum, float]]:
    """Sparse chaining DP (schemes.py:20-104).

    mums must be relative-offset mums; returns [(mum, score)] from the right
    end back to (excluding) left — i.e. reversed chain like the reference.

    The reference rescans `processed` and fully re-sorts `active` per mum
    (O(k^2 log k)); here the processed->active eligibility test is a
    vectorized numpy scan and the active list is kept sorted by
    (-score, arrival order) with bisect insertion — scores never change
    after assignment and the reference's stable sort places newly moved
    entries after existing equal-score ones, so the traversal (and
    tie-breaking) order is identical.
    """
    if len(mums) == 0:
        return []

    import bisect

    import numpy as np

    mums = list(mums)
    ref = next(iter(mums[0][2]))
    mums.append(right)
    mums.sort(key=lambda m: m[2][ref])

    # NOTE: score/link/sp2mum key on the ref-dim start, exactly like the
    # reference (schemes.py:32-36, 89-94) — duplicate ref starts alias in
    # both implementations.  The default pipeline never produces them
    # (trim_overlap leaves distinct starts per dimension); the native fast
    # path below additionally refuses to run on them.
    sp2mum = {m[2][ref]: m for m in mums}

    start = left[2][ref]
    end = right[2][ref]

    link: Dict[int, int] = {}
    score: Dict[int, float] = {start: 0}

    dims = list(mums[0][2].keys())
    ndim = len(dims)

    # native full-DP fast path (identical semantics; falls back when the
    # refcoord-keyed dict could alias, i.e. duplicate ref starts)
    if (
        gcmodel == "sumofpairs"
        and float(wscore).is_integer()
        and len(sp2mum) == len(mums)
    ):
        try:
            from ..native import chain_native
        except Exception:
            chain_native = None
        if chain_native is not None:
            starts_arr = np.array(
                [[m[2][c] for c in dims] for m in mums], dtype=np.int64
            )
            lens_arr = np.array([m[0] for m in mums], dtype=np.int64)
            nmul_arr = np.array(
                [
                    int(wscore) * (m[0] * ((m[1] * (m[1] - 1)) // 2))
                    for m in mums
                ],
                dtype=np.int64,
            )
            left_arr = np.array([left[2][c] for c in dims], dtype=np.int64)
            res = chain_native(
                starts_arr, lens_arr, nmul_arr, left_arr, float(wpen)
            )
            if res is not None:
                nlink, nscores = res
                if not (nlink == -2).any():
                    for mi, m in enumerate(mums):
                        rc_ = m[2][ref]
                        score[rc_] = float(nscores[mi])
                        link[rc_] = (
                            start
                            if nlink[mi] < 0
                            else mums[int(nlink[mi])][2][ref]
                        )
                    path = []
                    while end != start:
                        path.append((sp2mum[end], score[end]))
                        end = link[end]
                    return path[1:]

    # active kept in (score desc, arrival) order.  Arrays are append-only
    # buffers; `order` holds buffer indices in scan order (bisect insert
    # moves list pointers, not array elements).
    cap0 = len(mums) + 2
    buf_end = np.empty((cap0, ndim), dtype=np.int64)
    buf_score = np.empty(cap0, dtype=np.float64)
    buf_mums: List[RelMum] = []

    counter = 0
    active_keys = [(-0.0, counter)]
    order: List[int] = [0]
    buf_end[0] = [left[2][c] + left[0] for c in dims]
    buf_score[0] = 0.0
    buf_mums.append(left)
    buf_n = 1
    counter += 1

    # processed pool as growable arrays
    cap = len(mums)
    p_end = np.empty((cap, ndim), dtype=np.int64)  # start+len per dim
    p_mums: List[RelMum] = []
    p_live = np.zeros(cap, dtype=bool)
    p_n = 0

    CHUNK = 128

    def _pen_vec(D):
        """Vectorized gapcost over per-dim distances D: (m, ndim), with the
        default lambda=1, eps=0 weights the picker uses."""
        if gcmodel == "sumofpairs":
            pen = np.zeros(len(D))
            for i in range(ndim):
                for j in range(i + 1, ndim):
                    pen += np.abs(D[:, i] - D[:, j])
            return pen
        if gcmodel == "star-avg":
            # reference uses the signed sum of (a-b); D here is signed
            return np.abs(D.sum(axis=1)) / ndim
        if gcmodel == "star-med":
            return np.sort(np.abs(D), axis=1)[:, ndim // 2]
        return np.zeros(len(D))

    signed = gcmodel == "star-avg"

    for mum in mums:
        mstart = np.array([mum[2][c] for c in dims], dtype=np.int64)
        if p_n:
            elig = p_live[:p_n] & (p_end[:p_n] <= mstart).all(axis=1)
            idxs = np.nonzero(elig)[0]
            for pi in idxs.tolist():
                p_live[pi] = False
                pm = p_mums[pi]
                s = score[pm[2][ref]]
                at = bisect.bisect(active_keys, (-s, counter))
                active_keys.insert(at, (-s, counter))
                order.insert(at, buf_n)
                buf_end[buf_n] = [pm[2][c] + pm[0] for c in dims]
                buf_score[buf_n] = s
                buf_mums.append(pm)
                buf_n += 1
                counter += 1

        mul = wscore * (mum[0] * ((mum[1] * (mum[1] - 1)) // 2))
        w = None
        best = None
        k = len(order)

        # scalar prefix with the exact early break — in well-anchored
        # regions the best predecessor is found within a few entries
        PREFIX = 64 if k > 64 else k
        broke = False
        for ai in range(PREFIX):
            bidx = order[ai]
            amum = buf_mums[bidx]
            ok = True
            for c in amum[2]:
                if amum[2][c] + amum[0] > mum[2][c]:
                    ok = False
                    break
            if not ok:
                continue
            s = buf_score[bidx] + mul
            if w is not None and w > s:
                broke = True
                break
            penalty = gapcost(
                [amum[2][kk] + amum[0] for kk in mum[2]],
                [mum[2][kk] for kk in mum[2]],
                model=gcmodel,
            )
            tmpw = s - wpen * penalty
            if w is None or tmpw > w:
                w = tmpw
                best = amum

        # chunked vector scan of the remainder in score-desc order: a whole
        # chunk is skipped when the running max already exceeds its
        # best-possible s (exactly the reference's early break; extra
        # elements inside a taken chunk have tmpw <= s < w and cannot win)
        for cs in range(PREFIX if not broke else k, k, CHUNK):
            ce = min(k, cs + CHUNK)
            top = order[cs]
            s_top = buf_score[top] + mul
            if w is not None and w > s_top:
                break
            oidx = np.array(order[cs:ce], dtype=np.int64)
            ends = buf_end[oidx]
            compat = (ends <= mstart[None, :]).all(axis=1)
            if not compat.any():
                continue
            if signed:
                D = (ends - mstart[None, :]).astype(np.float64)
            else:
                D = np.abs(ends - mstart[None, :]).astype(np.float64)
            tmpw = buf_score[oidx] + mul - wpen * _pen_vec(D)
            tmpw = np.where(compat, tmpw, -np.inf)
            bi = int(np.argmax(tmpw))
            if tmpw[bi] != -np.inf and (w is None or tmpw[bi] > w):
                w = float(tmpw[bi])
                best = buf_mums[int(oidx[bi])]

        link[mum[2][ref]] = best[2][ref]
        score[mum[2][ref]] = w
        p_end[p_n] = [mum[2][c] + mum[0] for c in dims]
        p_mums.append(mum)
        p_live[p_n] = True
        p_n += 1

    path = []
    while end != start:
        path.append((sp2mum[end], score[end]))
        end = link[end]
    return path[1:]


def trim_overlap(mums: List) -> List:
    """Resolve per-dimension overlaps between mums (schemes.py:161-191).

    mums here carry tuple coords: (l, n, ((sid, pos), ...)).
    """
    if not mums:
        return mums
    ncoords = len(mums[0][2])
    for coord in range(ncoords):
        if len(mums) <= 1:
            break
        mums.sort(key=lambda m: (m[2][coord][1], -m[0]))
        # drop matches contained in their neighbour along this dimension
        # (note: for i==0 the reference's mums[i-1] wraps to the last
        # element — replicated for parity)
        mums = [
            mum
            for i, mum in enumerate(mums)
            if (
                i == 0
                and mums[i + 1][2][coord][1] + mums[i + 1][0]
                > mum[2][coord][1] + mum[0]
            )
            or mums[i - 1][2][coord][1] + mums[i - 1][0]
            < mum[2][coord][1] + mum[0]
        ]
        if len(mums) <= 1:
            break
        trimmed = [mums[0]]
        for mum in mums[1:]:
            pmum = trimmed[-1]
            overlap = (pmum[2][coord][1] + pmum[0]) - mum[2][coord][1]
            if overlap > 0:
                if pmum[0] - overlap > 0:
                    trimmed[-1] = (pmum[0] - overlap, pmum[1], pmum[2])
                else:
                    del trimmed[-1]
                if mum[0] - overlap > 0:
                    trimmed.append(
                        (
                            mum[0] - overlap,
                            mum[1],
                            tuple((k, v + overlap) for k, v in mum[2]),
                        )
                    )
            else:
                trimmed.append(mum)
        mums = trimmed
    return mums
