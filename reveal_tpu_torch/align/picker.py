"""Anchor selection: which multiMUM splits a segment.

Port of schemes.graphmumpicker and its helpers
(reveal/schemes.py:107-358), restructured as a class holding
the configuration + graph handles instead of the reference's module
globals.
"""

from __future__ import annotations

import logging
import math
import random
from dataclasses import dataclass
from typing import Optional

from .chaining import chain, trim_overlap
from .graphops import IntervalIndex
from ..graph.pangraph import PanGraph

log = logging.getLogger(__name__)


@dataclass
class PickerConfig:
    minlength: int = 20
    minn: int = 2
    maxmums: int = 10000
    wpen: float = 1
    wscore: float = 1
    seedsize: int = 0
    pcutoff: float = 1e-8
    gcmodel: str = "sumofpairs"
    maxsize: Optional[int] = None
    trim: bool = True
    splitchain: str = "largest"  # largest | balanced | random
    maxdepth: Optional[int] = None


class MumPicker:
    def __init__(self, G: PanGraph, t: IntervalIndex, cfg: PickerConfig):
        self.G = G
        self.t = t
        self.cfg = cfg
        # (seq_starts, seq_sids) for the array fast path; see set_fastmap
        self.fastmap = None
        self._nsid = None
        self._id2end_arr = None

    def set_fastmap(self, root_nodes):
        """Enable the pairwise array fast path when every root node is a
        whole single-sample sequence at offset 0 (fasta inputs).  Then a
        text position p maps to path offset p - seq_start — the invariant
        breaknode maintains for every unaligned descendant node — so the
        picker needs no interval lookups."""
        import numpy as np

        G = self.G
        if any(p.startswith("*") for p in G.graph["paths"]):
            return
        starts = []
        sids = []
        for iv in root_nodes:
            if isinstance(iv, str):
                continue  # endpoint markers are not in root_nodes; guard
            offs = G.nodes[iv]["offsets"]
            if len(offs) != 1:
                return
            (sid, off), = offs.items()
            if off != 0:
                return
            starts.append(iv[0])
            sids.append(sid)
        if not starts:
            return
        order = np.argsort(starts)
        self.fastmap = (
            np.asarray(starts, dtype=np.int64)[order],
            np.asarray(sids, dtype=np.int64)[order],
        )

    # -- helpers -----------------------------------------------------------
    def segment_subset(self, mums):
        """Pick the genome subset maximizing sum(l)*|subset|
        (schemes.segment, :107-124)."""
        d = {}
        for mum in mums:
            k = tuple(sorted(gid for gid, sp in mum[2]))
            d.setdefault(k, []).append(mum)
        best = 0
        partition = None
        for part in d:
            z = sum(m[0] for m in d[part]) * len(part)
            if z > best:
                best = z
                partition = part
        return d[partition]

    def lookup(self, mum):
        """Index coords -> per-path offsets (schemes.lookup, :126-150)."""
        G = self.G
        l, mmn, spd = mum
        if isinstance(spd, dict):
            sp = list(spd.values())
        else:
            sp = [p for gid, p in spd]
        n = 0
        qlpoint = {}
        for pos in sp:
            node = self.t.lookup(pos)
            ndata = G.nodes[node]
            nsamples = {
                o
                for o in ndata["offsets"]
                if not G.graph["id2path"][o].startswith("*")
            }
            n += len(nsamples)
            rel = pos - node[0]
            for k in nsamples:
                qlpoint[k] = ndata["offsets"][k] + rel
        return (l, n, qlpoint)

    def maptooffsets(self, mums):
        """Batched variant of per-mum lookup(): one vectorized interval
        lookup for every occurrence position, with the '*'-path filter
        hoisted out of the inner loop.  qlpoint insertion order (set
        iteration) is kept identical to lookup() — chain() dimension order
        depends on it."""
        G = self.G
        id2path = G.graph["id2path"]
        real = {
            sid for sid, p in id2path.items() if not p.startswith("*")
        }
        positions = []
        counts = []
        for mum in mums:
            spd = mum[2]
            sp = (
                list(spd.values())
                if isinstance(spd, dict)
                else [p for gid, p in spd]
            )
            positions.extend(sp)
            counts.append(len(sp))
        nodes = self.t.lookup_batch(positions) if positions else []

        # memoize per node within this call: mums of one segment hit the
        # same few nodes over and over
        node_cache = {}

        def node_info(node):
            info = node_cache.get(node)
            if info is None:
                offs = G.nodes[node]["offsets"]
                nsamples = {o for o in offs if o in real}
                info = (offs, tuple(nsamples))
                node_cache[node] = info
            return info

        mapping = {}
        relmums = []
        j = 0
        for mum, c in zip(mums, counts):
            n = 0
            qlpoint = {}
            for pos, node in zip(
                positions[j : j + c], nodes[j : j + c]
            ):
                offs, nsamples = node_info(node)
                n += len(nsamples)
                rel = pos - node[0]
                for k in nsamples:
                    qlpoint[k] = offs[k] + rel
            j += c
            relmum = (mum[0], n, qlpoint)
            relmums.append(relmum)
            mapping[tuple(qlpoint.values())] = mum
        return relmums, mapping

    def _maxsize_stop(self, idx) -> bool:
        """Bubble-size stop (schemes.py:207-224)."""
        G = self.G
        cfg = self.cfg
        rpaths = [p for p in G.graph["paths"] if not p.startswith("*")]
        if idx.left_node is None:
            lo = {G.graph["path2id"][p]: 0 for p in rpaths}
        else:
            ln = idx.left_node
            lo = {
                k: G.nodes[ln]["offsets"][k] + (ln[1] - ln[0])
                for k in G.nodes[ln]["offsets"]
            }
        if idx.right_node is None:
            ro = {
                G.graph["path2id"][p]: G.graph["id2end"][
                    G.graph["path2id"][p]
                ]
                for p in rpaths
            }
        else:
            ro = G.nodes[idx.right_node]["offsets"]
        return all(
            ro[k] - lo[k] <= cfg.maxsize for k in set(lo) & set(ro)
        )

    # -- the picker --------------------------------------------------------
    def __call__(self, mums, idx, precomputed=False, minlength=0):
        """Returns () to stop recursion, else (splitmum, skipleft, skipright)
        where splitmum carries index coordinates."""
        cfg = self.cfg
        G = self.G
        if len(mums) == 0:
            return ()

        if not precomputed:
            if cfg.maxdepth is not None and idx.depth > cfg.maxdepth:
                return ()

            if cfg.maxsize is not None and self._maxsize_stop(idx):
                return ()

            mmums = [mum for mum in mums if mum[1] == idx.nsamples]
            if len(mmums) == 0 and idx.nsamples > 2:
                mmums = self.segment_subset(mums)

            if cfg.trim:
                mmums = trim_overlap(mmums)
                if len(mmums) == 0:
                    return ()

            mmums.sort(key=lambda mum: mum[0], reverse=True)

            relmums, mapping = self.maptooffsets(mmums)

            relmums.sort(key=lambda m: (m[1], m[0]))
            target_keys = relmums[-1][2].keys()
            relmums = [m for m in relmums if m[2].keys() == target_keys]

            if idx.left_node is not None:
                ln = idx.left_node
                left = (
                    0,
                    0,
                    {
                        k: G.nodes[ln]["offsets"][k] + (ln[1] - ln[0]) - 1
                        for k in target_keys
                    },
                )
            else:
                left = (0, 0, {sid: -1 for sid in target_keys})

            if idx.right_node is not None:
                rn = idx.right_node
                right = (
                    0,
                    0,
                    {k: G.nodes[rn]["offsets"][k] for k in target_keys},
                )
            else:
                right = (
                    0,
                    0,
                    {sid: G.graph["id2end"][sid] for sid in target_keys},
                )

            if len(relmums) == 0:
                return ()

            skipleft = []
            skipright = []

            if len(relmums) == 1:
                splitmum = relmums[0]
            else:
                if len(relmums) > cfg.maxmums:
                    relmums = relmums[-cfg.maxmums :]

                chainedmums = chain(
                    relmums,
                    left,
                    right,
                    wscore=cfg.wscore,
                    wpen=cfg.wpen,
                    gcmodel=cfg.gcmodel,
                )[::-1]
                if len(chainedmums) == 0:
                    return ()

                if cfg.splitchain == "balanced":
                    optsplit = None
                    splitmum = None
                    for mum, score in chainedmums:
                        lseq = rseq = 0
                        for crd in mum[2]:
                            lseq = mum[2][crd]
                            rseq = right[2][crd] - mum[2][crd] + mum[0]
                        if optsplit is None or abs(lseq - rseq) < optsplit:
                            optsplit = abs(lseq - rseq)
                            splitmum = mum
                elif cfg.splitchain == "largest":
                    splitmum = sorted(chainedmums, key=lambda m: m[0][0])[-1][0]
                else:
                    splitmum = chainedmums[
                        random.randint(0, len(chainedmums) - 1)
                    ][0]

                if cfg.seedsize and cfg.seedsize > 0:
                    tlist = skipleft
                    scoreatsplit = 0
                    for mum, score in chainedmums:
                        if mum == splitmum:
                            scoreatsplit = score
                            tlist = skipright
                            continue
                        tlist.append(
                            (
                                mapping[tuple(mum[2].values())],
                                score - scoreatsplit,
                            )
                        )
                    skipleft = [
                        (m, s) for m, s in skipleft if m[0] >= cfg.seedsize
                    ]
                    skipright = [
                        (m, s) for m, s in skipright if m[0] >= cfg.seedsize
                    ]

            splitmum = mapping[tuple(splitmum[2].values())]

            if minlength == 0:
                o = 1
                for p in left[2]:
                    o = o * (right[2][p] - left[2][p])
                l = splitmum[0]
                n = splitmum[1]
                p = (0.25 ** (n - 1)) ** l
                if p > 0:
                    p = 1 - math.exp(math.log(1 - p) * o)
                if p > cfg.pcutoff:
                    log.info(
                        "P-value for anchor (n=%d l=%d o=%d) is %.4g — stop",
                        n,
                        l,
                        o,
                        p,
                    )
                    return ()
        else:
            chainedmums = mums
            half = len(chainedmums) // 2
            splitmum = chainedmums[half][0]
            skipleft = chainedmums[:half]
            skipright = chainedmums[half + 1 :]

        return splitmum, skipleft, skipright

    # -- array fast path -----------------------------------------------------
    def pick_pairwise(self, ls, aa, bb, idx, minlength=0):
        """Array re-expression of __call__ for the 2-genome case with a
        fastmap (fasta inputs): trim (native), offset map (arithmetic),
        chain (native), split pick — without materializing per-mum tuples.

        Returns None to defer to the generic path (caller falls back),
        () to stop recursion, or (splitmum, skipleft, skipright) exactly
        like __call__; splitmum/skip entries are index-coordinate tuples.
        """
        import numpy as np

        cfg = self.cfg
        if (
            self.fastmap is None
            or cfg.splitchain != "largest"
            or cfg.gcmodel != "sumofpairs"
            or not float(cfg.wscore).is_integer()
        ):
            return None
        if len(ls) == 0:
            return ()
        if cfg.maxdepth is not None and idx.depth > cfg.maxdepth:
            return ()
        if cfg.maxsize is not None and self._maxsize_stop(idx):
            return ()
        if idx.nsamples != 2:
            # the generic path filters mums to n == idx.nsamples and
            # stops (pairwise enum only emits n=2)
            return ()

        res = self._pick_pairwise_c(ls, aa, bb, idx, minlength)
        if res is not NotImplemented:
            return res

        if cfg.trim:
            from ..native import trim_overlap_native

            res = trim_overlap_native(ls, np.stack([aa, bb], axis=1))
            if res is None:
                return None
            ls, P = res
            if len(ls) == 0:
                return ()
            aa = P[:, 0]
            bb = P[:, 1]

        # mmums.sort(l desc, stable), then relmums.sort((n, l) asc,
        # stable) with n == 2 everywhere: both passes are stable, so the
        # composition is a single stable ascending sort by l (ties keep
        # the trim-output order through both list sorts)
        order = np.argsort(ls, kind="stable")
        ls, aa, bb = ls[order], aa[order], bb[order]

        # offsets: path offset = text pos - sequence start (breaknode
        # invariant for whole-sequence roots, see set_fastmap)
        starts, sids = self.fastmap
        ia = np.searchsorted(starts, aa, side="right") - 1
        ib = np.searchsorted(starts, bb, side="right") - 1
        offa = aa - starts[ia]
        offb = bb - starts[ib]
        sida = sids[ia]
        sidb = sids[ib]

        # target keys = keys of the last (n, l)-sorted mum; dict-keys
        # equality is set equality, and a-side/b-side sample ids are
        # disjoint, so pair equality suffices
        ta = int(sida[-1])
        tb = int(sidb[-1])
        sel = (sida == ta) & (sidb == tb)
        if not sel.all():
            ls, aa, bb = ls[sel], aa[sel], bb[sel]
            offa, offb = offa[sel], offb[sel]

        G = self.G
        if idx.left_node is not None:
            ln = idx.left_node
            try:
                left = {
                    k: G.nodes[ln]["offsets"][k] + (ln[1] - ln[0]) - 1
                    for k in (ta, tb)
                }
            except KeyError:
                return None
        else:
            left = {ta: -1, tb: -1}
        if idx.right_node is not None:
            rn = idx.right_node
            try:
                right = {k: G.nodes[rn]["offsets"][k] for k in (ta, tb)}
            except KeyError:
                return None
        else:
            right = {
                ta: G.graph["id2end"][ta],
                tb: G.graph["id2end"][tb],
            }

        skipleft = []
        skipright = []

        k = len(ls)
        if k == 1:
            si = 0
        else:
            if k > cfg.maxmums:
                ls, aa, bb = (
                    ls[-cfg.maxmums :],
                    aa[-cfg.maxmums :],
                    bb[-cfg.maxmums :],
                )
                offa, offb = offa[-cfg.maxmums :], offb[-cfg.maxmums :]
                k = cfg.maxmums

            # chain: [mums..., right] stable-sorted by the ref dim; the
            # native DP keys on unique ref starts (chaining.py:88-106)
            ca = np.concatenate([offa, [right[ta]]])
            cb = np.concatenate([offb, [right[tb]]])
            cl = np.concatenate([ls, [0]])
            cidx = np.concatenate([aa, [0]])
            cidxb = np.concatenate([bb, [0]])
            o3 = np.argsort(ca, kind="stable")
            ca, cb, cl = ca[o3], cb[o3], cl[o3]
            cidx, cidxb = cidx[o3], cidxb[o3]
            if (ca[1:] == ca[:-1]).any():
                return None  # aliasing ref starts: defer to generic path

            from ..native import chain_native

            starts_arr = np.stack([ca, cb], axis=1)
            nmul = int(cfg.wscore) * cl
            left_arr = np.array([left[ta], left[tb]], dtype=np.int64)
            res = chain_native(
                starts_arr, cl, nmul, left_arr, float(cfg.wpen)
            )
            if res is None:
                return None
            nlink, nscores = res
            if (nlink == -2).any():
                return None

            pos_r = int(np.nonzero(o3 == k)[0][0])
            slots = []
            s = pos_r
            while True:
                slots.append(s)
                nl = int(nlink[s])
                if nl < 0:
                    break
                s = nl
            # generic path: chainedmums = chain(...)[::-1] — left-to-right
            # order, right boundary excluded
            chained = slots[1:][::-1]
            if len(chained) == 0:
                return ()

            lc = cl[chained]
            # sorted(..., key=l)[-1]: the max-l entry latest in chain order
            j = len(lc) - 1 - int(np.argmax(lc[::-1]))
            si_slot = chained[j]

            if cfg.seedsize and cfg.seedsize > 0:
                tlist = skipleft
                scoreatsplit = 0.0
                for s in chained:
                    if s == si_slot:
                        scoreatsplit = float(nscores[s])
                        tlist = skipright
                        continue
                    if int(cl[s]) >= cfg.seedsize:
                        tlist.append(
                            (
                                (
                                    int(cl[s]),
                                    2,
                                    ((0, int(cidx[s])), (1, int(cidxb[s]))),
                                ),
                                float(nscores[s]) - scoreatsplit,
                            )
                        )
                # NB: the generic path appends all, then filters by
                # seedsize — same result, order preserved

            splitmum = (
                int(cl[si_slot]),
                2,
                ((0, int(cidx[si_slot])), (1, int(cidxb[si_slot]))),
            )
            return self._pvalue_gate(
                splitmum, left, right, minlength
            ) and (splitmum, skipleft, skipright) or ()

        splitmum = (int(ls[si]), 2, ((0, int(aa[si])), (1, int(bb[si]))))
        return self._pvalue_gate(splitmum, left, right, minlength) and (
            splitmum,
            skipleft,
            skipright,
        ) or ()

    def _boundary_arrays(self, idx):
        """(left_off, right_off) int64 arrays indexed by sample id for the
        native pick; INT64_MIN marks sids absent from the boundary node
        (the native pick defers to the generic path on those)."""
        import numpy as np

        G = self.G
        if self._nsid is None:
            self._nsid = int(self.fastmap[1].max()) + 1
        nsid = self._nsid
        MISSING = np.iinfo(np.int64).min
        if idx.left_node is None:
            left = np.full(nsid, -1, dtype=np.int64)
        else:
            ln = idx.left_node
            left = np.full(nsid, MISSING, dtype=np.int64)
            add = ln[1] - ln[0] - 1
            for k, v in G.nodes[ln]["offsets"].items():
                if k < nsid:
                    left[k] = v + add
        if idx.right_node is None:
            if self._id2end_arr is None:
                arr = np.full(nsid, MISSING, dtype=np.int64)
                for k, v in G.graph["id2end"].items():
                    if k < nsid:
                        arr[k] = v
                self._id2end_arr = arr
            right = self._id2end_arr
        else:
            rn = idx.right_node
            right = np.full(nsid, MISSING, dtype=np.int64)
            for k, v in G.nodes[rn]["offsets"].items():
                if k < nsid:
                    right[k] = v
        return left, right

    def _pick_pairwise_c(self, ls, aa, bb, idx, minlength):
        """One-crossing native pick; NotImplemented = run the numpy path."""
        try:
            from ..native import pick_pairwise_native
        except Exception:
            return NotImplemented
        cfg = self.cfg
        starts, sids = self.fastmap
        left_off, right_off = self._boundary_arrays(idx)
        res = pick_pairwise_native(
            ls, aa, bb, starts, sids, left_off, right_off,
            cfg.trim, cfg.maxmums, int(cfg.wscore), float(cfg.wpen),
            cfg.seedsize or 0, cfg.pcutoff, minlength,
        )
        if res is None:
            return NotImplemented
        st, (sl, sa_, sb), pvalue, skl, skr = res
        if st == 2:
            return NotImplemented
        if st == 1:
            if pvalue >= 0:
                log.info(
                    "P-value for anchor (n=2 l=%d) is %.4g — stop",
                    sl,
                    pvalue,
                )
            return ()
        splitmum = (sl, 2, ((0, sa_), (1, sb)))
        skipleft = [
            ((l, 2, ((0, a), (1, b))), s) for l, a, b, s in skl
        ]
        skipright = [
            ((l, 2, ((0, a), (1, b))), s) for l, a, b, s in skr
        ]
        return splitmum, skipleft, skipright

    def pick_multi(self, ls, ws, flat, offs, idx, minlength=0):
        """Native d-dim multiMUM pick (pick_multi_dp in esa.cpp) for
        segments of fasta inputs.  Returns None to defer to the generic
        tuple path, () to stop, or (splitmum, skipleft, skipright)."""
        cfg = self.cfg
        if (
            self.fastmap is None
            or cfg.splitchain != "largest"
            or cfg.gcmodel != "sumofpairs"
            or not float(cfg.wscore).is_integer()
        ):
            return None
        if len(ls) == 0:
            return ()
        if cfg.maxdepth is not None and idx.depth > cfg.maxdepth:
            return ()
        if cfg.maxsize is not None and self._maxsize_stop(idx):
            return ()
        try:
            from ..native import pick_multi_native
        except Exception:
            return None
        starts, sids = self.fastmap
        left_off, right_off = self._boundary_arrays(idx)
        SO = idx.main.SO
        res = pick_multi_native(
            ls, ws, flat, offs, idx.nsamples, starts, sids, SO,
            left_off, right_off, cfg.trim, cfg.maxmums,
            int(cfg.wscore), float(cfg.wpen), cfg.seedsize or 0,
            cfg.pcutoff, minlength,
        )
        if res is None:
            return None
        st, (sl, w, coords), pvalue, skl, skr = res
        if st == 2:
            return None
        if st == 1:
            if pvalue >= 0:
                log.info(
                    "P-value for anchor (n=%d l=%d) is %.4g — stop",
                    w,
                    sl,
                    pvalue,
                )
            return ()
        splitmum = (
            sl,
            w,
            tuple((int(SO[p]), p) for p in coords),
        )
        skipleft = [
            (
                (l, wi, tuple((int(SO[p]), p) for p in cs)),
                s,
            )
            for l, wi, cs, s in skl
        ]
        skipright = [
            (
                (l, wi, tuple((int(SO[p]), p) for p in cs)),
                s,
            )
            for l, wi, cs, s in skr
        ]
        return splitmum, skipleft, skipright

    def _pvalue_gate(self, splitmum, left, right, minlength) -> bool:
        """p-value significance stop (schemes.py:334-345); True = keep."""
        if minlength != 0:
            return True
        cfg = self.cfg
        o = 1
        for p in left:
            o = o * (right[p] - left[p])
        l = splitmum[0]
        n = splitmum[1]
        p = (0.25 ** (n - 1)) ** l
        if p > 0:
            p = 1 - math.exp(math.log(1 - p) * o)
        if p > cfg.pcutoff:
            log.info(
                "P-value for anchor (n=%d l=%d o=%d) is %.4g — stop",
                n,
                l,
                o,
                p,
            )
            return False
        return True
