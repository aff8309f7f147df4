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
from .pangraph import PanGraph

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
