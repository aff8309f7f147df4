"""Superbubble detection and variant extraction.

Port of reveal/bubbles.py:

* ``bubbles(G)``: linear-time superbubble enumeration in topological order
  (Brankovic-style entrance/exit candidates with outparent/outchild arrays,
  bubbles.py:68-237);
* ``Bubble``: source/sink/nodes + per-path allele sizes (bubbles.py:537-634)
  including the ``getwiggle`` indel-shift margins used by unzip;
* ``Variant``: per-path genotype sequences, allele dedup, per-sample calls
  and type classification (snp/indel/multi-allelic/region/complex,
  bubbles.py:636-713).
"""

from __future__ import annotations

import logging
from typing import List, Optional

from .pangraph import PanGraph

log = logging.getLogger(__name__)


class InvalidBubble(Exception):
    pass


def _entrance(G, v):
    for c in G.successors(v):
        if len(list(G.predecessors(c))) == 1:
            return True
    return False


def _exit(G, v):
    for p in G.predecessors(v):
        if len(list(G.successors(p))) == 1:
            return True
    return False


def _superbubble_pairs(G: PanGraph):
    """Candidate scan + validation; returns (ordD, order, sspairs)."""
    candidates = []
    sspairs = []
    prev_ent_i = None
    alternative_entrance = {}
    previous_entrance = {}

    order = G.topological_sort()
    ordD = {}

    for i, v in enumerate(order):
        ordD[v] = i
        alternative_entrance[v] = None
        previous_entrance[v] = prev_ent_i
        if _exit(G, v):
            candidates.append((v, 1))
        if _entrance(G, v):
            candidates.append((v, 0))
            prev_ent_i = i

    n = len(order)
    outparent = [None] * n
    outchild = [None] * n
    for c in order:
        preds = [ordD[p] for p in G.predecessors(c)]
        if preds:
            outparent[ordD[c]] = min(preds)
        sucs = [ordD[s] for s in G.successors(c)]
        if sucs:
            outchild[ordD[c]] = max(sucs)

    def nextentrance(s):
        try:
            at = candidates.index((s, 0))
        except ValueError:
            return None
        for candidate in candidates[at + 1 :]:
            if candidate[1] == 0:
                return candidate
        return None

    def validate(start_vertex, end_vertex):
        start = ordD[start_vertex]
        end = ordD[end_vertex]
        if start + 1 != end:
            ocs = outchild[start:end]
            ops = outparent[start + 1 : end + 1]
            # py2 semantics: None sorts below every int, so max() skips
            # None unless all are None, and min() returns None if present
            oc = max(
                (x for x in ocs if x is not None), default=None
            )
            if any(x is None for x in ops):
                op = None
            else:
                op = min(ops, default=None)
        else:
            oc = outchild[start]
            op = outparent[end]
        if oc != end:
            return -1
        if op == start:
            return start_vertex
        if op is None:
            return -1
        if _entrance(G, order[op]):
            return order[op]
        if previous_entrance[order[op]] is None:
            return -1
        return order[previous_entrance[order[op]]]

    def report(vstart, vexit):
        if (
            vstart[0] is None
            or vexit[0] is None
            or ordD[vstart[0]] >= ordD[vexit[0]]
        ):
            del candidates[-1]
            return
        si = previous_entrance[vexit[0]]
        if si is None:
            del candidates[-1]
            return
        s = order[si]
        valid = None
        while ordD[s] >= ordD[vstart[0]]:
            valid = validate(s, vexit[0])
            if valid == s or valid == alternative_entrance[s] or valid == -1:
                break
            alternative_entrance[s] = valid
            s = valid
        del candidates[-1]
        if valid == s:
            sspairs.append((s, vexit[0]))
            while candidates and candidates[-1][0] is not s:
                if candidates[-1][1] == 1:
                    ne = nextentrance(s)
                    if ne is not None:
                        report(ne, candidates[-1])
                    else:
                        del candidates[-1]
                else:
                    del candidates[-1]

    while candidates:
        if candidates[-1][1] == 0:
            del candidates[-1]
        else:
            report(candidates[0], candidates[-1])

    return ordD, order, sspairs


def bubbles(G: PanGraph):
    """Yield Bubble objects in topological order of their source
    (bubbles.py:215-237)."""
    ordD, order, sspairs = _superbubble_pairs(G)

    allpairs = sorted(sspairs, key=lambda a: ordD[a[0]])

    for v, u in allpairs:
        bubblenodes = order[ordD[v] : ordD[u] + 1]
        sourcesamples = set(G.nodes[v]["offsets"].keys())
        sinksamples = set(G.nodes[u]["offsets"].keys())
        if sinksamples != sourcesamples:
            log.debug("Invalid bubble between %s and %s", v, u)
            continue
        if len(bubblenodes) == 2:
            continue
        yield Bubble(G, v, u, ordD[v], ordD[u], bubblenodes)


class Bubble:
    def __init__(self, G: PanGraph, source, sink, source_idx, sink_idx, nodes):
        self.G = G
        self.source = source
        self.sink = sink
        self.source_idx = source_idx
        self.sink_idx = sink_idx
        self.nodes = nodes
        self.ordD = {node: i for i, node in enumerate(nodes)}
        if len(self.nodes) <= 2:
            raise InvalidBubble("not a valid source/sink pair")
        self.simple: Optional[bool] = None

        id2path = G.graph["id2path"]
        self.paths = {
            k
            for k in G.nodes[source]["offsets"]
            if not id2path[k].startswith("*")
        } & {
            k
            for k in G.nodes[sink]["offsets"]
            if not id2path[k].startswith("*")
        }

        l = self._nodelen(source)
        self.allelesizes = [
            G.nodes[sink]["offsets"][p] - (G.nodes[source]["offsets"][p] + l)
            for p in self.paths
        ]
        self.minsize = min(self.allelesizes)
        self.maxsize = max(self.allelesizes)
        self.cumsize = sum(self.allelesizes)
        assert self.minsize >= 0

    def _nodelen(self, n):
        d = self.G.nodes[n]
        if "seq" in d:
            return len(d["seq"])
        return n[1] - n[0]

    def _nodeseq(self, n):
        d = self.G.nodes[n]
        if "seq" in d:
            return d["seq"]
        return ""

    def issimple(self) -> bool:
        if self.simple is None:
            G = self.G
            sucs = set(G.successors(self.source))
            pres = set(G.predecessors(self.sink))
            sucs.discard(self.sink)
            pres.discard(self.source)
            self.simple = True
            for suc in sucs:
                nxt = list(G.successors(suc))
                if len(nxt) != 1 or nxt[0] != self.sink:
                    self.simple = False
                    return self.simple
            for pre in pres:
                prv = list(G.predecessors(pre))
                if len(prv) != 1 or prv[0] != self.source:
                    self.simple = False
                    return self.simple
        return self.simple

    def getwiggle(self, minwiggle: int = 0):
        """Indel left/right shift margins (bubbles.py:598-634)."""
        if self.issimple() and self.G.has_edge(self.source, self.sink):
            sink = self._nodeseq(self.sink)
            source = self._nodeseq(self.source)
            # note: the reference's inner for-loop over vs[1:] breaks only
            # out of itself and never stops the scan, so effectively only
            # vs[0] bounds the wiggle (bubbles.py:616-630); replicated as-is
            vs = [self._nodeseq(n) + sink for n in self.nodes[1:-1]]
            lvs = [len(s) for s in vs] + [len(sink)]
            i = 0
            while i < min(lvs) and sink[i] == vs[0][i]:
                i += 1
            vs = [source + self._nodeseq(n) for n in self.nodes[1:-1]]
            lvs = [len(s) for s in vs] + [len(source)]
            j = 1
            while j <= min(lvs) and source[-j] == vs[0][-j]:
                j += 1
            return (minwiggle + j - 1, minwiggle + i)
        return (minwiggle, minwiggle)


class Variant(Bubble):
    def __init__(self, bubble: Bubble):
        Bubble.__init__(
            self,
            bubble.G,
            bubble.source,
            bubble.sink,
            bubble.source_idx,
            bubble.sink_idx,
            bubble.nodes,
        )
        G = self.G
        self.genotypes: List[str] = []
        self.vtype = "complex"
        self.gap = "undefined"
        self.calls = {}
        self.vpos = {}
        self.spans_gap = False

        bsamples = set(G.nodes[self.source]["offsets"]) & set(
            G.nodes[self.sink]["offsets"]
        )

        seqd = {}
        order = []
        for sid in sorted(bsamples):
            seq = ""
            for v in self.nodes[1:-1]:
                if sid in G.nodes[v]["offsets"]:
                    seq += G.nodes[v]["seq"]
            if seq == "":
                seq = "-"
            if seq in seqd:
                seqd[seq].append(sid)
            else:
                seqd[seq] = [sid]
                order.append(seq)

        self.genotypes = order
        id2path = G.graph["id2path"]
        for i, k in enumerate(self.genotypes):
            for sid in seqd[k]:
                self.calls[id2path[sid]] = i

        if self.issimple():
            if G.has_edge(self.source, self.sink):
                self.vtype = "indel"
            elif len(self.genotypes) == 2:
                if (
                    len(self.genotypes[0]) == 1
                    and len(self.genotypes[1]) == 1
                ):
                    self.vtype = "snp"
                else:
                    self.vtype = "region"
            else:
                self.vtype = "multi-allelic"

        for node in self.nodes:
            if "N" in G.nodes[node].get("seq", ""):
                self.spans_gap = True
                self.gap = (
                    "simplegap" if self.issimple() else "complexgap"
                )
                break

        v = G.nodes[self.source]
        t = G.nodes[self.sink]
        for s in set(v["offsets"]) & set(t["offsets"]):
            self.vpos[s] = v["offsets"][s] + len(v.get("seq", "")) + 1
