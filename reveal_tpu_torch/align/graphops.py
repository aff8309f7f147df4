"""Graph surgery for the REM recursion.

Ports the callback-side graph operations of the reference
(reveal/rem.py:14-316) onto PanGraph:

* ``breaknode``: split a node interval at a match into prefix/match/suffix;
* ``mergenodes``: collapse the matched nodes of all samples into one aligned
  node, merging offsets and redirecting edges;
* ``segmentgraph``: BFS forward/backward from the merged node to classify
  the remaining unaligned intervals into leading / trailing / parallel.

Interval lookup uses a sorted-by-begin table of the (disjoint) unaligned
node intervals instead of an interval tree.
"""

from __future__ import annotations

from collections import deque
from typing import List, Set, Tuple

from sortedcontainers import SortedList

from ..graph.pangraph import PanGraph


class IntervalIndex:
    """Disjoint (begin, end) intervals with point lookup."""

    def __init__(self):
        self._sl = SortedList()

    def add(self, iv: Tuple[int, int]):
        self._sl.add(iv)

    def remove(self, iv: Tuple[int, int]):
        self._sl.remove(iv)

    def lookup(self, pos: int) -> Tuple[int, int]:
        """The unique interval containing pos (begin <= pos < end)."""
        i = self._sl.bisect_right((pos, float("inf"))) - 1
        if i < 0:
            raise KeyError(pos)
        iv = self._sl[i]
        if not (iv[0] <= pos < iv[1]):
            raise KeyError(pos)
        return iv

    def lookup_batch(self, positions) -> List[Tuple[int, int]]:
        """Point lookup for many positions.

        Positions from one picker call cluster into the few intervals of
        one segment, so we process them in sorted order and reuse the
        last hit before bisecting again — most lookups become a range
        check.  (A numpy snapshot of ALL intervals was tried and
        reverted: the index mutates between picker calls, making the
        per-call snapshot cost dominate.)"""
        sl = self._sl
        inf = float("inf")
        bisect = sl.bisect_right
        k = len(positions)
        order = sorted(range(k), key=positions.__getitem__)
        out = [None] * k
        iv = None
        for oi in order:
            p = positions[oi]
            if iv is None or not (iv[0] <= p < iv[1]):
                i = bisect((p, inf)) - 1
                if i < 0:
                    raise KeyError(p)
                iv = sl[i]
                if not (iv[0] <= p < iv[1]):
                    raise KeyError(p)
            out[oi] = iv
        return out

    def __len__(self):
        return len(self._sl)

    def __iter__(self):
        return iter(self._sl)


def breaknode(G: PanGraph, t: IntervalIndex, node, pos, l):
    """rem.py:14-129.  Returns (matchnode, other_new_nodes)."""
    att = G.nodes[node]
    in_edges = [(u, d) for u, _, d in G.in_edges(node, data=True)]
    out_edges = [(v, d) for _, v, d in G.out_edges(node, data=True)]

    mn = (pos, pos + l)
    other: Set = set()
    if mn == node:
        t.remove(node)
        return node, other

    allpaths = set(att["offsets"].keys())
    moffsets = {s: att["offsets"][s] + (pos - node[0]) for s in att["offsets"]}
    soffsets = {
        s: att["offsets"][s] + ((pos + l) - node[0]) for s in att["offsets"]
    }

    negstrand = False
    negpaths: Set = set()
    pospaths: Set = set()
    if not in_edges and not out_edges:
        pospaths = allpaths
    else:
        for _, d in in_edges:
            if d["oto"] == "-":
                negstrand = True
                negpaths |= d["paths"]
            else:
                pospaths |= d["paths"]
        for _, d in out_edges:
            if d["ofrom"] == "-":
                negstrand = True
                negpaths |= d["paths"]
            else:
                pospaths |= d["paths"]
    assert not (pospaths & negpaths)

    G.add_node(mn, offsets=moffsets, aligned=0)

    if node[0] != pos:
        pn = (node[0], pos)
        G.add_node(pn, offsets=dict(att["offsets"]), aligned=0)
        G.add_edge(pn, mn, paths=set(pospaths), ofrom="+", oto="+")
        if negstrand:
            G.add_edge(mn, pn, paths=set(negpaths), ofrom="-", oto="-")
        t.add(pn)
        other.add(pn)
    else:
        pn = mn

    if node[1] != pos + l:
        sn = (pos + l, node[1])
        G.add_node(sn, offsets=soffsets, aligned=0)
        G.add_edge(mn, sn, paths=set(pospaths), ofrom="+", oto="+")
        if negstrand:
            G.add_edge(sn, mn, paths=set(negpaths), ofrom="-", oto="-")
        t.add(sn)
        other.add(sn)
    else:
        sn = mn

    G.remove_node(node)
    t.remove(node)

    for fro, d in in_edges:
        if d["oto"] == "+":
            G.add_edge(fro, pn, **d)
        else:
            G.add_edge(fro, sn, **d)
    for to, d in out_edges:
        if d["ofrom"] == "+":
            G.add_edge(sn, to, **d)
        else:
            G.add_edge(pn, to, **d)
    return mn, other


def mergenodes(G: PanGraph, mns: List):
    """rem.py:131-201 (DiGraph branch): merge matched nodes into mns[0]."""
    refnode = mns[0]
    newoffsets = {}
    for node in mns:
        for sid, off in G.nodes[node]["offsets"].items():
            newoffsets[sid] = off
    G.nodes[refnode]["offsets"] = newoffsets
    G.nodes[refnode]["aligned"] = 1

    multi = getattr(G, "multi", False)
    for mn in mns[1:]:
        if multi:
            # Multi branch (rem.py:167-186): merge a parallel edge only
            # when an existing one has the same endpoints AND orientations
            for u, _, d in list(G.in_edges(mn, data=True)):
                for _u, _v, _d in list(G.in_edges(refnode, data=True)):
                    if (
                        type(_u) == type(u)
                        and _u == u
                        and _d["oto"] == d["oto"]
                        and _d["ofrom"] == d["ofrom"]
                    ):
                        _d["paths"] |= d["paths"]
                        break
                else:
                    G.add_edge(u, refnode, **d)
            for _, v, d in list(G.out_edges(mn, data=True)):
                for _u, _v, _d in list(G.out_edges(refnode, data=True)):
                    if (
                        type(_v) == type(v)
                        and _v == v
                        and _d["oto"] == d["oto"]
                        and _d["ofrom"] == d["ofrom"]
                    ):
                        _d["paths"] |= d["paths"]
                        break
                else:
                    G.add_edge(refnode, v, **d)
            G.remove_node(mn)
            continue
        for u, _, d in list(G.in_edges(mn, data=True)):
            if G.has_edge(u, refnode):
                G.edge(u, refnode)["paths"] |= d["paths"]
            else:
                G.add_edge(u, refnode, **d)
        for _, v, d in list(G.out_edges(mn, data=True)):
            if G.has_edge(refnode, v):
                G.edge(refnode, v)["paths"] |= d["paths"]
            else:
                G.add_edge(refnode, v, **d)
        G.remove_node(mn)
    return refnode


def _iter_real(G: PanGraph, node, reverse: bool):
    """Successor/predecessor iteration restricted to non-'*' paths
    (rem.py:203-231)."""
    id2path = G.graph["id2path"]
    nbrs = G.pred[node] if reverse else G.succ[node]
    if getattr(G, "multi", False):
        # parallel-edge container: key -> data (rem.py:203-231 Multi branch)
        for nb, kd in nbrs.items():
            done = False
            for d in kd.values():
                for p in d["paths"]:
                    if not id2path[p].startswith("*"):
                        yield nb
                        done = True
                        break
                if done:
                    break
        return
    for nb, d in nbrs.items():
        for p in d["paths"]:
            if not id2path[p].startswith("*"):
                yield nb
                break


def bfs(G: PanGraph, source, reverse=False, ignore=frozenset()):
    """Faithful re-expression of rem.py's bfs generator semantics."""
    if reverse:
        neighbors = lambda n: _iter_real(G, n, True)
    else:
        neighbors = lambda n: _iter_real(G, n, False)
    visited = {source}
    queue = deque([(source, iter(list(neighbors(source))))])
    while queue:
        parent, children = queue[0]
        try:
            child = next(children)
            if child not in visited:
                visited.add(child)
                attrs = G.nodes[child]
                if "aligned" not in attrs:
                    yield child, 2
                elif attrs["aligned"] == 0:
                    queue.append((child, iter(list(neighbors(child)))))
                    yield child, 0
                elif child in ignore:
                    queue.append((child, iter(list(neighbors(child)))))
                    yield child, 0
                else:
                    yield child, 1
        except StopIteration:
            queue.popleft()


def segmentgraph(G: PanGraph, node, nodes):
    """rem.py:260-316: classify interval-nodes around the merged node into
    (leading, trailing, rest) interval sets."""
    trailing = set()
    leading = set()
    reverse_trailing = set()
    reverse_leading = set()
    nodes = set(nodes)

    endpoints = set()
    for c, k in bfs(G, node):
        if k == 0:
            trailing.add(c)
        else:
            endpoints.add(c)
    if len(endpoints) > 1:
        for endpoint in endpoints:
            for c, k in bfs(G, endpoint, reverse=True, ignore=endpoints):
                if k == 0:
                    reverse_trailing.add(c)
        trailing &= reverse_trailing

    endpoints = set()
    for c, k in bfs(G, node, reverse=True):
        if k == 0:
            leading.add(c)
        else:
            endpoints.add(c)
    if len(endpoints) > 1:
        for endpoint in endpoints:
            for c, k in bfs(G, endpoint, ignore=endpoints):
                if k == 0:
                    reverse_leading.add(c)
        leading &= reverse_leading

    leading = {
        (c[0], c[1]) for c in leading if isinstance(c, tuple)
    } & nodes
    trailing = {
        (c[0], c[1]) for c in trailing if isinstance(c, tuple)
    } & nodes
    rest = nodes - (leading | trailing)
    return leading, trailing, rest


def prune_nodes(G: PanGraph, T=None):
    """rem.py:385-444: iteratively merge sibling nodes with identical
    sequence (same +/+ parent or child set constraints)."""
    from ..core.encoding import to_str

    def node_seq(n):
        d = G.nodes[n]
        if "seq" in d:
            return d["seq"]
        if isinstance(n, tuple):
            return to_str(T[n[0] : n[1]]) if T is not None else None
        return None

    converged = False
    while not converged:
        converged = True
        for node in list(G.nodes):
            if node not in G.nodes:
                continue
            for run in (0, 1):
                if run == 0:
                    neis = [
                        v
                        for _, v, d in G.out_edges(node, data=True)
                        if d["ofrom"] == "+" and d["oto"] == "+"
                    ]
                else:
                    neis = [
                        u
                        for u, _, d in G.in_edges(node, data=True)
                        if d["ofrom"] == "+" and d["oto"] == "+"
                    ]
                seqs = {}
                for nei in neis:
                    s = node_seq(nei)
                    if s is None:
                        continue
                    seqs.setdefault(s, []).append(nei)
                for group in seqs.values():
                    if len(group) <= 1:
                        continue
                    merge = True
                    for v in group:
                        if run == 0:
                            deg = len(
                                [
                                    u
                                    for u, _, d in G.in_edges(v, data=True)
                                    if d["ofrom"] == "+" and d["oto"] == "+"
                                ]
                            )
                        else:
                            deg = len(
                                [
                                    w
                                    for _, w, d in G.out_edges(v, data=True)
                                    if d["ofrom"] == "+" and d["oto"] == "+"
                                ]
                            )
                        if deg > 1:
                            merge = False
                            break
                    if merge:
                        mergenodes(G, group)
                        converged = False
