"""Global multiMUM chaining construction (the `chain` subcommand).

Port of reveal/chain.py: an alternative to the REM
recursion — per level, chain the multiMUMs spanning all genomes with an
optimal-predecessor DP over k-dimensional points, splice the chain into the
graph, and recurse on the gaps between consecutive anchors.

The reference uses a k-d tree for the predecessor range queries
(utils.kdtree/range_search); here the dominance test is a vectorized numpy
scan over the (maxmums-capped) point set.
"""

from __future__ import annotations

import logging
import uuid
from typing import List

import numpy as np

from .chaining import gapcost
from ..core.encoding import to_str
from ..core.io_fasta import fasta_reader
from ..core.textstore import TextStore
from ..graph.pangraph import PanGraph
from ..index.esa_index import ESAIndex

log = logging.getLogger(__name__)


def _chain_level(idx, offsets, minlength, maxmums, gcmodel, wpen, wscore):
    """chain.py:214-314: optimal chain of all-genome multiMUMs at one
    level.  Returns (subgraph, p1, p2, nodepath)."""
    k = idx.nsamples
    if k > 2:
        mums = idx.getmultimums(minlength=minlength, minn=k)
    else:
        mums = idx.getmums_rem(minlength)

    G = PanGraph()
    nsep = [int(s) for s in idx.nsep[:-1]]
    localoffsets = tuple([0] + [sep + 1 for sep in nsep])
    localstart = tuple([-1] + [sep for sep in nsep])
    localend = tuple([sep - 1 for sep in nsep] + [idx.n - 2])
    lengths = tuple(e - s for s, e in zip(localstart, localend))

    p1 = tuple(o - 1 for o in offsets)
    p2 = tuple(o + l for o, l in zip(offsets, lengths))

    mums = [m for m in mums if m[1] == k]
    if len(mums) == 0:
        return G, p1, p2, [p1, p2]
    if maxmums and len(mums) > maxmums:
        mums = sorted(mums, key=lambda m: m[0])[-maxmums:]
    else:
        mums = sorted(mums, key=lambda m: m[0])

    points = []
    lmap = {}
    for mum in mums:
        point = sorted(sp for gid, sp in mum[2])
        for i in range(len(point)):
            point[i] = offsets[i] + (point[i] - localoffsets[i])
        point = tuple(point)
        points.append(point)
        G.add_node(point, l=mum[0])
        lmap[point] = mum[0]

    G.add_node(p1, s=0, l=0, score=0)
    G.add_node(p2, s=0, l=0, score=0)
    points.append(p2)
    points.sort(key=lambda p: p[0])

    # vectorized dominance scan instead of the k-d tree
    pts = np.array(points, dtype=np.int64)  # (n, k) sorted by dim 0
    ls = np.array([lmap.get(p, 0) for p in points], dtype=np.int64)
    scores = {p1: 0.0}

    for ti in range(len(points)):
        t = points[ti]
        tv = pts[ti]
        bestpoint = p1
        bestpenalty = gapcost(list(p1), list(t), model=gcmodel)
        bestscore = -1 * (wpen * bestpenalty)
        # candidates: strictly inside (p1, t) on every dim, non-overlapping
        cand = np.nonzero(
            (pts[:ti] > np.array(p1)).all(axis=1)
            & (pts[:ti] + ls[:ti, None] <= tv).all(axis=1)
        )[0]
        for vi in cand.tolist():
            v = points[vi]
            if v == t:
                continue
            l = lmap.get(v, 0)
            penalty = gapcost(
                [c + l for c in v], list(t), model=gcmodel
            )
            score = (
                scores[v]
                + (wscore * (l * ((len(v) * (len(v) - 1)) // 2)))
                - (wpen * penalty)
            )
            if score > bestscore:
                bestscore = score
                bestpoint = v
                bestpenalty = penalty
        scores[t] = bestscore
        G.add_edge(bestpoint, t, p=bestpenalty)

    # backtrack from p2
    bestpath = []
    v = p2
    while v != p1:
        bestpath.append(v)
        G.nodes[v]["aligned"] = 1
        v = next(iter(G.predecessors(v)))
    bestpath.append(p1)

    keep = set(bestpath)
    for node in list(G.nodes):
        if node not in keep:
            G.remove_node(node)

    return G, p1, p2, bestpath[::-1]


def _output_variant_nodes(G, T, source, sink, varnodes, lengths):
    """chain.py:184-212 (merge=True)."""
    uvarseq = {}
    gaps = []
    for n, l in zip(varnodes, lengths):
        s = to_str(T[n : n + l])
        if "N" not in s:
            uvarseq.setdefault(s, []).append(n)
        else:
            gaps.append((n, l))
    for uv, ns in uvarseq.items():
        key = tuple(ns)
        G.add_node(key, l=len(uv), aligned=1 if len(ns) > 1 else 0)
        G.add_edge(source, key)
        G.add_edge(key, sink)
    for gap, l in gaps:
        key = (gap,)
        G.add_node(key, l=l, aligned=0)
        G.add_edge(source, key)
        G.add_edge(key, sink)


def _insert_subgraph(G, start, end, subg, sstart, send, keepedge):
    """chain.py:316-340."""
    upref = uuid.uuid4().hex
    relabel = {sstart: upref + str(sstart), send: upref + str(send)}
    H = PanGraph()
    for n, d in subg.nodes.items():
        H.add_node(relabel.get(n, n), **d)
    for u, v, d in subg.edges(data=True):
        H.add_edge(relabel.get(u, u), relabel.get(v, v), **d)
    subg = H
    for node in subg.nodes:
        assert node not in G.nodes
    for n, d in subg.nodes.items():
        G.add_node(n, **d)
    for u, v, d in subg.edges(data=True):
        G.add_edge(u, v, **d)
    for nei in list(G.successors(relabel[sstart])):
        G.add_edge(start, nei)
    for nei in list(G.predecessors(relabel[send])):
        G.add_edge(nei, end)
    if not keepedge:
        G.remove_edge(start, end)
    G.remove_node(relabel[send])
    G.remove_node(relabel[sstart])


def chain_cmd_impl(
    fastas: List[str],
    minlength: int = 20,
    minn: int = 2,
    maxmums: int = 10000,
    recurse: bool = True,
    gcmodel: str = "sumofpairs",
    wpen: float = 1,
    wscore: float = 1,
    backend: str = "auto",
    output=None,
):
    ts = TextStore()
    seq_ranges = []  # (start, end, sample)
    for fasta in fastas:
        sample = fasta.split("/")[-1]
        ts.add_sample(sample)
        for i, (name, seq) in enumerate(fasta_reader(fasta)):
            if i == 1:
                raise ValueError(
                    "chain can't handle multi-fasta input; one sequence "
                    "per file"
                )
            f, t = ts.add_sequence(seq)
            seq_ranges.append((f, t, sample))

    root = ESAIndex.construct(ts, backend=backend)
    T = root.main.T
    nsep = [int(s) for s in root.nsep[:-1]]

    G = PanGraph()
    G.graph["paths"] = list(ts.samples)
    for sid, sample in enumerate(G.graph["paths"]):
        G.graph["path2id"][sample] = sid
        G.graph["id2path"][sid] = sample

    istart = tuple([-1] + nsep)
    iend = tuple(nsep + [root.n - 1])
    startcoords = tuple([0] + [sep + 1 for sep in nsep])
    G.add_node(istart, l=0)
    G.add_node(iend, l=0)
    G.add_edge(istart, iend)

    stack = [(root, list(range(ts.nsamples)), istart, iend, startcoords, 0, False)]

    while stack:
        idx, idc, p1, p2, offsets, depth, keepedge = stack.pop()
        subg, pp1, pp2, nodepath = _chain_level(
            idx, offsets, minlength, maxmums, gcmodel, wpen, wscore
        )
        if len(nodepath) == 2:
            lnsep = [int(s) for s in idx.nsep[:-1]]
            localstart = tuple([-1] + lnsep)
            localend = tuple([sep - 1 for sep in lnsep] + [idx.n - 2])
            lengths = tuple(e - s for s, e in zip(localstart, localend))
            _output_variant_nodes(G, T, p1, p2, offsets, lengths)
            if not keepedge:
                G.remove_edge(p1, p2)
            continue

        _insert_subgraph(G, p1, p2, subg, pp1, pp2, keepedge)

        coordpath = list(nodepath)
        coordpath[0] = tuple(d + 1 for d in nodepath[0])
        nodepath[0] = p1
        nodepath[-1] = p2

        fromcoord = coordpath[0]
        fromnode = nodepath[0]
        l = 0
        for node, pos in zip(nodepath[1:], coordpath[1:]):
            seqs = []
            idc_ = []
            keepedge = False
            for i in idc:
                f = fromcoord[i]
                t = pos[i]
                if f + l < t:
                    seqs.append(to_str(T[f + l : t]))
                    idc_.append(i)
                elif f + l == t:
                    keepedge = True
                else:
                    raise RuntimeError("overlapping matches")
            if len(seqs) >= minn and recurse:
                sub_ts = TextStore()
                for i, s in enumerate(seqs):
                    assert "$" not in s
                    sub_ts.add_sample(str(i))
                    sub_ts.add_sequence(s)
                subidx = ESAIndex.construct(sub_ts, backend="np")
                newoffsets = tuple(fromcoord[i] + l for i in idc_)
                stack.append(
                    (
                        subidx,
                        list(range(len(newoffsets))),
                        fromnode,
                        node,
                        newoffsets,
                        depth + 1,
                        keepedge,
                    )
                )
            else:
                varnodes = [fromcoord[i] + l for i in idc_]
                lengths = [pos[i] - (fromcoord[i] + l) for i in idc_]
                _output_variant_nodes(G, T, fromnode, node, varnodes, lengths)
                if not keepedge:
                    G.remove_edge(fromnode, node)
            fromcoord = pos
            fromnode = node
            if node != nodepath[-1]:
                l = subg.nodes[node]["l"]

    G.remove_node(istart)
    G.remove_node(iend)

    # attach seq + offsets (chain.py:130-144)
    import bisect

    starts = [r[0] for r in seq_ranges]

    def locate(c):
        i = bisect.bisect_right(starts, c) - 1
        f, t, sample = seq_ranges[i]
        assert f <= c <= t
        return f, sample

    tot = totn = 0
    for node, data in G.nodes.items():
        data["offsets"] = {}
        assert isinstance(node, tuple)
        data["seq"] = to_str(T[node[0] : node[0] + data["l"]]).upper()
        for c in node:
            f, sample = locate(c)
            data["offsets"][G.graph["path2id"][sample]] = c - f
        if data.get("aligned") == 1:
            tot += data["l"]
            totn += 1
    log.info(
        "Aligned %d bases in %d nodes (total %d nodes, %d edges).",
        tot,
        totn,
        G.number_of_nodes(),
        G.number_of_edges(),
    )

    # annotate edges with path sets + endpoint markers for the writer
    for sample in G.graph["paths"]:
        sid = G.graph["path2id"][sample]
        sg = [n for n, d in G.nodes.items() if sid in d["offsets"]]
        sub = G.subgraph(sg)
        topsort = sub.topological_sort()
        if not topsort:
            continue
        pnode = topsort[0]
        for node in topsort[1:]:
            d = G.edge(pnode, node)
            d.setdefault("paths", set()).add(sid)
            d.setdefault("ofrom", "+")
            d.setdefault("oto", "+")
            pnode = node
        s = uuid.uuid4().hex
        e = uuid.uuid4().hex
        G.add_node(s, offsets={sid: 0}, endpoint=True)
        G.add_node(e, offsets={sid: G.graph["id2end"].get(sid, 0)}, endpoint=True)
        G.graph["startnodes"].append(s)
        G.graph["endnodes"].append(e)
        G.add_edge(s, topsort[0], paths={sid}, ofrom="+", oto="+")
        G.add_edge(topsort[-1], e, paths={sid}, ofrom="+", oto="+")

    # default 'paths' on any remaining unannotated edges
    for _, _, d in G.edges(data=True):
        d.setdefault("paths", set())
        d.setdefault("ofrom", "+")
        d.setdefault("oto", "+")

    return G, T
