"""Path extraction: graph + path name -> sequence.

Port of reveal/extract.py:80-170 (DiGraph flavor): collect
the edges carrying the path id, topologically sort that subgraph, honor
``oto`` orientation (reverse complement) and cigar overlap offsets.
``_longest_`` resolves the heaviest path by sequence weight.
"""

from __future__ import annotations

import re

from .pangraph import PanGraph
from ..core.encoding import rc_str


def extract(G: PanGraph, sample: str) -> str:
    if sample == "_longest_":
        return _longest_path_seq(G)

    if sample not in G.graph["path2id"]:
        raise KeyError(
            "Unknown path: %s, graph contains: %s"
            % (sample, list(G.graph["path2id"]))
        )
    sid = G.graph["path2id"][sample]

    sg_edges = [
        (u, v, d) for u, v, d in G.edges(data=True) if sid in d["paths"]
    ]
    if not sg_edges:
        for n in G.nodes:
            if sid in G.nodes[n].get("offsets", {}):
                return G.nodes[n].get("seq", "")
        return ""

    sub = PanGraph()
    for u, v, d in sg_edges:
        sub.add_edge(u, v, **d)
    path = sub.topological_sort()

    inito = sub.edge(path[0], path[1])["ofrom"]
    seq = []
    pnode = None
    for node in path:
        offset = 0
        if pnode is None:
            o = inito
        else:
            d = sub.edge(pnode, node)
            o = d["oto"]
            cigar = d.get("cigar", "0M")
            if cigar != "0M":
                for l, t in re.findall(r"(\d+)(\w)", cigar):
                    if t in ("M", "I", "S", "P"):
                        offset += int(l)
        s = G.nodes[node].get("seq", "")
        if o != "+":
            s = rc_str(s)
        assert len(s) >= offset
        seq.append(s[offset:])
        pnode = node
    return "".join(seq)


def _longest_path_seq(G: PanGraph) -> str:
    """Heaviest (by non-N sequence length) path through the DAG."""
    order = G.topological_sort()
    best = {n: 0 for n in order}
    prev = {n: None for n in order}

    def w(n):
        s = G.nodes[n].get("seq", "")
        return len(s) - s.count("N")

    for n in order:
        for m in G.successors(n):
            cand = best[n] + w(m)
            if cand > best[m]:
                best[m] = cand
                prev[m] = n
    end = max(order, key=lambda n: best[n])
    path = []
    while end is not None:
        path.append(end)
        end = prev[end]
    path.reverse()
    return "".join(G.nodes[n].get("seq", "") for n in path)


def extract_path(G: PanGraph, path_steps) -> str:
    """Explicit node-walk extraction (extract.extract_path,
    reveal/extract.py:172-185): each step is
    '<nodeid>+' / '<nodeid>-'; '-' steps contribute the reverse
    complement."""
    seq = []
    for step in path_steps:
        nid, o = int(step[:-1]), step[-1:]
        if o not in ("+", "-"):
            raise ValueError("bad orientation in step %r" % step)
        s = G.nodes[nid].get("seq", "")
        seq.append(s if o == "+" else rc_str(s))
    return "".join(seq)
