"""Chop: make a graph mappable by k-length reads.

Port of reveal/chop.py: iteratively duplicate branching
nodes whose context is too short, contract unary chains, then extend every
node with a k-1 prefix/suffix from its neighbour so that every k-mer of
every haplotype occurs in some node; edges get (k-1)M cigars.
"""

from __future__ import annotations

import logging
import sys
from typing import List

from .pangraph import PanGraph
from .simplify import contract

log = logging.getLogger(__name__)


def duplicate_node(G: PanGraph, node) -> List[int]:
    """chop.py:76-115."""
    offsets = G.nodes[node]["offsets"]
    seq = G.nodes[node]["seq"]
    es = []
    duplicates = []
    predecessors = list(G.predecessors(node))
    successors = list(G.successors(node))
    if predecessors and successors:
        for pred in predecessors:
            for suc in successors:
                i = G.edge(pred, node)["paths"] & G.edge(node, suc)["paths"]
                if i:
                    nid = G.graph["noffset"]
                    G.add_node(
                        nid,
                        offsets={k: offsets[k] for k in offsets if k in i},
                        seq=seq,
                        prefix="",
                        suffix="",
                    )
                    duplicates.append(nid)
                    es.append(
                        (
                            pred,
                            nid,
                            dict(
                                paths=set(i),
                                ofrom=G.edge(pred, node)["ofrom"],
                                oto=G.edge(pred, node)["oto"],
                            ),
                        )
                    )
                    es.append(
                        (
                            nid,
                            suc,
                            dict(
                                paths=set(i),
                                ofrom=G.edge(node, suc)["ofrom"],
                                oto=G.edge(node, suc)["oto"],
                            ),
                        )
                    )
                    G.graph["noffset"] += 1
    elif predecessors:
        for pred in predecessors:
            i = G.edge(pred, node)["paths"]
            nid = G.graph["noffset"]
            G.add_node(
                nid,
                offsets={k: offsets[k] for k in offsets if k in i},
                seq=seq,
                prefix="",
                suffix="",
            )
            duplicates.append(nid)
            es.append(
                (
                    pred,
                    nid,
                    dict(
                        paths=set(i),
                        ofrom=G.edge(pred, node)["ofrom"],
                        oto=G.edge(pred, node)["oto"],
                    ),
                )
            )
            G.graph["noffset"] += 1
    elif successors:
        for suc in successors:
            i = G.edge(node, suc)["paths"]
            nid = G.graph["noffset"]
            G.add_node(
                nid,
                offsets={k: offsets[k] for k in offsets if k in i},
                seq=seq,
                prefix="",
                suffix="",
            )
            duplicates.append(nid)
            es.append(
                (
                    nid,
                    suc,
                    dict(
                        paths=set(i),
                        ofrom=G.edge(node, suc)["ofrom"],
                        oto=G.edge(node, suc)["oto"],
                    ),
                )
            )
            G.graph["noffset"] += 1

    G.remove_node(node)
    for u, v, d in es:
        G.add_edge(u, v, **d)
    return duplicates


def checkedges(G: PanGraph, k: int = 100):
    """chop.py:118-180: assign overlap direction per edge; return the edges
    that cannot be resolved yet."""
    for _, _, d in G.edges(data=True):
        d["overlap"] = None
    update = True
    while update:
        update = False
        remove = []
        for u, v, d in list(G.edges(data=True)):
            if d["overlap"] is not None:
                continue
            if isinstance(u, str):
                d["overlap"] = u
                continue
            if isinstance(v, str):
                d["overlap"] = v
                continue
            if (
                len(G.nodes[u]["seq"]) >= k - 1
                and len(list(G.in_edges(v))) == 1
            ):
                d["overlap"] = u
                update = True
                continue
            if (
                len(G.nodes[v]["seq"]) >= k - 1
                and len(list(G.out_edges(u))) == 1
            ):
                d["overlap"] = v
                update = True
                continue
            if (
                len(G.nodes[v]["seq"]) >= k - 1
                and len(G.nodes[u]["seq"]) >= k - 1
            ):
                nid = G.graph["noffset"]
                G.add_node(
                    nid,
                    seq="",
                    offsets=dict(G.nodes[v]["offsets"]),
                    prefix="",
                    suffix="",
                )
                G.graph["noffset"] += 1
                ed = dict(d)
                G.add_edge(u, nid, **dict(ed, overlap=u, paths=set(d["paths"])))
                G.add_edge(nid, v, **dict(ed, overlap=v, paths=set(d["paths"])))
                remove.append((u, v))
                update = True
        for u, v in remove:
            G.remove_edge(u, v)

    return [(u, v) for u, v, d in G.edges(data=True) if d["overlap"] is None]


def chop(G: PanGraph, k: int = 100, extend: bool = True) -> PanGraph:
    """chop.py:182-313."""
    for node in G.nodes:
        if not isinstance(node, str):
            G.nodes[node]["prefix"] = ""
            G.nodes[node]["suffix"] = ""

    es = checkedges(G, k=k)
    iteration = 1
    while es:
        log.debug("chop iteration %d (%d unresolved edges)", iteration, len(es))
        sg = PanGraph()
        for u, v in es:
            sg.add_edge(u, v)
        nodes = [
            n
            for n in sg.nodes
            if (
                len(list(sg.in_edges(n))) > 1
                or len(list(sg.out_edges(n))) > 1
            )
            and not isinstance(n, str)
        ]
        nodes.sort(key=lambda n: len(G.nodes[n]["seq"]))
        d = set()
        dups = []
        for n in nodes:
            dup = True
            for n1, _ in sg.in_edges(n):
                if n1 in d:
                    dup = False
                d.add(n1)
            for _, n2 in sg.out_edges(n):
                if n2 in d:
                    dup = False
                d.add(n2)
            if dup:
                dups.append(n)
        for n in dups:
            duplicate_node(G, n)

        topsort = [
            v for v in G.topological_sort() if not isinstance(v, str)
        ]
        contract(G, topsort)
        es = checkedges(G, k=k)
        iteration += 1
        if iteration > 10000:
            log.fatal("chop did not converge")
            sys.exit(1)

    if extend:
        for u, v, d in G.edges(data=True):
            if isinstance(u, str) or isinstance(v, str):
                continue
            assert d["overlap"] is not None
            if d["overlap"] == u:
                assert G.nodes[v]["prefix"] == ""
                G.nodes[v]["prefix"] = G.nodes[u]["seq"][-(k - 1) :]
            else:
                assert d["overlap"] == v
                assert G.nodes[u]["suffix"] == ""
                G.nodes[u]["suffix"] = G.nodes[v]["seq"][: k - 1]
            d["cigar"] = "%dM" % (k - 1)
    return G


def chop_check(Gorg: PanGraph, G: PanGraph, k: int) -> bool:
    """chop --check (chop.py:63-74): every k-substring of every haplotype
    must appear in the flat node representation."""
    from .extract import extract

    r = "$".join(
        G.nodes[n]["seq"] for n in G.nodes if not isinstance(n, str)
    )
    for path in Gorg.graph["paths"]:
        s = extract(Gorg, path)
        for i in range(len(s) - k):
            if r.find(s[i : i + k]) == -1:
                log.error(
                    "missing %d-mer for %s: %s", k, path, s[i : i + k]
                )
                return False
    return True
