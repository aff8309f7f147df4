"""Graph simplification: unary-chain contraction.

Semantic port of utils.contract/contract_nodes
(reveal/utils.py:23-59): maximal stretches of nodes
connected by unique in/out edges are merged into their first node,
concatenating sequences.  Unlike the reference (which only merges pairs
that happen to be adjacent in the supplied topological order), chains are
followed explicitly, which is order-independent and contracts every
stretch in one pass.
"""

from __future__ import annotations

from typing import List

from .pangraph import PanGraph


def contract(G: PanGraph, topsort: List) -> List:
    consumed = set()
    newtopsort = []
    for node in topsort:
        if node in consumed or node not in G.nodes:
            continue
        stretch = [node]
        cur = node
        while True:
            sucs = list(G.successors(cur))
            if len(sucs) != 1:
                break
            nxt = sucs[0]
            if isinstance(nxt, str) or nxt in consumed:
                break
            if len(list(G.predecessors(nxt))) != 1:
                break
            stretch.append(nxt)
            consumed.add(nxt)
            cur = nxt
        if len(stretch) > 1:
            contract_nodes(G, stretch)
        newtopsort.append(node)
    return newtopsort


def contract_nodes(G: PanGraph, nodes: List) -> None:
    G.nodes[nodes[0]]["seq"] = "".join(
        G.nodes[n].get("seq", "") for n in nodes
    )
    for _, n2, data in list(G.out_edges(nodes[-1], data=True)):
        G.add_edge(nodes[0], n2, **data)
    for n in nodes[1:]:
        G.remove_node(n)
