"""Variation-graph model.

The reference keeps its graph in networkx (Multi)DiGraphs with
intervaltree.Interval nodes (reveal/utils.py:304-375).  Here
the graph is a small deterministic adjacency structure purpose-built for the
aligner:

* node keys: ``(begin, end)`` text-interval tuples during alignment, ints
  for GFA-loaded graphs, strs for per-path endpoint markers;
* node attrs: ``offsets`` {path_id: start offset}, ``aligned`` flag,
  optional ``seq``;
* edge attrs: ``paths`` set of path ids, ``ofrom``/``oto`` orientations,
  optional ``cigar``;
* graph attrs: ``paths``, ``path2id``, ``id2path``, ``id2end``,
  ``startnodes``, ``endnodes``.

Iteration order is insertion order everywhere, which makes downstream
output (GFA node numbering, bubble enumeration) deterministic without the
reference's reliance on hash-set ordering.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterator, List


class PanGraph:
    multi = False

    def __init__(self):
        self.nodes: Dict[Hashable, dict] = {}
        self.succ: Dict[Hashable, Dict[Hashable, dict]] = {}
        self.pred: Dict[Hashable, Dict[Hashable, dict]] = {}
        self.graph: dict = {
            "paths": [],
            "path2id": {},
            "id2path": {},
            "id2end": {},
            "startnodes": [],
            "endnodes": [],
        }

    # -- nodes -------------------------------------------------------------
    def add_node(self, key, **attrs):
        if key in self.nodes:
            self.nodes[key].update(attrs)
        else:
            self.nodes[key] = dict(attrs)
            self.succ[key] = {}
            self.pred[key] = {}

    def remove_node(self, key):
        for to in list(self.succ[key]):
            del self.pred[to][key]
        for fr in list(self.pred[key]):
            del self.succ[fr][key]
        del self.succ[key]
        del self.pred[key]
        del self.nodes[key]

    def has_node(self, key) -> bool:
        return key in self.nodes

    def __contains__(self, key) -> bool:
        return key in self.nodes

    def node(self, key) -> dict:
        return self.nodes[key]

    def number_of_nodes(self) -> int:
        return len(self.nodes)

    # -- edges -------------------------------------------------------------
    def add_edge(self, u, v, **attrs):
        if u not in self.nodes:
            self.add_node(u)
        if v not in self.nodes:
            self.add_node(v)
        if v in self.succ[u]:
            self.succ[u][v].update(attrs)
        else:
            d = dict(attrs)
            self.succ[u][v] = d
            self.pred[v][u] = d

    def remove_edge(self, u, v):
        del self.succ[u][v]
        del self.pred[v][u]

    def has_edge(self, u, v) -> bool:
        return u in self.succ and v in self.succ[u]

    def edge(self, u, v) -> dict:
        return self.succ[u][v]

    def edges(self, data: bool = False):
        for u, tos in self.succ.items():
            for v, d in tos.items():
                yield (u, v, d) if data else (u, v)

    def in_edges(self, v, data: bool = False):
        for u, d in self.pred[v].items():
            yield (u, v, d) if data else (u, v)

    def out_edges(self, u, data: bool = False):
        for v, d in self.succ[u].items():
            yield (u, v, d) if data else (u, v)

    def successors(self, u) -> Iterator:
        return iter(self.succ[u])

    def predecessors(self, v) -> Iterator:
        return iter(self.pred[v])

    def number_of_edges(self) -> int:
        return sum(len(t) for t in self.succ.values())

    # -- algorithms --------------------------------------------------------
    def topological_sort(self) -> List[Hashable]:
        indeg = {n: len(self.pred[n]) for n in self.nodes}
        # deterministic Kahn: seed queue in insertion order
        queue = [n for n in self.nodes if indeg[n] == 0]
        out = []
        qi = 0
        while qi < len(queue):
            n = queue[qi]
            qi += 1
            out.append(n)
            for m in self.succ[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    queue.append(m)
        if len(out) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return out

    def is_dag(self) -> bool:
        try:
            self.topological_sort()
            return True
        except ValueError:
            return False

    def weakly_connected_components(self) -> List[List[Hashable]]:
        seen = set()
        comps = []
        for start in self.nodes:
            if start in seen:
                continue
            comp = []
            stack = [start]
            seen.add(start)
            while stack:
                n = stack.pop()
                comp.append(n)
                for m in self.succ[n]:
                    if m not in seen:
                        seen.add(m)
                        stack.append(m)
                for m in self.pred[n]:
                    if m not in seen:
                        seen.add(m)
                        stack.append(m)
            comps.append(comp)
        return comps

    def subgraph(self, keys) -> "PanGraph":
        keys = set(keys)
        H = PanGraph()
        H.graph = {
            k: (v.copy() if isinstance(v, (dict, list)) else v)
            for k, v in self.graph.items()
        }
        for n in self.nodes:
            if n in keys:
                H.add_node(n, **{k: v for k, v in self.nodes[n].items()})
        for u, v, d in self.edges(data=True):
            if u in keys and v in keys:
                H.add_edge(u, v, **d)
        return H

    def copy(self) -> "PanGraph":
        H = type(self)()
        H.graph = {
            k: (v.copy() if isinstance(v, (dict, list)) else v)
            for k, v in self.graph.items()
        }
        for n, d in self.nodes.items():
            H.add_node(
                n,
                **{
                    k: (v.copy() if isinstance(v, (dict, set)) else v)
                    for k, v in d.items()
                },
            )
        for u, v, d in self.edges(data=True):
            H.add_edge(
                u,
                v,
                **{
                    k: (v2.copy() if isinstance(v2, set) else v2)
                    for k, v2 in d.items()
                },
            )
        return H
