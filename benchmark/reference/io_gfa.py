"""GFA 1.0 reading/writing over PanGraph.

Format behavior mirrors the reference's read_gfa/write_gfa
(reveal/utils.py:377-839): S/L/P records, per-path offsets
reconstructed by walking P lines, per-component merged start/end marker
nodes, path walk from startnodes for the writer.
"""

from __future__ import annotations

import gzip
import logging
from typing import Optional

import numpy as np

from .encoding import to_str
from .pangraph import PanGraph

log = logging.getLogger(__name__)


def _open(fn: str, mode: str = "rt"):
    if fn.endswith(".gz"):
        return gzip.open(fn, mode)
    return open(fn, mode)


def seq2node(G: PanGraph, T: np.ndarray, toupper: bool = True):
    """Materialize 'seq' on interval nodes (utils.seq2node, utils.py:1036)."""
    for node in G.nodes:
        if isinstance(node, tuple):
            d = G.nodes[node]
            s = to_str(T[node[0] : node[1]])
            if toupper and d.get("aligned", 0) > 0:
                s = s.upper()
            d["seq"] = s


def write_gfa(
    G: PanGraph,
    T: Optional[np.ndarray],
    outputfile: str = "reference.gfa",
    toupper: bool = False,
    remap: bool = True,
    argv_comment: str = "reveal_tpu",
) -> str:
    """Port of utils.write_gfa (utils.py:710-839), DiGraph flavor: nodes in
    topological order, S/L records, P per registered path walked from the
    startnodes."""
    if not outputfile.endswith(".gfa") and not outputfile.endswith(".gfa.gz"):
        outputfile += ".gfa.gz"

    f = _open(outputfile, "wt")
    f.write("H\tVN:Z:1.0\tCL:Z:%s\n" % argv_comment)

    if getattr(G, "multi", False):
        # multi graphs can carry inversion cycles; the reference writes
        # them in plain node order (utils.py:731-733) — insertion order
        # here, which is deterministic
        order = [n for n in G.nodes if not isinstance(n, str)]
    else:
        order = [n for n in G.topological_sort() if not isinstance(n, str)]
    if remap:
        mapping = {node: i + 1 for i, node in enumerate(order)}
    else:
        mapping = {node: node for node in order}

    def node_seq(node):
        d = G.nodes[node]
        if "seq" in d:
            return d["seq"]
        if isinstance(node, tuple) and T is not None:
            return to_str(T[node[0] : node[1]])
        return ""

    for node in order:
        s = node_seq(node)
        if toupper:
            s = s.upper()
        f.write("S\t%s\t%s\n" % (mapping[node], s))
        for _, to, d in G.out_edges(node, data=True):
            if isinstance(to, str):
                continue
            f.write(
                "L\t%s\t%s\t%s\t%s\t%s\n"
                % (
                    mapping[node],
                    d.get("ofrom", "+"),
                    mapping[to],
                    d.get("oto", "+"),
                    d.get("cigar", "0M"),
                )
            )

    startnodes = G.graph.get("startnodes", [])
    endnodes = set(G.graph.get("endnodes", []))
    for sample, sid in G.graph["path2id"].items():
        path = []
        cigarpath = []
        for node in startnodes:
            if node not in G.nodes:
                continue
            if sid not in G.nodes[node]["offsets"]:
                continue
            if not isinstance(node, str):
                path.append("%s+" % mapping[node])
                cigarpath.append("0M")
            cur = node
            while True:
                oute = [
                    (v, d)
                    for _, v, d in G.out_edges(cur, data=True)
                    if sid in d["paths"]
                ]
                if len(oute) == 0:
                    log.warning(
                        "Path %r (sid=%s) doesn't reach end node; stops at %s",
                        sample,
                        sid,
                        cur,
                    )
                    break
                if len(oute) > 1:
                    log.error(
                        "Ambiguity in path for %r at node %s", sample, cur
                    )
                    break
                v, d = oute[0]
                if v in endnodes:
                    break
                if isinstance(v, str):
                    cur = v
                    continue
                path.append("%s%s" % (mapping[v], d.get("oto", "+")))
                if not isinstance(cur, str):
                    cigarpath.append(d.get("cigar", "0M"))
                cur = v
            break
        f.write(
            "P\t%s\t%s\t%s\n" % (sample, ",".join(path), ",".join(cigarpath))
        )
    f.close()
    return outputfile
