"""GFA 1.0 reading/writing over PanGraph.

Format behavior mirrors the reference's read_gfa/write_gfa
(reveal/utils.py:377-839): S/L/P records, per-path offsets
reconstructed by walking P lines, per-component merged start/end marker
nodes, path walk from startnodes for the writer.
"""

from __future__ import annotations

import gzip
import logging
import uuid
from typing import Optional

import numpy as np

from .encoding import to_str
from .gzwrite import GzipTextWriter
from ..graph.pangraph import PanGraph

log = logging.getLogger(__name__)


def _open(fn: str, mode: str = "rt"):
    if fn.endswith(".gz"):
        if mode == "wt":  # level 9, deflated on the host's cores
            return GzipTextWriter(fn)
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


def read_gfa(
    gfafile: str,
    graph: Optional[PanGraph] = None,
    remap: bool = False,
) -> PanGraph:
    """Parse a GFA into a PanGraph with int node ids + 'seq' attrs, per-path
    offsets, and per-component merged start/end marker nodes
    (utils.read_gfa with index=None, utils.py:377-659)."""
    G = graph if graph is not None else PanGraph()

    nmapping = {}
    edges = []
    paths = []
    gnodeid = G.number_of_nodes() + 1

    with _open(gfafile) as f:
        for line in f:
            if line.startswith("S"):
                s = line.strip().split("\t")
                nodeid = int(s[1])
                seq = s[2] if len(s) > 2 else ""
                if remap:
                    nmapping[nodeid] = gnodeid
                    gnodeid += 1
                else:
                    nmapping[nodeid] = nodeid
                G.add_node(
                    nmapping[nodeid], seq=seq.upper(), aligned=0, offsets={}
                )
            elif line.startswith("L"):
                edges.append(line)
            elif line.startswith("P"):
                paths.append(line)

    multi = getattr(G, "multi", False)
    for line in edges:
        e = line.strip().split("\t")
        if not multi and (e[2] != "+" or e[4] != "+"):
            # DiGraph flavor drops inversion edges (utils.py:460-461); the
            # MultiPanGraph flavor keeps them (utils.py:455-471)
            continue
        tags = {"ofrom": e[2], "oto": e[4]}
        if len(e) > 5:
            tags["cigar"] = e[5]
        tags["paths"] = set()
        G.add_edge(nmapping[int(e[1])], nmapping[int(e[3])], **tags)

    if not paths:
        raise ValueError("No paths defined in GFA: %s" % gfafile)

    G.graph["noffset"] = max(nmapping.values()) + 1 if nmapping else 1

    startnodes = set()
    endnodes = set()

    for line in paths:
        cols = line.rstrip().split("\t")
        sample = cols[1]
        if sample.startswith("*") and not multi:
            # DiGraph flavor excludes original-layout paths, which may
            # traverse inversion edges (utils.py:496-499)
            log.debug("DiGraph input: excluding path %s", sample)
            continue
        if sample in G.graph["paths"]:
            raise ValueError("Graph already contains path %r" % sample)
        G.graph["paths"].append(sample)
        sid = len(G.graph["path2id"])
        G.graph["path2id"][sample] = sid
        G.graph["id2path"][sid] = sample

        o = 0
        path = []
        if len(cols) >= 3 and cols[2]:
            path = [(nid[:-1], nid[-1:]) for nid in cols[2].split(",")]
            pnode = None
            porient = None
            for pi, (nid, orientation) in enumerate(path):
                node = nmapping[int(nid)]
                G.nodes[node]["offsets"][sid] = o
                o += len(G.nodes[node]["seq"])
                if pi > 0:
                    if not G.has_edge(pnode, node):
                        raise ValueError(
                            "Path %r has %s -> %s but no such edge"
                            % (sample, pnode, node)
                        )
                    if multi:
                        # match the parallel edge by step orientations
                        # (utils.py:549-557)
                        for k in G.edge_keys(pnode, node):
                            d = G.edge(pnode, node, k)
                            if (
                                d["oto"] == orientation
                                and d["ofrom"] == porient
                            ):
                                d["paths"].add(sid)
                                break
                        else:
                            raise ValueError(
                                "Edge missing for path %r between %s (%s) "
                                "and %s (%s)"
                                % (sample, pnode, porient, node, orientation)
                            )
                    else:
                        G.edge(pnode, node)["paths"].add(sid)
                pnode = node
                porient = orientation

        start = uuid.uuid4().hex
        G.add_node(start, offsets={sid: 0}, endpoint=True)
        if path:
            G.add_edge(
                start,
                nmapping[int(path[0][0])],
                paths={sid},
                ofrom="+",
                oto=path[0][1],
            )
        startnodes.add(start)

        end = uuid.uuid4().hex
        G.add_node(end, offsets={sid: o}, endpoint=True)
        if path:
            G.add_edge(
                nmapping[int(path[-1][0])],
                end,
                paths={sid},
                ofrom=path[-1][1],
                oto="+",
            )
        endnodes.add(end)
        G.graph["id2end"][sid] = o

    # drop untraversed edges/nodes (utils.py:579-598)
    remove_e = [
        (u, v) for u, v, d in G.edges(data=True) if d["paths"] == set()
    ]
    for u, v in remove_e:
        G.remove_edge(u, v)
    remove_n = [
        n for n in G.nodes if G.nodes[n].get("offsets") == {}
    ]
    for n in remove_n:
        G.remove_node(n)

    # merge start/end markers per weakly connected component
    # (utils.py:600-659)
    for comp in G.weakly_connected_components():
        startmerge = [n for n in comp if n in startnodes]
        endmerge = [n for n in comp if n in endnodes]

        if endmerge:
            endnode = uuid.uuid4().hex
            G.add_node(endnode, offsets={}, seq="", endpoint=True)
            G.graph["endnodes"].append(endnode)
            for node in endmerge:
                for k, v in G.nodes[node]["offsets"].items():
                    G.nodes[endnode]["offsets"][k] = v
                for pnode, _, d in list(G.in_edges(node, data=True)):
                    if multi or not G.has_edge(pnode, endnode):
                        # multi: per-path markers carry exactly one edge,
                        # and the reference re-adds it as a parallel edge
                        # (utils.py:628-629)
                        G.add_edge(
                            pnode,
                            endnode,
                            paths=set(d["paths"]),
                            ofrom=d["ofrom"],
                            oto=d["oto"],
                        )
                    else:
                        G.edge(pnode, endnode)["paths"] |= d["paths"]

        if startmerge:
            startnode = uuid.uuid4().hex
            G.add_node(startnode, offsets={}, seq="", endpoint=True)
            G.graph["startnodes"].append(startnode)
            for node in startmerge:
                for k, v in G.nodes[node]["offsets"].items():
                    G.nodes[startnode]["offsets"][k] = v
                for nnode, _, d in [
                    (v, u, d) for u, v, d in list(G.out_edges(node, data=True))
                ]:
                    if multi or not G.has_edge(startnode, nnode):
                        G.add_edge(
                            startnode,
                            nnode,
                            paths=set(d["paths"]),
                            ofrom=d["ofrom"],
                            oto=d["oto"],
                        )
                    else:
                        G.edge(startnode, nnode)["paths"] |= d["paths"]

        for n in startmerge + endmerge:
            G.remove_node(n)

    return G


def read_gfa_into(gfafile, ts, t, G, root_nodes):
    """Graph input for alignment: every S-line sequence is appended to the
    text store (each node gets its own sentinel), nodes become
    (start, end) interval nodes, per-path offsets come from walking the
    P lines (utils.read_gfa with an index, utils.py:377-659).

    The caller must have registered the sample (ts.add_sample) already,
    mirroring align_genomes (rem.py:536-547).
    """
    nmapping = {}
    edges = []
    paths = []

    with _open(gfafile) as f:
        for line in f:
            if line.startswith("S"):
                s = line.strip().split("\t")
                nodeid = int(s[1])
                seq = s[2] if len(s) > 2 else ""
                iv = ts.add_sequence(seq.upper())
                t.add(iv)
                G.add_node(iv, aligned=0, offsets={})
                root_nodes.add(iv)
                nmapping[nodeid] = iv
            elif line.startswith("L"):
                edges.append(line)
            elif line.startswith("P"):
                paths.append(line)

    multi = getattr(G, "multi", False)
    for line in edges:
        e = line.strip().split("\t")
        if not multi and (e[2] != "+" or e[4] != "+"):
            continue  # DiGraph flavor drops inversion edges
        tags = {"ofrom": e[2], "oto": e[4]}
        if len(e) > 5:
            tags["cigar"] = e[5]
        tags["paths"] = set()
        G.add_edge(nmapping[int(e[1])], nmapping[int(e[3])], **tags)

    if not paths:
        raise ValueError("No paths defined in GFA: %s" % gfafile)

    startnodes = set()
    endnodes = set()

    for line in paths:
        cols = line.rstrip().split("\t")
        sample = cols[1]
        if sample.startswith("*") and not multi:
            # original-layout paths may traverse inversion edges that the
            # DiGraph alignment mode drops (utils.py:496-499)
            log.debug("DiGraph alignment input: excluding path %s", sample)
            continue
        if sample in G.graph["paths"]:
            raise ValueError("Graph already contains path %r" % sample)
        G.graph["paths"].append(sample)
        sid = len(G.graph["path2id"])
        G.graph["path2id"][sample] = sid
        G.graph["id2path"][sid] = sample

        o = 0
        path = []
        if len(cols) >= 3 and cols[2]:
            path = [(nid[:-1], nid[-1:]) for nid in cols[2].split(",")]
            pnode = None
            porient = None
            for pi, (nid, orientation) in enumerate(path):
                node = nmapping[int(nid)]
                G.nodes[node]["offsets"][sid] = o
                o += node[1] - node[0]
                if pi > 0:
                    if not G.has_edge(pnode, node):
                        raise ValueError(
                            "Path %r has %s -> %s but no such edge"
                            % (sample, pnode, node)
                        )
                    if multi:
                        for k in G.edge_keys(pnode, node):
                            d = G.edge(pnode, node, k)
                            if (
                                d["oto"] == orientation
                                and d["ofrom"] == porient
                            ):
                                d["paths"].add(sid)
                                break
                        else:
                            raise ValueError(
                                "Edge missing for path %r between %s (%s) "
                                "and %s (%s)"
                                % (sample, pnode, porient, node, orientation)
                            )
                    else:
                        G.edge(pnode, node)["paths"].add(sid)
                pnode = node
                porient = orientation

        start = uuid.uuid4().hex
        G.add_node(start, offsets={sid: 0}, endpoint=True)
        if path:
            G.add_edge(
                start,
                nmapping[int(path[0][0])],
                paths={sid},
                ofrom="+",
                oto=path[0][1],
            )
        startnodes.add(start)

        end = uuid.uuid4().hex
        G.add_node(end, offsets={sid: o}, endpoint=True)
        if path:
            G.add_edge(
                nmapping[int(path[-1][0])],
                end,
                paths={sid},
                ofrom=path[-1][1],
                oto="+",
            )
        endnodes.add(end)
        G.graph["id2end"][sid] = o

    # drop untraversed edges/nodes
    for u, v in [
        (u, v) for u, v, d in G.edges(data=True) if d["paths"] == set()
    ]:
        G.remove_edge(u, v)
    for n in [
        n
        for n in list(G.nodes)
        if G.nodes[n].get("offsets") == {} and not isinstance(n, str)
    ]:
        if isinstance(n, tuple):
            t.remove(n)
            root_nodes.discard(n)
        G.remove_node(n)

    # merge start/end markers per weakly connected component
    for comp in G.weakly_connected_components():
        startmerge = [n for n in comp if n in startnodes]
        endmerge = [n for n in comp if n in endnodes]
        if endmerge:
            endnode = uuid.uuid4().hex
            G.add_node(endnode, offsets={}, endpoint=True)
            G.graph["endnodes"].append(endnode)
            for node in endmerge:
                for k, v in G.nodes[node]["offsets"].items():
                    G.nodes[endnode]["offsets"][k] = v
                for pnode, _, d in list(G.in_edges(node, data=True)):
                    if multi or not G.has_edge(pnode, endnode):
                        G.add_edge(
                            pnode,
                            endnode,
                            paths=set(d["paths"]),
                            ofrom=d["ofrom"],
                            oto=d["oto"],
                        )
                    else:
                        G.edge(pnode, endnode)["paths"] |= d["paths"]
        if startmerge:
            startnode = uuid.uuid4().hex
            G.add_node(startnode, offsets={}, endpoint=True)
            G.graph["startnodes"].append(startnode)
            for node in startmerge:
                for k, v in G.nodes[node]["offsets"].items():
                    G.nodes[startnode]["offsets"][k] = v
                for _, nnode, d in list(G.out_edges(node, data=True)):
                    if multi or not G.has_edge(startnode, nnode):
                        G.add_edge(
                            startnode,
                            nnode,
                            paths=set(d["paths"]),
                            ofrom=d["ofrom"],
                            oto=d["oto"],
                        )
                    else:
                        G.edge(startnode, nnode)["paths"] |= d["paths"]
        for n in startmerge + endmerge:
            G.remove_node(n)
