"""Unzip: make indel-placement uncertainty explicit.

Port of reveal/unzip.py: for every bubble compute the
wiggle (how far the bubble can shift left/right given flanking sequence
equality, bubbles.getwiggle) plus a minimum, then peel that many bases off
the source's suffix / sink's prefix into the branches, splitting shared
successors/predecessors with fresh nodes.
"""

from __future__ import annotations

import logging
from typing import Optional

from .bubbles import Bubble, bubbles
from .pangraph import PanGraph

log = logging.getLogger(__name__)


def unzip_graph(
    G: PanGraph,
    minunzip: int = 0,
    mindiff: int = 0,
    maxdiff: Optional[int] = None,
):
    nid = max((n for n in G.nodes if isinstance(n, int)), default=0) + 1
    for b in bubbles(G):
        if b.maxsize - b.minsize < mindiff:
            continue
        if maxdiff and b.maxsize - b.minsize > maxdiff:
            continue
        nid = unzip_bubble(G, b, minunzip=minunzip, idoffset=nid)
    return G


def unzip_bubble(G: PanGraph, b: Bubble, minunzip: int = 0, idoffset: int = 0):
    wiggle = b.getwiggle(minwiggle=minunzip)
    if isinstance(b.sink, str):
        wiggle = (wiggle[0], 0)
    if isinstance(b.source, str):
        wiggle = (0, wiggle[1])
    if wiggle == (0, 0):
        return idoffset

    srcl = len(G.nodes[b.source]["seq"])
    snkl = len(G.nodes[b.sink]["seq"])
    maxlw = int(round((srcl - 2 if srcl > 2 else 0) / 2.0))
    maxrw = int(round((snkl - 2 if snkl > 2 else 0) / 2.0))
    wiggle = (min(wiggle[0], maxlw), min(wiggle[1], maxrw))

    if wiggle[0] > 0:
        ls = G.nodes[b.source]["seq"][-wiggle[0] :]
        assert G.nodes[b.source]["seq"][: -wiggle[0]] != ""
        G.nodes[b.source]["seq"] = G.nodes[b.source]["seq"][: -wiggle[0]]
    else:
        ls = ""

    if wiggle[1] > 0:
        rs = G.nodes[b.sink]["seq"][: wiggle[1]]
        assert G.nodes[b.sink]["seq"][wiggle[1] :] != ""
        G.nodes[b.sink]["seq"] = G.nodes[b.sink]["seq"][wiggle[1] :]
        G.nodes[b.sink]["offsets"] = {
            k: G.nodes[b.sink]["offsets"][k] + len(rs)
            for k in G.nodes[b.sink]["offsets"]
        }
    else:
        rs = ""

    successors = list(G.successors(b.source))
    predecessors = list(G.predecessors(b.sink))

    if ls != "":
        for n in successors:
            if len(list(G.predecessors(n))) > 1:
                G.add_node(
                    idoffset,
                    seq=ls if n != b.sink else ls + rs,
                    offsets={
                        p: (G.nodes[b.source]["offsets"][p] + srcl) - len(ls)
                        for p in G.edge(b.source, n)["paths"]
                    },
                )
                props = dict(G.edge(b.source, n))
                G.remove_edge(b.source, n)
                G.add_edge(b.source, idoffset, **props)
                G.add_edge(idoffset, n, **props)
                idoffset += 1
            else:
                G.nodes[n]["seq"] = ls + G.nodes[n]["seq"]
                G.nodes[n]["offsets"] = {
                    k: G.nodes[n]["offsets"][k] - len(ls)
                    for k in G.nodes[n]["offsets"]
                }

    if rs != "":
        for n in predecessors:
            if n == b.source and ls != "":
                continue  # already handled via successors
            if len(list(G.successors(n))) > 1:
                G.add_node(
                    idoffset,
                    seq=rs if n != b.source else ls + rs,
                    offsets={
                        p: (G.nodes[b.sink]["offsets"][p]) - len(rs)
                        for p in G.edge(n, b.sink)["paths"]
                    },
                )
                props = dict(G.edge(n, b.sink))
                G.remove_edge(n, b.sink)
                G.add_edge(n, idoffset, **props)
                G.add_edge(idoffset, b.sink, **props)
                idoffset += 1
            else:
                G.nodes[n]["seq"] = G.nodes[n]["seq"] + rs

    return idoffset
