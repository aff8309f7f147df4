"""The plain reference of ``rem``: REVEAL's serial LIFO recursion in NumPy.

A frozen copy of the port's host engine at its NumPy build (the suffix
array by prefix doubling, ``_align_loop``'s LIFO worklist, the picker,
graph surgery and the GFA writer; ``reveal_tpu_torch/align/rem.py`` at
commit 8d1d94b), with every native and device branch taken out.  It
imports nothing of the program: every module it uses sits in this folder.

``rem_gfa(fastas, out)`` aligns the fastas as ``rem -o <prefix>`` does at
the CLI's defaults and returns the GFA's bytes.
"""

from __future__ import annotations

import gzip
import os
import uuid
from typing import List

from .esa_index import ESAIndex
from .graphops import (
    IntervalIndex,
    breaknode,
    mergenodes,
    prune_nodes,
    segmentgraph,
)
from .io_fasta import fasta_reader
from .io_gfa import seq2node, write_gfa
from .pangraph import PanGraph
from .picker import MumPicker, PickerConfig
from .textstore import TextStore


def graphalign(G: PanGraph, t: IntervalIndex, idx: ESAIndex, mum):
    """Port of rem.graphalign (rem.py:318-377)."""
    l, n, spd = mum
    nodes = idx.nodes
    mns = []
    sp = [p for gid, p in spd]
    matching = set()
    for pos in sp:
        matching.add((pos, pos + l))
        old = t.lookup(pos)
        assert old[1] - old[0] >= l
        mn, other = breaknode(G, t, old, pos, l)
        mns.append(mn)
        nodes.discard(old)
        for node in other:
            nodes.add(node)

    mn = mergenodes(G, mns)
    msamples = set(G.nodes[mn]["offsets"].keys())

    leading, trailing, rest = segmentgraph(G, mn, nodes)

    newleftnode = mn
    newrightnode = mn
    for intv in leading:
        if not set(G.nodes[intv]["offsets"].keys()) <= msamples:
            newrightnode = idx.right_node
            break
    for intv in trailing:
        if not set(G.nodes[intv]["offsets"].keys()) <= msamples:
            newleftnode = idx.left_node
            break

    return leading, trailing, matching, rest, mn, newleftnode, newrightnode


def enum_pick(picker: MumPicker, idx: ESAIndex, cfg: PickerConfig):
    """Enumerate + pick for one segment (reveal.c:809-837 enumeration +
    the mumpicker callback)."""
    if len(idx.skipmums) == 0:
        if idx.main.nsamples > 2:
            mums = idx.getmultimums(minlength=cfg.minlength, minn=cfg.minn)
        else:
            mums = idx.getmums_rem(cfg.minlength)
        return picker(mums, idx, precomputed=False, minlength=cfg.minlength)
    return picker(idx.skipmums, idx, precomputed=True,
                  minlength=cfg.minlength)


def align_loop(G: PanGraph, t: IntervalIndex, root: ESAIndex,
               cfg: PickerConfig) -> int:
    """LIFO worklist replicating aligner()'s threads=0 order; returns the
    number of anchor steps."""
    picker = MumPicker(G, t, cfg)
    queue = [root]
    steps = 0
    while queue:
        idx = queue.pop()  # LIFO (reveal.c:21-27)
        pick = enum_pick(picker, idx, cfg)
        if not pick:
            continue
        splitmum, skipleft, skipright = pick

        l, n, spd = splitmum
        result = graphalign(G, t, idx, splitmum)
        leading, trailing, matching, rest, merged, newleft, newright = result

        sp_positions = [p for gid, p in spd]
        lead_idx, trail_idx, par_idx = idx.split_segments(
            leading,
            trailing,
            matching,
            rest,
            sp_positions,
            l,
            newleft,
            newright,
            skipleft=skipleft,
            skipright=skipright,
        )
        steps += 1
        # push order parallel, leading, trailing (reveal.c:1295-1324)
        if par_idx is not None:
            queue.append(par_idx)
        if lead_idx is not None:
            queue.append(lead_idx)
        if trail_idx is not None:
            queue.append(trail_idx)
    return steps


def read_fasta_into(fasta: str, ts: TextStore, t: IntervalIndex,
                    G: PanGraph, root_nodes: set):
    """Port of utils.read_fasta (utils.py:304-375): one sample a file,
    per-sequence start/end endpoint markers, per-path registry entries."""
    ts.add_sample(os.path.basename(fasta))
    for name, seq in fasta_reader(fasta, toupper=True):
        name = name.replace(":", "").replace(";", "")
        if name in G.graph["paths"]:
            raise ValueError("duplicate sequence name in graph: %r" % name)
        sid = len(G.graph["paths"])
        G.graph["paths"].append(name)
        G.graph["path2id"][name] = sid
        G.graph["id2path"][sid] = name
        G.graph["id2end"][sid] = len(seq)

        iv = ts.add_sequence(seq)
        t.add(iv)
        startnode = uuid.uuid4().hex
        endnode = uuid.uuid4().hex
        G.add_node(startnode, offsets={sid: 0}, endpoint=True)
        G.graph["startnodes"].append(startnode)
        G.add_node(iv, offsets={sid: 0}, aligned=0)
        G.add_node(endnode, offsets={sid: len(seq)}, endpoint=True)
        G.graph["endnodes"].append(endnode)
        G.add_edge(startnode, iv, paths={sid}, ofrom="+", oto="+")
        G.add_edge(iv, endnode, paths={sid}, ofrom="+", oto="+")
        root_nodes.add(iv)


def align_genomes(fastas: List[str], **cfgkw):
    """Alignment of two or more fasta files -> (G, idx)."""
    ts = TextStore()
    t = IntervalIndex()
    G = PanGraph()
    root_nodes = set()
    for fasta in fastas:
        read_fasta_into(fasta, ts, t, G, root_nodes)
    if ts.nsamples <= 1:
        raise ValueError("Specify at least 2 targets to construct an "
                         "alignment.")
    idx = ESAIndex.construct(ts)
    idx.nodes = root_nodes
    align_loop(G, t, idx, PickerConfig(**cfgkw))
    return G, idx


def rem_gfa(fastas: List[str], out: str, **cfgkw) -> bytes:
    """The GFA that ``rem -o <prefix> <fastas>`` writes, as text bytes:
    pruned when it has more than two paths, node sequences attached, the
    writer's default header.  ``out`` is where it is written (``.gfa.gz``
    is gzipped, as the CLI does)."""
    G, idx = align_genomes(fastas, **cfgkw)
    T = idx.main.T
    if len(G.graph["paths"]) > 2:
        prune_nodes(G, T=T)
    seq2node(G, T)
    out = write_gfa(G, T, outputfile=out)
    opener = gzip.open if out.endswith(".gz") else open
    with opener(out, "rb") as fh:
        return fh.read()
