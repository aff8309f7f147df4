"""MAF -> variation graph conversion.

Port of convert.maf2graph (reveal/convert.py:80-229):
every ``a`` block becomes a column subgraph (shared builder with refine),
the unaligned stretches between blocks become per-sequence nodes pulled
from the source fastas (``<file>.fasta`` per the reference's ``file.name``
naming convention in the ``s`` lines).
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

from .io_fasta import fasta_reader
from ..graph.pangraph import PanGraph

log = logging.getLogger(__name__)


def maf2graph(maffile: str) -> PanGraph:
    files = set()
    blocks = []  # list of dict[(file,name)] -> seg info
    cur = None
    with open(maffile) as maf:
        for line in maf:
            if line.startswith("#"):
                continue
            if line.startswith("a"):
                cur = {}
                blocks.append(cur)
            elif line.startswith("s"):
                cols = line.rstrip().split()
                src = cols[1]
                if "." in src:
                    file, name = src.split(".", 1)
                    files.add(file)
                else:
                    file, name = None, src
                cur[(file, name)] = {
                    "start": int(cols[2]),
                    "end": int(cols[2]) + int(cols[3]),
                    "orientation": cols[4],
                    "aln": cols[6],
                }

    blocks = [b for b in blocks if len(b) > 1]

    db: Dict[Tuple, str] = {}
    for file in files:
        for name, seq in fasta_reader(file + ".fasta"):
            name = name.split()[0]
            key = (file, name)
            if key in db:
                raise ValueError("Non-unique contig name: %s" % name)
            db[key] = seq

    G = PanGraph()
    path2id = G.graph["path2id"]
    for b in blocks:
        for file, name in b:
            if name not in path2id:
                sid = len(path2id)
                path2id[name] = sid
                G.graph["id2path"][sid] = name
                G.graph["paths"].append(name)

    # per-block column subgraphs
    from ..hmm.refine import build_column_graph

    nid = 1
    block_nodes = []  # per block: (first-node per sid, last-node per sid)
    for b in blocks:
        keys = sorted(b.keys(), key=lambda k: path2id[k[1]])
        seqs = [b[k]["aln"].upper() for k in keys]
        sids = [path2id[k[1]] for k in keys]
        sub = PanGraph()
        for i, k in enumerate(keys):
            sub.graph["paths"].append(str(i))
            sub.graph["path2id"][str(i)] = i
            sub.graph["id2path"][i] = str(i)
        build_column_graph(
            sub, seqs, [100] * len(seqs[0]), minconf=0, idoffset=nid
        )
        # remap sub path-ids (0..k-1) to global sids and offsets to the
        # block's genomic starts
        first = {}
        last = {}
        for n in sub.nodes:
            d = sub.nodes[n]
            newoff = {}
            for i, off in d["offsets"].items():
                sid = sids[i]
                newoff[sid] = off + b[keys[i]]["start"]
                if sid not in first or newoff[sid] < first[sid][1]:
                    first[sid] = (n, newoff[sid])
                if sid not in last or (
                    newoff[sid] + len(d["seq"]) > last[sid][1]
                ):
                    last[sid] = (n, newoff[sid] + len(d["seq"]))
            d["offsets"] = newoff
        for _, _, d in sub.edges(data=True):
            d["paths"] = {sids[i] for i in d["paths"]}
        for n in sub.nodes:
            G.add_node(n, **sub.nodes[n])
        for u, v, d in sub.edges(data=True):
            G.add_edge(u, v, **d)
        nid = max(n for n in sub.nodes if isinstance(n, int)) + 1
        block_nodes.append((first, last))

    # stitch per-sequence unaligned stretches
    import uuid

    startnode = uuid.uuid4().hex
    endnode = uuid.uuid4().hex
    G.add_node(startnode, offsets={}, endpoint=True)
    G.add_node(endnode, offsets={}, endpoint=True)
    G.graph["startnodes"].append(startnode)
    G.graph["endnodes"].append(endnode)

    for (file, name), seq in sorted(db.items(), key=lambda kv: kv[0][1]):
        if name not in path2id:
            continue
        sid = path2id[name]
        G.nodes[startnode]["offsets"][sid] = 0
        intvs = []
        for bi, b in enumerate(blocks):
            if (file, name) in b:
                intvs.append(
                    (b[(file, name)]["start"], b[(file, name)]["end"], bi)
                )
        intvs.sort()
        pend = 0
        pnode = startnode
        for start, end, bi in intvs:
            firstn = block_nodes[bi][0][sid][0]
            if start > pend:
                G.add_node(
                    nid, seq=seq[pend:start], offsets={sid: pend}, aligned=0
                )
                G.add_edge(pnode, nid, paths={sid}, ofrom="+", oto="+")
                G.add_edge(nid, firstn, paths={sid}, ofrom="+", oto="+")
                nid += 1
            elif start < pend:
                log.error(
                    "Overlapping alignments for %s: (..%d) and (%d..)",
                    name,
                    pend,
                    start,
                )
                continue
            else:
                G.add_edge(pnode, firstn, paths={sid}, ofrom="+", oto="+")
            pnode = block_nodes[bi][1][sid][0]
            pend = end
        if len(seq) != pend:
            G.add_node(
                nid, seq=seq[pend:], offsets={sid: pend}, aligned=0
            )
            G.add_edge(pnode, nid, paths={sid}, ofrom="+", oto="+")
            G.add_edge(nid, endnode, paths={sid}, ofrom="+", oto="+")
            nid += 1
        else:
            G.add_edge(pnode, endnode, paths={sid}, ofrom="+", oto="+")
        G.graph["id2end"][sid] = len(seq)
        G.nodes[endnode]["offsets"][sid] = len(seq)

    return G
