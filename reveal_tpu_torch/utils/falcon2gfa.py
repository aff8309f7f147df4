"""falcon2gfa: convert FALCON p_ctg/a_ctg structure to a GFA graph.

Port of utils/falcon2gfa.py: primary contigs become the
backbone paths; alternative contigs attach as bubble branches at their
base-contig coordinates (optionally re-aligned with rem).
Run: python -m reveal_tpu_torch.utils.falcon2gfa p_ctg.fa a_ctg_base.fa a_ctg_all.fa
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..core.io_fasta import fasta_reader

log = logging.getLogger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="falcon2gfa",
        description="Transform FALCON's p_ctg/a_ctg_all/a_ctg_base "
        "structure to a GFA graph.",
    )
    parser.add_argument("p_ctg")
    parser.add_argument("a_ctg_base")
    parser.add_argument("a_ctg_all")
    parser.add_argument("--align", action="store_true", default=False)
    parser.add_argument("--device", default="cuda",
                        help="Torch device of --align: cuda or cpu.")
    parser.add_argument("-m", dest="minlength", type=int, default=20)
    parser.add_argument("-o", dest="output", default="falcon.gfa")
    args = parser.parse_args(argv)

    pctg2seq = {}
    for name, seq in fasta_reader(args.p_ctg):
        pctg2seq[name.split()[0]] = seq

    base2seq = {}
    pctg2bases = {}
    for name, seq in fasta_reader(args.a_ctg_base):
        name = name.split()[0]
        base2seq[name] = seq
        pctg2bases.setdefault(name.split("-")[0], []).append(name)

    alt2seq = {}
    base2alts = {}
    for name, seq in fasta_reader(args.a_ctg_all):
        name = name.split()[0]
        if name in base2seq:
            continue  # a_ctg_all includes the base variant itself
        alt2seq[name] = seq
        base = name.rsplit("-", 1)[0] if "-" in name else name
        base2alts.setdefault(base, []).append(name)

    if args.align:
        from ..align.rem import align_seqs
        from ..core.io_gfa import seq2node, write_gfa

        # align each base with its alternatives and the primary backbone
        aobjs = [(n, s) for n, s in pctg2seq.items()]
        for base, alts in base2alts.items():
            aobjs.append((base, base2seq.get(base, "")))
            for a in alts:
                aobjs.append((a, alt2seq[a]))
        aobjs = [(n, s) for n, s in aobjs if s]
        G, idx = align_seqs(aobjs, minlength=args.minlength,
                            device=args.device)
        seq2node(G, idx.main.T)
        # minimal start/end bookkeeping for the writer
        import uuid

        for name, _ in aobjs:
            sid = G.graph["path2id"][name]
            nodes = [
                (d["offsets"][sid], n)
                for n, d in G.nodes.items()
                if not isinstance(n, str) and sid in d.get("offsets", {})
            ]
            if not nodes:
                continue
            nodes.sort()
            s = uuid.uuid4().hex
            e = uuid.uuid4().hex
            G.add_node(s, offsets={sid: 0}, endpoint=True)
            G.add_node(
                e, offsets={sid: G.graph["id2end"][sid]}, endpoint=True
            )
            G.graph["startnodes"].append(s)
            G.graph["endnodes"].append(e)
            G.add_edge(s, nodes[0][1], paths={sid}, ofrom="+", oto="+")
            G.add_edge(nodes[-1][1], e, paths={sid}, ofrom="+", oto="+")
        out = write_gfa(G, idx.main.T, outputfile=args.output)
    else:
        # unaligned: one segment per contig, alternatives as parallel paths
        from ..core.io_gfa import write_gfa
        from ..graph.pangraph import PanGraph
        import uuid

        G = PanGraph()
        nid = 1
        for name, seq in list(pctg2seq.items()) + list(alt2seq.items()):
            sid = len(G.graph["paths"])
            G.graph["paths"].append(name)
            G.graph["path2id"][name] = sid
            G.graph["id2path"][sid] = name
            G.graph["id2end"][sid] = len(seq)
            G.add_node(nid, seq=seq, offsets={sid: 0}, aligned=0)
            s = uuid.uuid4().hex
            e = uuid.uuid4().hex
            G.add_node(s, offsets={sid: 0}, endpoint=True)
            G.add_node(e, offsets={sid: len(seq)}, endpoint=True)
            G.graph["startnodes"].append(s)
            G.graph["endnodes"].append(e)
            G.add_edge(s, nid, paths={sid}, ofrom="+", oto="+")
            G.add_edge(nid, e, paths={sid}, ofrom="+", oto="+")
            nid += 1
        out = write_gfa(G, None, outputfile=args.output)
    log.info("GFA written to %s", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
