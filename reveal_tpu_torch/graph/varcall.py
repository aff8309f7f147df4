"""Variant-call output: table / BED / fasta / VCF.

Port of bubbles_cmd and variants_cmd
(reveal/bubbles.py:239-532), with the reference's VCF
conventions preserved: allele flip so the reference path is allele 0,
anchor-base prepend for indels, reveal_* INFO fields, GT:SZ format.
"""

from __future__ import annotations

import logging
import sys
from dataclasses import dataclass
from typing import Optional, TextIO

from .bubbles import Variant, bubbles
from .pangraph import PanGraph

log = logging.getLogger(__name__)


@dataclass
class VariantFilter:
    minsize: int = 0
    mindiff: int = 0
    maxdiff: Optional[int] = None
    vtype: str = "all"
    nogaps: bool = False
    minflank: int = 0
    refonly: bool = False


def write_bubbles_table(
    G: PanGraph,
    out: Optional[TextIO] = None,
    exportcomplex: bool = False,
    separate: bool = False,
    gfaname: str = "graph.gfa",
    gml: bool = False,
) -> int:
    """bubbles_cmd (bubbles.py:239-278): per-subgraph bubble listing.

    exportcomplex writes complex-bubble subgraphs next to the input
    (one combined <name>.complex.gfa, or with separate=True one
    <name><src>.<sink>.complex.gfa each, bubbles.py:263-278); gml=True
    writes gml instead."""
    from ..core.io_gfa import write_gfa

    def _export(sg, outputfile):
        if gml:
            import networkx as nx

            H = nx.DiGraph()
            for n2, d2 in sg.nodes.items():
                H.add_node(str(n2), **{
                    k: str(v) if not isinstance(v, (str, int)) else v
                    for k, v in d2.items()})
            for u2, v2, d2 in sg.edges(data=True):
                H.add_edge(str(u2), str(v2), **{
                    k: str(w) if not isinstance(w, (str, int)) else w
                    for k, w in d2.items()})
            nx.write_gml(H, outputfile.replace(".gfa", ".gml"))
        else:
            write_gfa(sg, None, remap=False, outputfile=outputfile)

    if out is None:
        out = sys.stdout
    out.write("#source\tsink\tsubgraph\ttype\n")
    n = 0
    for comp in G.weakly_connected_components():
        g = G.subgraph(comp)
        complexnodes = []
        for b in bubbles(g):
            t = b.issimple()
            out.write(
                "%s\t%s\t%s\t%s\n"
                % (
                    b.source if not isinstance(b.source, str) else "<start>",
                    b.sink if not isinstance(b.sink, str) else "<end>",
                    ",".join(
                        str(x) for x in b.nodes if not isinstance(x, str)
                    ),
                    "simple" if t else "complex",
                )
            )
            n += 1
            if not t and exportcomplex:
                if separate:
                    sg = g.subgraph(set(b.nodes))
                    _export(
                        sg,
                        gfaname.replace(
                            ".gfa",
                            "%s.%s.complex.gfa" % (b.source, b.sink),
                        ),
                    )
                else:
                    complexnodes += list(b.nodes)
        if exportcomplex and not separate and complexnodes:
            sg = g.subgraph(complexnodes)
            _export(sg, gfaname.replace(".gfa", ".complex.gfa"))
    return n


def write_variants(
    G: PanGraph,
    reference: Optional[str] = None,
    flt: Optional[VariantFilter] = None,
    fmt: str = "table",  # table | vcf | bed | fasta
    out: Optional[TextIO] = None,
    split: bool = False,  # fasta fmt: one file per variant
) -> int:
    """variants_cmd (bubbles.py:336-532)."""
    if out is None:
        out = sys.stdout
    flt = flt or VariantFilter()
    gori = sorted(p for p in G.graph["paths"] if not p.startswith("*"))
    if reference is None:
        reference = gori[0]
        log.warning(
            "No reference specified as coordinate system, using %s where "
            "possible.",
            reference,
        )
    if reference not in G.graph["path2id"]:
        raise ValueError(
            "Reference %r not in graph (has: %s)"
            % (reference, G.graph["paths"])
        )
    refsid = G.graph["path2id"][reference]
    id2path = G.graph["id2path"]

    if fmt == "table":
        out.write(
            "#reference\tpos_start\tpos_end\tsource_size\tsink_size\t"
            "max_allele_size\tmin_allele_size\tdiff_allele_size\tsource\t"
            "sink\tsource_seq\tsink_seq\ttype\tgenotypes"
        )
        for sample in gori:
            out.write("\t%s" % sample)
        out.write("\n")
    elif fmt == "vcf":
        out.write("##fileformat=VCFv4.0\n")
        out.write("##source=REVEAL\n")
        for sid in G.graph["id2path"]:
            out.write(
                "##contig=<ID=%s,LENGTH=%d>\n"
                % (id2path[sid], G.graph["id2end"][sid])
            )
        out.write(
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        )
        out.write(
            '##FORMAT=<ID=SZ,Number=1,Type=Integer,Description="Allele size">\n'
        )
        out.write(
            '##INFO=<ID=reveal_diffsize,Number=1,Type=Integer,Description='
            '"Difference between the shortest and longest allele.">\n'
        )
        out.write(
            '##INFO=<ID=reveal_source,Number=1,Type=String,Description='
            '"Source of the node pair.">\n'
        )
        out.write(
            '##INFO=<ID=reveal_sink,Number=1,Type=String,Description='
            '"Sink of the node pair.">\n'
        )
        out.write(
            '##INFO=<ID=reveal_bubbletype,Number=1,Type=String,Description='
            '"Simplistic interpretation of the variant.">\n'
        )
        out.write(
            '##INFO=<ID=reveal_start,Number=1,Type=String,Description='
            '"Start position on the specified reference.">\n'
        )
        out.write(
            '##INFO=<ID=reveal_end,Number=1,Type=String,Description='
            '"End position on the specified reference.">\n'
        )
        out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT")
        for sample in gori:
            out.write("\t%s" % sample)
        out.write("\n")

    count = 0
    for b in bubbles(G):
        v = Variant(b)
        if v.maxsize < flt.minsize:
            continue
        if v.maxsize - v.minsize < flt.mindiff:
            continue
        if flt.maxdiff is not None and v.maxsize - v.minsize > flt.maxdiff:
            continue
        if flt.vtype != "all" and v.vtype != flt.vtype:
            continue
        if flt.nogaps and v.spans_gap:
            continue

        minflank = min(
            len(G.nodes[v.source].get("seq", "")),
            len(G.nodes[v.sink].get("seq", "")),
        )
        if minflank < flt.minflank:
            continue

        if refsid in v.vpos:
            cds = refsid
        else:
            if flt.refonly:
                continue
            for cds in v.vpos.keys():
                if not id2path[cds].startswith("*"):
                    break

        sourcelen = len(G.nodes[v.source].get("seq", ""))
        sinklen = len(G.nodes[v.sink].get("seq", ""))
        startpos = G.nodes[v.source]["offsets"][cds] + sourcelen
        endpos = G.nodes[v.sink]["offsets"][cds]

        if fmt == "fasta":
            if split:
                # one multi-fasta per variant, named by its bounding
                # nodes (bubbles.py:434-440)
                with open("%s_%s.fasta" % (v.source, v.sink), "w") as of:
                    for i, seq in enumerate(v.genotypes):
                        if seq != "-":
                            of.write(
                                ">%s:%d-%d_%d\n"
                                % (id2path[cds], startpos, endpos, i)
                            )
                            of.write("%s\n" % seq)
            else:
                for i, seq in enumerate(v.genotypes):
                    if seq != "-":
                        out.write(
                            ">%s:%d-%d_%d\n"
                            % (id2path[cds], startpos, endpos, i)
                        )
                        out.write("%s\n" % seq)
            count += 1
            continue

        if fmt == "bed":
            out.write(
                "%s\t%d\t%s\t%s\n" % (id2path[cds], startpos, endpos, v.vtype)
            )
            count += 1
            continue

        allelesizes = [0 if gt == "-" else len(gt) for gt in v.genotypes]
        maxa = max(allelesizes)
        mina = min(allelesizes)

        if fmt == "vcf":
            startpos += 1
            if maxa - mina > 0:
                startpos -= 1
                v.genotypes = [
                    G.nodes[v.source]["seq"][-1:]
                    + ("" if gt == "-" else gt)
                    for gt in v.genotypes
                ]
            refcall = v.calls[id2path[cds]]
            if refcall != 0:
                # flip alleles so the reference path carries allele 0
                v.genotypes[0], v.genotypes[refcall] = (
                    v.genotypes[refcall],
                    v.genotypes[0],
                )
            _calls = {}
            for sample in v.calls:
                if v.calls[sample] == refcall:
                    _calls[sample] = 0
                elif v.calls[sample] == 0:
                    _calls[sample] = refcall
                else:
                    _calls[sample] = v.calls[sample]
            v.calls = _calls

            out.write(
                "%s\t%d\t%s\t%s\t%s\t%s\t%s\t%s\t%s"
                % (
                    id2path[cds],
                    startpos,
                    ".",
                    v.genotypes[0],
                    ",".join(v.genotypes[1:]),
                    ".",
                    "PASS",
                    "reveal_diffsize=%s;reveal_source=%s;reveal_sink=%s;"
                    "reveal_bubbletype=%s;reveal_start=%d;reveal_end=%d"
                    % (
                        maxa - mina,
                        v.source
                        if not isinstance(v.source, str)
                        else "<start>",
                        v.sink if not isinstance(v.sink, str) else "<end>",
                        v.vtype,
                        startpos,
                        endpos,
                    ),
                    "GT:SZ",
                )
            )
            for sample in gori:
                if sample in v.calls:
                    out.write(
                        "\t%s:%d"
                        % (v.calls[sample], len(v.genotypes[v.calls[sample]]))
                    )
                else:
                    out.write("\t.")
        else:  # table
            out.write(
                "%s\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%s\t%s\t%s\t%s\t%s\t%s"
                % (
                    id2path[cds],
                    startpos,
                    endpos,
                    sourcelen,
                    sinklen,
                    maxa,
                    mina,
                    maxa - mina,
                    v.source if not isinstance(v.source, str) else "<start>",
                    v.sink if not isinstance(v.sink, str) else "<end>",
                    G.nodes[v.source]["seq"][-20:] if v.source in G else "-",
                    G.nodes[v.sink]["seq"][:20] if v.sink in G else "-",
                    v.vtype,
                    ",".join(v.genotypes),
                )
            )
            for sample in gori:
                if sample in v.calls:
                    out.write("\t%s" % v.calls[sample])
                else:
                    out.write("\t-")
        out.write("\n")
        count += 1
    return count
