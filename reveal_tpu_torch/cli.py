"""Command line of the torch port.

Subcommand-compatible with ``python -m reveal_tpu.cli``: rem, bubbles,
variants, refine (alias realign), unzip, extract, stats, split, merge,
comp, subgraph, convert, align, plot/gplot, chop, transform, finish,
chain, rearrangements, annotate, matches.  Run ``python -m
reveal_tpu_torch.cli <subcommand> -h``.  Every subcommand takes the
global options ``-l``, ``--64`` (accepted), ``--backend
auto|native|jax|jax-dist|np`` (the suffix-array build: ``auto`` is the
native one, never a quiet switch to numpy; ``jax`` is the device doubling
build, ``jax-dist`` the distributed build over a process group's ranks, a
world of one unless the caller set up a group; both on ``--device`` for
the subcommands that have it -- ``rem``, ``refine``, ``align``,
``matches``, ``plot``, ``chain``, ``transform`` and ``finish`` -- and on
the card elsewhere, never quietly on the CPU) and
``--profile DIR`` (a ``torch.profiler`` trace of the whole command, CPU
and, on a card, CUDA activity, written into DIR).

    python -m reveal_tpu_torch.cli rem A.fa|A.gfa B.fa|B.gfa [C ...] \\
        [--device cuda|cpu] [-m MINLENGTH] [rem options] [-o out.gfa]
    python -m reveal_tpu_torch.cli refine G.gfa --all|--simple|--complex \\
        [--device cuda|cpu] [-o out.gfa] [refine options]
    python -m reveal_tpu_torch.cli align A.fa ... F.fa [--run] \\
        [--device cuda|cpu] [--order simultaneous|sequential] [-o prg]

``rem`` runs the recursion on ``--device`` (default ``cuda``; without a
card that is an error, never a quiet switch to the CPU): two
single-sequence fastas through the native host prefix and the device
forest (what they decline, and with ``REVEAL_TPU_DEVLOOP_MODE=full``
every such pair, through the single-root device loop), three or more
(up to 8 contig paths) through the multi-genome device loop, and every
other input (``.gfa`` inputs, multi-contig pairs, ``--notrim``,
``--seedsize``, ``--gcmodel``, ``--maxsize``) through the per-level
device frontier.  An input the multi loop declines (a segment with more
than ``--maxmums`` candidates, which bacterial-scale inputs have at the
default of 10,000, more than 8 paths, or a capacity it cannot meet) goes
to the per-level frontier on the same device, as in ``reveal_tpu``; so
does a pair the single-root loop declines.  ``--frontier`` is accepted
and always on; ``-t`` is accepted and changes nothing, since the device
route wins over it (in ``reveal_tpu`` too).  ``--checkpoint FILE`` asks
for the one route that can resume, the serial LIFO host engine logging
every pick to FILE (with ``--frontier`` or ``-t`` it is refused, as in
``reveal_tpu``).  The GFA and the identity log line are those of
``python -m reveal_tpu.cli rem``.

``refine`` (alias ``realign``) realigns bubbles with the pair-HMM
consistency MSA.  On a card (``--device cuda``) the posteriors, MEA
distances and consistency transform of every bubble under the chain's
size cap run on the card and the rest of the MSA on the host; a bubble
over the cap, and every bubble on ``--device cpu``, has its posteriors
computed on the device and its consistency transform on the host.
``--logadd-compat`` computes every posterior on the host with ProbCons'
LOG_ADD table arithmetic; ``--method`` muscle, probcons, msaprobs or
pecan runs that aligner from ``$PATH``, ``reveal_rem`` the host anchor
aligner; ``--nproc N`` runs the per-bubble MSA in N forked processes.

``align`` prints the pipeline rem -> unzip -> refine -> variants as a
shell script of ``python -m reveal_tpu_torch.cli`` lines, ``--device``
passed on to every ``rem`` and ``refine`` line; with ``--run`` it runs
the same lines in this process, one device context and one build of the
kernels for all stages.

The other subcommands are host code and give the bytes of ``python -m
reveal_tpu.cli``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

log = logging.getLogger(__name__)

TRACE = 1

PROG = "python -m reveal_tpu_torch.cli"


def _global_parser():
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument(
        "-l",
        "--log-level",
        dest="loglevel",
        type=int,
        default=20,
        help="Log level: 1=trace 10=debug 20=info 30=warn 40=error 50=fatal.",
    )
    p.add_argument(
        "--64",
        dest="sa64",
        action="store_true",
        default=False,
        help="Accepted for compatibility with reveal_tpu's CLI (which "
        "reads it nowhere either): the host suffix arrays are int64.",
    )
    p.add_argument(
        "--backend",
        dest="backend",
        default="auto",
        choices=["auto", "native", "jax", "jax-dist", "np"],
        help="Index-construction backend: auto/native (host C++; a "
        "failed build is an error), jax (the device doubling build), "
        "jax-dist (the distributed build over the ranks of a process "
        "group; a world of one unless the caller set one up), np (numpy "
        "oracle).  The device builds run on --device where the "
        "subcommand has it (rem, refine, align, matches, plot, chain, "
        "transform, finish), on the card elsewhere.",
    )
    p.add_argument(
        "--profile",
        dest="profiledir",
        default=None,
        metavar="DIR",
        help="Trace the whole command with torch.profiler (CPU activity "
        "and, on a card, CUDA activity) and write the trace (a "
        "TensorBoard/Chrome trace JSON) into DIR.",
    )
    return p


def _device_option(p, what):
    p.add_argument(
        "--device", default="cuda",
        help="Torch device of %s: cuda (default) or cpu." % what,
    )


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def rem_cmd(args):
    from .align.rem import align_genomes
    from .align.graphops import prune_nodes
    from .core import trace
    from .core.io_gfa import seq2node, write_gfa

    G, idx = align_genomes(
        args.inputfiles,
        device=args.device,
        contigs=not args.nocontigs,
        backend=args.backend,
        safile=args.sa,
        lcpfile=args.lcp,
        cache=args.cache,
        multi=args.multi,
        # the device route unless a checkpoint asks for the host LIFO loop
        frontier=args.frontier or not args.checkpoint,
        threads=args.threads,
        checkpoint=args.checkpoint,
        minlength=args.minlength,
        minn=args.minn,
        maxmums=args.maxmums,
        wpen=args.wpen,
        wscore=args.wscore,
        seedsize=args.seedsize,
        pcutoff=args.pcutoff,
        gcmodel=args.gcmodel,
        maxsize=args.maxsize,
        trim=not args.notrim,
    )

    if args.output is None:
        pref = []
        for f in args.inputfiles:
            bn = os.path.basename(f)
            pref.append(bn[: bn.find(".")] if "." in bn else bn)
        args.output = "_".join(pref) + ".gfa.gz"

    with trace.span("rem.finish"):
        T = idx.main.T
        if len(G.graph["paths"]) > 2:
            prune_nodes(G, T=T)
        seq2node(G, T)

        # identity stats (rem.align_cmd, rem.py:470-490)
        totbases = (
            idx.main.nT
            - int((T == ord("$")).sum())
            - int((T == ord("N")).sum())
            - int((T == ord("n")).sum())
        )
        alignedbases = alignednodes = 0
        nsamples = idx.main.nsamples
        for n, d in G.nodes.items():
            if isinstance(n, str) or d.get("aligned", 0) == 0:
                continue
            if nsamples > 2:
                alignedbases += (n[1] - n[0]) * len(
                    [
                        k
                        for k in d["offsets"]
                        if not G.graph["id2path"][k].startswith("*")
                    ]
                )
            else:
                alignedbases += (n[1] - n[0]) * 2
            alignednodes += 1

    log.info(
        "%s (%.2f%% identity, %d bases out of %d aligned, %d nodes aligned).",
        "-".join(os.path.basename(f) for f in args.inputfiles),
        alignedbases / float(totbases) * 100 if totbases else 0,
        alignedbases,
        totbases,
        alignednodes,
    )

    if args.gml:
        import networkx as nx

        H = nx.DiGraph()
        for n, d in G.nodes.items():
            H.add_node(
                str(n),
                **{
                    k: str(v) if not isinstance(v, (str, int)) else v
                    for k, v in d.items()
                },
            )
        for u, v, d in G.edges(data=True):
            H.add_edge(
                str(u),
                str(v),
                **{
                    k: str(w) if not isinstance(w, (str, int)) else w
                    for k, w in d.items()
                },
            )
        out = args.output
        for ext in (".gfa.gz", ".gfa"):
            if out.endswith(ext):
                out = out[: -len(ext)]
        out += ".gml"
        nx.write_gml(H, out)
    else:
        with trace.span("rem.write"):
            out = write_gfa(G, T, outputfile=args.output)
    log.info("Graph written to: %s", out)


def bubbles_cmd(args):
    from .core.io_gfa import read_gfa
    from .graph.varcall import write_bubbles_table

    G = read_gfa(args.graph[0])
    write_bubbles_table(
        G,
        exportcomplex=args.exportcomplex,
        separate=args.separate,
        gfaname=args.graph[0],
        gml=args.gml,
    )


def variants_cmd(args):
    from .core.io_gfa import read_gfa
    from .graph.varcall import VariantFilter, write_variants

    G = read_gfa(args.graph[0])
    fmt = (
        "vcf"
        if args.vcf
        else "bed"
        if args.bed
        else "fasta"
        if args.fastaout
        else "table"
    )
    flt = VariantFilter(
        minsize=args.minsize,
        mindiff=args.mindiff,
        maxdiff=args.maxdiff,
        vtype=args.type,
        nogaps=args.nogaps,
        minflank=args.minflank,
        refonly=args.refonly,
    )
    write_variants(
        G, reference=args.reference, flt=flt, fmt=fmt, split=args.split
    )


def refine_cmd(args):
    from .align.graphops import prune_nodes
    from .core.io_gfa import read_gfa, write_gfa
    from .graph.simplify import contract
    from .hmm.refine import refine_all

    G = read_gfa(args.graph[0])
    if not (args.all or args.complex or args.simple):
        log.error("Specify one of --all --simple --complex.")
        sys.exit(1)
    if getattr(args, "logadd_compat", False):
        from .hmm.msa import set_logadd_compat

        set_logadd_compat(True)
    ck_meta = None
    if args.checkpoint:
        import hashlib

        with open(args.graph[0], "rb") as f:
            ck_meta = {"gfa_sha1": hashlib.sha1(f.read()).hexdigest()}
    G = refine_all(
        G,
        checkpoint=args.checkpoint,
        checkpoint_meta=ck_meta,
        device=args.device,
        minlength=args.minlength,
        minsize=args.minsize,
        mindiff=args.mindiff,
        maxdiff=args.maxdiff,
        maxsize=args.maxsize,
        maxcumsize=args.maxcumsize,
        mincumsize=args.mincumsize,
        complex_only=args.complex,
        simple_only=args.simple,
        nogaps=args.nogaps,
        minconf=args.minconf,
        constrans=args.constrans,
        consgap=args.consgap,
        nrefinements=args.nrefinements,
        uniqueonly=args.uniqueonly,
        nproc=args.nproc,
        method=args.method,
        parameters=args.parameters,
        wpen=args.wpen,
        wscore=args.wscore,
    )
    fn = (
        args.outfile
        if args.outfile
        else args.graph[0]
        .replace(".gfa.gz", ".realigned.gfa")
        .replace(".gfa", ".realigned.gfa")
    )
    if not fn.endswith(".realigned.gfa") and ".gfa" not in fn:
        fn += ".gfa"
    prune_nodes(G)
    order = [n for n in G.topological_sort() if not isinstance(n, str)]
    contract(G, order)
    out = write_gfa(G, None, outputfile=fn)
    log.info("Refined graph written to: %s", out)


def unzip_cmd(args):
    from .core.io_gfa import read_gfa, write_gfa
    from .graph.unzip import unzip_graph

    G = read_gfa(args.graph[0])
    unzip_graph(
        G,
        minunzip=args.minunzip,
        mindiff=args.mindiff,
        maxdiff=args.maxdiff,
    )
    if args.output is None:
        base = args.graph[0]
        for ext in (".gfa.gz", ".gfa"):
            if base.endswith(ext):
                base = base[: -len(ext)]
                break
        of = base + ".unzipped.gfa"
    else:
        of = args.output + ".gfa"
    out = write_gfa(G, None, outputfile=of)
    log.info("Unzipped graph written to: %s", out)


def extract_cmd(args):
    from .core.io_gfa import read_gfa
    from .graph.extract import extract, extract_path

    G = read_gfa(args.graph)
    width = args.width
    inputs = args.input
    if args.all:
        inputs = sorted(G.graph["paths"])
    for sample in inputs:
        if args.type == "path":
            seq = extract_path(G, sample.split(","))
        else:
            seq = extract(G, sample)
        sys.stdout.write(">%s\n" % sample)
        for i in range(0, len(seq), width):
            sys.stdout.write(seq[i : i + width] + "\n")


def split_cmd(args):
    from .core.io_gfa import read_gfa, write_gfa

    G = read_gfa(args.graph[0])
    base = args.graph[0]
    for ext in (".gfa.gz", ".gfa"):
        if base.endswith(ext):
            base = base[: -len(ext)]
    for i, comp in enumerate(G.weakly_connected_components()):
        sg = G.subgraph(comp)
        # restrict path registry to paths present in this component
        present = set()
        for n in sg.nodes:
            present |= set(sg.nodes[n].get("offsets", {}).keys())
        sg.graph["path2id"] = {
            p: sid
            for p, sid in G.graph["path2id"].items()
            if sid in present
        }
        out = write_gfa(sg, None, outputfile="%s.%d.gfa" % (base, i))
        log.info("Wrote %s", out)


def merge_cmd(args):
    from .core.io_gfa import read_gfa, write_gfa

    G = None
    from .graph.pangraph import PanGraph

    G = PanGraph()
    for f in args.graphs:
        read_gfa(f, graph=G, remap=True)
    out = write_gfa(G, None, outputfile=args.output or "merged.gfa")
    log.info("Merged graph written to: %s", out)


def comp_cmd(args):
    from .core.encoding import rc_str
    from .core.io_gfa import read_gfa, write_gfa

    G = read_gfa(args.graph[0])
    # reverse the graph: complement sequences, flip edges, relabel offsets
    # (comp.py:4-31)
    genome2length = {}
    for sid in G.graph["id2path"]:
        maxp = 0
        for n in G.nodes:
            d = G.nodes[n]
            if sid in d.get("offsets", {}):
                maxp = max(maxp, d["offsets"][sid] + len(d.get("seq", "")))
        genome2length[sid] = maxp
    for n in G.nodes:
        d = G.nodes[n]
        if "seq" in d:
            d["seq"] = rc_str(d["seq"])
        for sid in d.get("offsets", {}):
            d["offsets"][sid] = genome2length[sid] - (
                d["offsets"][sid] + len(d.get("seq", ""))
            )
    # flip edges
    from .graph.pangraph import PanGraph

    H = PanGraph()
    H.graph = G.graph
    for n in G.nodes:
        H.add_node(n, **G.nodes[n])
    for u, v, d in G.edges(data=True):
        H.add_edge(v, u, **d)
    H.graph["startnodes"], H.graph["endnodes"] = (
        H.graph["endnodes"],
        H.graph["startnodes"],
    )
    out = write_gfa(H, None, outputfile=args.output or "rc.gfa")
    log.info("Reverse-complemented graph written to: %s", out)


def subgraph_cmd(args):
    from .core.io_gfa import read_gfa, write_gfa

    G = read_gfa(args.inputfiles[0])
    nodes = set(int(n) for n in args.inputfiles[1:])
    sg = G.subgraph(nodes)
    present = set()
    for n in sg.nodes:
        present |= set(sg.nodes[n].get("offsets", {}).keys())
    sg.graph["path2id"] = {
        p: sid for p, sid in G.graph["path2id"].items() if sid in present
    }
    out = write_gfa(sg, None, outputfile=args.outfile)
    log.info("Subgraph written to: %s", out)


def stats_cmd(args):
    from .core.io_gfa import read_gfa
    from .graph.bubbles import Variant, bubbles

    G = read_gfa(args.graph[0])
    samples = [p for p in G.graph["paths"] if not p.startswith("*")]
    sys.stdout.write("Graph: %s\n" % args.graph[0])
    sys.stdout.write("Nodes: %d\n" % G.number_of_nodes())
    sys.stdout.write("Edges: %d\n" % G.number_of_edges())
    sys.stdout.write("Samples (%d): %s\n" % (len(samples), ",".join(samples)))
    tot = 0
    sharedby = {}
    for n in G.nodes:
        d = G.nodes[n]
        if "seq" not in d:
            continue
        l = len(d["seq"])
        tot += l
        k = len(
            [
                s
                for s in d.get("offsets", {})
                if not G.graph["id2path"][s].startswith("*")
            ]
        )
        sharedby[k] = sharedby.get(k, 0) + l
    sys.stdout.write("Total sequence: %d bp\n" % tot)
    for k in sorted(sharedby):
        sys.stdout.write(
            "  shared by %d samples: %d bp\n" % (k, sharedby[k])
        )
    # base composition (stats.py:37-47)
    counts = {b: 0 for b in "ACGTN"}
    for n in G.nodes:
        s = G.nodes[n].get("seq", "")
        for b in counts:
            counts[b] += s.count(b)
    for b in "ACGTN":
        sys.stdout.write("Count %s: %d\n" % (b, counts[b]))

    # structural (rearrangement) edges from the raw GFA: the DiGraph
    # reader drops them, so count edges traversed only by '*' paths
    # (MultiGraphToDiGraph's struct set, stats.py:23,33)
    import gzip as gzipmod

    opener = gzipmod.open if args.graph[0].endswith(".gz") else open
    pathwalks = {}
    with opener(args.graph[0], "rt") as f:
        for line in f:
            if line.startswith("P"):
                cols = line.rstrip().split("\t")
                if len(cols) >= 3 and cols[2]:
                    pathwalks[cols[1]] = [
                        (x[:-1], x[-1]) for x in cols[2].split(",")
                    ]
    edge2paths = {}
    for sample, walk in pathwalks.items():
        for (a, ao), (b, bo) in zip(walk, walk[1:]):
            edge2paths.setdefault((a, ao, b, bo), set()).add(sample)
    nstruct = sum(
        1
        for ps in edge2paths.values()
        if all(p.startswith("*") for p in ps)
    )
    sys.stdout.write("Number of rearrangement edges: %d\n" % nstruct)

    comps = G.weakly_connected_components()
    sys.stdout.write("Number of connected components: %d\n" % len(comps))
    for i, comp in enumerate(comps):
        names = set()
        for n in comp:
            for sid in G.nodes[n].get("offsets", {}):
                p = G.graph["id2path"][sid]
                if not p.startswith("*"):
                    names.add(p)
        sys.stdout.write(
            "Composition of component %d: %s\n"
            % (i, ",".join(sorted(names)))
        )

    vtypes = {}
    for b in bubbles(G):
        v = Variant(b)
        vtypes[v.vtype] = vtypes.get(v.vtype, 0) + 1
    for t in sorted(vtypes):
        sys.stdout.write("Variants (%s): %d\n" % (t, vtypes[t]))


def chop_cmd(args):
    from .core.io_gfa import read_gfa, write_gfa
    from .graph.chop import chop, chop_check

    prefix = args.graph[0]
    for ext in (".gfa.gz", ".gfa"):
        if prefix.endswith(ext):
            prefix = prefix[: -len(ext)]
    G = read_gfa(args.graph[0])
    Gorg = G.copy() if args.check else None
    chop(G, k=args.k, extend=not args.noextend)
    for node in G.nodes:
        if isinstance(node, str):
            continue
        d = G.nodes[node]
        d["seq"] = d.get("prefix", "") + d["seq"] + d.get("suffix", "")
    gof = (args.output or prefix + ".chopped") + ".gfa.gz"
    out = write_gfa(G, None, outputfile=gof, remap=False)
    log.info("Chopped graph written to: %s", out)
    if args.check:
        ok = chop_check(Gorg, G, args.k)
        if not ok:
            sys.exit(1)
        log.info("All %d-mers covered.", args.k)


def transform_cmd(args):
    from .transform.driver import TransformConfig, transform

    cfg = TransformConfig(
        minlength=args.minlength,
        minctglength=args.minctglength,
        cutn=args.cutn,
        cluster=not args.nocluster,
        maxdist=args.maxdist,
        mincluster=args.mincluster,
        rearrangecost=args.rearrangecost,
        inversioncost=args.inversioncost,
        _lambda=args._lambda,
        eps=args.eps,
        alfa=args.alfa,
        gapopen=args.gapopen,
        useheap=args.useheap,
        lastn=args.lastn,
        lastbp=args.lastbp,
        greedy=args.greedy,
        minchainsum=args.minchainsum,
        optimise=not args.nooptimise,
        outputbed=not args.nobed,
        backend=args.backend,
    )
    for qry in args.contigs:
        log.info("Running transform for %s", qry)
        transform(args.reference[0], qry, cfg, output=args.output)


def finish_cmd(args):
    from .transform.finish import FinishConfig, finish

    cfg = FinishConfig(
        minlength=args.minlength,
        cutn=args.cutn,
        maxdist=args.maxdist,
        mincluster=args.mincluster,
        mineventsize=args.mineventsize,
        minchainsum=args.minchainsum,
        maxmums=args.maxmums,
        extiter=args.extiter,
        maxextend=args.maxextend,
        minlocallength=args.minlocallength,
        order=args.order,
        outputtype=args.outputtype,
        allcontigs=args.allcontigs,
        fixedsize=args.fixedsize,
        gapsize=args.gapsize,
        fixedgapsize=args.fixedgapsize,
        outputunmapped=not args.nounplaced,
        backend=args.backend,
    )
    finish(
        args.reference, args.contigs, cfg, output=args.output,
        split=args.split,
    )


def convert_cmd(args):
    import uuid as uuidmod

    from .core.io_gfa import read_gfa, write_gfa
    from .graph.pangraph import PanGraph

    for graph in args.graphs:
        if graph.endswith(".gfa") or graph.endswith(".gfa.gz"):
            g = read_gfa(graph)
            base = graph
            for ext in (".gfa.gz", ".gfa"):
                if base.endswith(ext):
                    base = base[: -len(ext)]
            if args.type == "gfa":
                fn = write_gfa(g, None, outputfile=base + ".rewrite.gfa")
                log.info("gfa graph written to: %s", fn)
            elif args.type == "gml":
                import networkx as nx

                H = nx.DiGraph()
                for n, d in g.nodes.items():
                    H.add_node(
                        str(n),
                        **{
                            k: str(v) if not isinstance(v, (str, int)) else v
                            for k, v in d.items()
                        },
                    )
                for u, v, d in g.edges(data=True):
                    H.add_edge(
                        str(u),
                        str(v),
                        **{
                            k: str(w) if not isinstance(w, (str, int)) else w
                            for k, w in d.items()
                        },
                    )
                fn = base + ".gml"
                nx.write_gml(H, fn)
                log.info("gml graph written to: %s", fn)
            elif args.type == "maf":
                from .core.io_maf import graph2maf

                fn = graph2maf(g, base + ".maf")
                log.info("maf written to: %s", fn)
            else:
                log.fatal("Unknown conversion type: %s", args.type)
                sys.exit(1)
        elif graph.endswith(".maf"):
            from .core.maf2graph import maf2graph

            g = maf2graph(graph)
            base = graph[: graph.rfind(".")]
            fn = write_gfa(g, None, outputfile=base + ".gfa")
            log.info("gfa graph written to: %s", fn)
        elif graph.endswith((".fa", ".fasta", ".fna")):
            from .core.io_fasta import fasta_reader

            g = PanGraph()
            base = graph[: graph.rfind(".")]
            if args.aligned:
                from .hmm.refine import build_column_graph

                seqs = []
                names = []
                for name, seq in fasta_reader(graph, keepdash=True):
                    names.append(name)
                    seqs.append(seq.replace(".", "-"))
                for i, name in enumerate(names):
                    g.graph["paths"].append(name)
                    g.graph["path2id"][name] = i
                    g.graph["id2path"][i] = name
                    g.graph["id2end"][i] = len(seqs[i].replace("-", ""))
                build_column_graph(
                    g, seqs, [100] * len(seqs[0]), minconf=0, idoffset=1
                )
                start = uuidmod.uuid4().hex
                end = uuidmod.uuid4().hex
                g.add_node(start, offsets={}, endpoint=True)
                g.add_node(end, offsets={}, endpoint=True)
                g.graph["startnodes"].append(start)
                g.graph["endnodes"].append(end)
                for i in range(len(names)):
                    first = min(
                        (
                            (d["offsets"][i], n)
                            for n, d in g.nodes.items()
                            if i in d.get("offsets", {})
                            and not isinstance(n, str)
                        ),
                    )[1]
                    lastn = max(
                        (
                            (d["offsets"][i], n)
                            for n, d in g.nodes.items()
                            if i in d.get("offsets", {})
                            and not isinstance(n, str)
                        ),
                    )[1]
                    g.nodes[start]["offsets"][i] = 0
                    g.nodes[end]["offsets"][i] = g.graph["id2end"][i]
                    if g.has_edge(start, first):
                        g.edge(start, first)["paths"].add(i)
                    else:
                        g.add_edge(
                            start, first, paths={i}, ofrom="+", oto="+"
                        )
                    if g.has_edge(lastn, end):
                        g.edge(lastn, end)["paths"].add(i)
                    else:
                        g.add_edge(lastn, end, paths={i}, ofrom="+", oto="+")
            else:
                start = uuidmod.uuid4().hex
                end = uuidmod.uuid4().hex
                g.graph["startnodes"] = [start]
                g.graph["endnodes"] = [end]
                g.add_node(start, offsets={}, endpoint=True)
                g.add_node(end, offsets={}, endpoint=True)
                for i, (name, seq) in enumerate(fasta_reader(graph)):
                    g.graph["paths"].append(name)
                    g.graph["path2id"][name] = i
                    g.graph["id2path"][i] = name
                    g.graph["id2end"][i] = len(seq)
                    g.nodes[start]["offsets"][i] = 0
                    g.nodes[end]["offsets"][i] = len(seq)
                    g.add_node(i + 1, offsets={i: 0}, seq=seq, aligned=0)
                    g.add_edge(start, i + 1, paths={i}, ofrom="+", oto="+")
                    g.add_edge(i + 1, end, paths={i}, ofrom="+", oto="+")
            fn = write_gfa(g, None, outputfile=base + ".gfa")
            log.info("gfa graph written to: %s", fn)
        else:
            log.fatal("Unknown filetype: %s", graph)
            sys.exit(1)


def rearrangements_cmd(args):
    """Report structural (rearrangement) edges: edges traversed only by
    '*'-prefixed original-layout paths (bubbles.rearrangements_cmd,
    bubbles.py:280-334).  Works from the raw GFA so inversion edges are
    kept."""
    import gzip as gzipmod

    fn = args.graph[0]
    opener = gzipmod.open if fn.endswith(".gz") else open
    seqs = {}
    paths = {}
    with opener(fn, "rt") as f:
        for line in f:
            if line.startswith("S"):
                s = line.rstrip().split("\t")
                seqs[s[1]] = s[2] if len(s) > 2 else ""
            elif line.startswith("P"):
                cols = line.rstrip().split("\t")
                if len(cols) >= 3 and cols[2]:
                    paths[cols[1]] = [
                        (x[:-1], x[-1]) for x in cols[2].split(",")
                    ]
    # per-edge traversals
    edge2paths = {}
    for sample, walk in paths.items():
        for (a, ao), (b, bo) in zip(walk, walk[1:]):
            edge2paths.setdefault((a, ao, b, bo), set()).add(sample)
    refpaths = {p for p in paths if not p.startswith("*")}

    # offsets of nodes on each path
    node_off = {}
    for sample, walk in paths.items():
        o = 0
        for n, _ in walk:
            node_off.setdefault(n, {})[sample] = o
            o += len(seqs.get(n, ""))

    reference = args.reference
    if reference is None:
        cands = sorted(refpaths)
        reference = cands[0] if cands else None

    sys.stdout.write(
        "#reference\tapproximate_pos\tcontigs\tsource\tsink\tinvert\tpaths\n"
    )
    n = 0
    for (a, ao, b, bo), ps in edge2paths.items():
        if ps & refpaths:
            continue  # traversed by a reference-layout path: not structural
        contigs = sorted(p for p in ps if p.startswith("*"))
        pos = node_off.get(b, {})
        vpos = None
        vref = None
        for p in sorted(pos):
            if reference and p.startswith(reference):
                vref, vpos = p, pos[p]
                break
        if vpos is None and pos:
            vref = sorted(pos)[0]
            vpos = pos[vref]
        sys.stdout.write(
            "%s\t%s\t%s\t%s\t%s\t%s\t%s\n"
            % (
                vref,
                vpos,
                contigs,
                a,
                b,
                ao == bo,
                ",".join(sorted(ps)),
            )
        )
        n += 1
    log.info("%d rearrangement edges.", n)


def chain_cmd(args):
    from .align.kdchain import chain_cmd_impl
    from .core.io_gfa import write_gfa

    G, T = chain_cmd_impl(
        args.fastas,
        minlength=args.minlength,
        minn=args.minn,
        maxmums=args.maxmums,
        recurse=not args.norecurse,
        gcmodel=args.gcmodel,
        wpen=args.wpen,
        wscore=args.wscore,
        backend=args.backend,
    )
    if args.output is None:
        pref = []
        for f in args.fastas:
            bn = os.path.basename(f)
            pref.append(bn[: bn.find(".")] if "." in bn else bn)
        args.output = "_".join(pref)
    out = write_gfa(G, None, outputfile=args.output + ".gfa")
    log.info("Chain graph written to: %s", out)


def annotate_cmd(args):
    from .graph.annotate import annotate_vcf

    vcfin = open(args.vcf) if args.vcf != "-" else sys.stdin
    n = annotate_vcf(
        vcfin, sys.stdout, mindiff=args.mindiff, maxdiff=args.maxdiff
    )
    log.info("Annotated %d records.", n)


def plot_cmd(args):
    from .viz import bedplot, mumplot

    if len(args.fastas) == 1 and args.fastas[0].endswith(".bed"):
        # transform BED dotplot (plot.py:154-156)
        out = bedplot(
            args.fastas[0],
            output=args.output,
            interactive=args.interactive,
        )
        if out:
            log.info("Plot written to: %s", out)
        return

    out = mumplot(
        args.fastas,
        minlength=args.minlength,
        rc=not args.norc,
        maxmums=args.maxmums,
        interactive=args.interactive,
        output=args.output,
        endpoints=args.endpoints,
        showgaps=args.showgaps,
        backend=args.backend,
        xregion=args.xregion,
        yregion=args.yregion,
        flanksize=args.flanksize,
        extension=args.extension,
    )
    if out:
        log.info("Plot written to: %s", out)


def gplot_cmd(args):
    from .core.io_gfa import read_gfa
    from .viz import plotgraph

    G = read_gfa(args.graph)
    x, y = args.x, args.y
    if x is None and y is None:
        x, y = G.graph["paths"][0], G.graph["paths"][1]
    out = plotgraph(
        G,
        x,
        y,
        interactive=args.interactive,
        region=args.region,
        minlength=args.minlength,
        output=args.output,
    )
    if out:
        log.info("Plot written to: %s", out)


def matches_cmd(args):
    from .core.io_fasta import fasta_reader
    from .core.textstore import TextStore
    from .index.esa_index import ESAIndex

    ts = TextStore()
    for f in args.fastas:
        ts.add_sample(f)
        for name, seq in fasta_reader(f):
            ts.add_sequence(seq.upper())
    idx = ESAIndex.construct(ts, backend=args.backend)
    mums = idx.getmums(args.minlength)
    if args.rc:
        idx2 = ESAIndex.construct(ts, backend=args.backend, rc=True)
        mums += idx2.getmums(args.minlength)
    sys.stdout.write("#length\tpos1\tpos2\trc\n")
    for l, (sp1, sp2), isrc in mums:
        sys.stdout.write(
            "%d\t%d\t%d\t%d\n" % (l, sp1, sp2 - int(idx.nsep[0]) - 1, isrc)
        )


def _run_pipeline_script(script):
    """Execute an emitted align pipeline in ONE process (align --run):
    all stages share one device context and one build of the kernels
    instead of paying per-stage process startup and kernel loads.  The
    interpreter accepts exactly the grammar align_cmd emits: CLI lines
    of this package, one stdout redirect, 'rm -f', 'wait', and a
    trailing '&' (backgrounded chunk jobs run serially in-process)."""
    import contextlib
    import shlex

    for raw in script.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line == "wait":
            continue
        if line.endswith("&"):
            line = line.rstrip("& ")
        toks = shlex.split(line)
        if toks[:2] == ["rm", "-f"]:
            for f in toks[2:]:
                try:
                    os.remove(f)
                except FileNotFoundError:
                    pass
            continue
        assert toks[:3] == PROG.split(), (
            "unrecognized pipeline line: %s" % raw
        )
        toks = toks[3:]
        redirect = None
        if ">" in toks:
            i = toks.index(">")
            redirect = toks[i + 1]
            toks = toks[:i]
        log.info("pipeline step: %s", " ".join(toks))
        if redirect:
            with open(redirect, "w") as fh:
                with contextlib.redirect_stdout(fh):
                    main(toks)
        else:
            main(toks)


def align_cmd(args):
    """Emit the meta-pipeline shell script (align.py:6-86): optional
    per-draft transform, simultaneous or hierarchical ('sequential',
    chunked per level — chunk jobs within one level are independent and
    can run as parallel cluster jobs) rem, then unzip / refine /
    per-stage variant calls.  With --run, execute the same pipeline
    in-process instead of printing it.  Every rem and refine line ends
    in ``--device`` (before a trailing ' &')."""
    import io
    import uuid as uuidmod

    prog = PROG
    dev = " --device %s" % args.device
    run_inproc = getattr(args, "run", False)
    out = io.StringIO() if run_inproc else sys.stdout
    graphs = [args.reference[0]] if args.reference else []
    step = 0

    if args.transform and args.reference:
        step += 1
        out.write(
            "#(%d) Convert draft assemblies to graphs (address "
            "rearrangements)\n" % step
        )
        for f in args.inputfiles:
            graph = os.path.splitext(f)[0] + ".gfa"
            out.write(
                "%s transform %s %s -o %s\n"
                % (prog, args.reference[0], f, graph)
            )
            graphs.append(graph)
    else:
        graphs = (args.reference or []) + args.inputfiles

    step += 1
    out.write(
        "#(%d) Use REM to construct an anchor-based alignment graph\n" % step
    )
    tmpfiles = []
    if args.order == "sequential":
        level = 0
        while len(graphs) > 1:
            step += 1
            out.write("#(%d) Level (%d) alignments\n" % (step, level))
            n = args.chunksize
            k, m = divmod(len(graphs), n)
            if k == 0:
                chunks = [graphs]
                graphs = []
            else:
                chunks = [graphs[i * n : i * n + n] for i in range(k)]
                graphs = graphs[-m:] if m != 0 else []
            # chunk jobs within one level are independent; --parallel
            # backgrounds them with a wait barrier per level (the
            # reference README's "can be run in parallel on a compute
            # cluster", README.md:45, expressed in the emitted script)
            par = getattr(args, "parallel", False) and len(chunks) > 1
            ckpts = getattr(args, "checkpoints", False)
            for chunk in chunks:
                amp = " &" if par else ""
                if len(chunks) == 1 and graphs == []:
                    ck = (
                        " --checkpoint %s.anchors" % args.output
                        if ckpts
                        else ""
                    )
                    out.write(
                        "%s rem %s -o %s.gfa%s%s%s\n"
                        % (prog, " ".join(chunk), args.output, ck, dev, amp)
                    )
                    graphs.append(args.output + ".gfa")
                    if ckpts:
                        tmpfiles.append(args.output + ".anchors")
                else:
                    tmp = uuidmod.uuid4().hex
                    ck = " --checkpoint %s.anchors" % tmp if ckpts else ""
                    out.write(
                        "%s rem %s -o %s.gfa%s%s%s\n"
                        % (prog, " ".join(chunk), tmp, ck, dev, amp)
                    )
                    graphs.append(tmp + ".gfa")
                    tmpfiles.append(tmp + ".gfa")
                    if ckpts:
                        tmpfiles.append(tmp + ".anchors")
            if par:
                out.write("wait\n")
            level += 1
    else:  # simultaneous
        ck = (
            " --checkpoint %s.anchors" % args.output
            if getattr(args, "checkpoints", False)
            else ""
        )
        out.write(
            "%s rem %s -m%d -o %s.gfa%s%s\n"
            % (prog, " ".join(graphs), args.minlength, args.output, ck, dev)
        )
        if getattr(args, "checkpoints", False):
            tmpfiles.append(args.output + ".anchors")

    # with --checkpoints the cleanup moves to the end of the script: a
    # crash in a later stage must not delete the checkpoint/tempfiles a
    # re-run of the same script would resume from
    if tmpfiles and not getattr(args, "checkpoints", False):
        step += 1
        out.write("#(%d) Cleanup tempfiles\n" % step)
        for tmp in tmpfiles:
            out.write("rm -f %s\n" % tmp)
        tmpfiles = []

    if not args.nounzip:
        step += 1
        out.write("#(%d) Unzip all bubbles in the graph\n" % step)
        out.write("%s unzip %s.gfa -u10\n" % (prog, args.output))

    if not args.norefine:
        step += 1
        out.write(
            "#(%d) Refine all bubbles in the graph using the pair-HMM "
            "MSA\n" % step
        )
        ck = (
            " --checkpoint %s.bubbles" % args.output
            if getattr(args, "checkpoints", False)
            else ""
        )
        out.write(
            "%s refine %s.unzipped.gfa --all --maxsize=10000 --minsize=2 "
            "--mindiff=0 --minconf=%d%s -o %s.unzipped.realigned.gfa%s\n"
            % (prog, args.output, args.minconf, ck, args.output, dev)
        )

    if not args.novariants:
        step += 1
        out.write("#(%d) Output variants\n" % step)
        out.write(
            "%s variants %s.gfa --vcf > %s.anchored.vcf\n"
            % (prog, args.output, args.output)
        )
        if not args.nounzip:
            out.write(
                "%s variants %s.unzipped.gfa --vcf > %s.unzipped.vcf\n"
                % (prog, args.output, args.output)
            )
        if not args.norefine:
            out.write(
                "%s variants %s.unzipped.realigned.gfa --vcf > "
                "%s.refined.vcf\n" % (prog, args.output, args.output)
            )

    if tmpfiles:
        if getattr(args, "checkpoints", False):
            tmpfiles.append(args.output + ".bubbles")
        step += 1
        out.write("#(%d) Cleanup tempfiles and checkpoints\n" % step)
        for tmp in tmpfiles:
            out.write("rm -f %s\n" % tmp)

    if run_inproc:
        _run_pipeline_script(out.getvalue())


# ---------------------------------------------------------------------------

def build_parser():
    parser = argparse.ArgumentParser(
        prog=PROG,
        description="reveal-tpu on PyTorch/CUDA: graph-based whole-genome "
        "multi-alignment (REVEAL method).",
    )
    sub = parser.add_subparsers(dest="cmd")
    gp = _global_parser()

    p = sub.add_parser(
        "rem", parents=[gp],
        help="Recursive exact-match graph alignment on a device.",
        description="Two single-sequence fastas: native host prefix, then "
        "the device forest, and the single-root device loop for what they "
        "decline (REVEAL_TPU_DEVLOOP_MODE=full: the loop alone).  Three or "
        "more (up to 8 contig paths): the multi-genome device loop.  Every "
        "other input, and every input the multi loop declines (a segment "
        "of more than --maxmums candidates: at the default 10,000, past "
        "about 100 kbp a genome at six genomes), runs the per-level device "
        "frontier.  --checkpoint runs the serial LIFO host engine.",
    )
    p.add_argument("inputfiles", nargs="+", help="Fasta or gfa inputs.")
    _device_option(p, "the recursion")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-m", "--minlength", type=int, default=20)
    p.add_argument("-n", "--minn", type=int, default=2)
    p.add_argument("--maxmums", type=int, default=10000,
                   help="Max candidates of one segment (default 10000); "
                        "the multi loop declines a segment with more, and "
                        "the frontier takes it.")
    p.add_argument("--wpen", "--wp", type=int, default=1)
    p.add_argument("--wscore", "--ws", type=int, default=1)
    p.add_argument("--seedsize", type=int, default=0)
    p.add_argument("--pcutoff", type=float, default=1e-8)
    p.add_argument("--gcmodel", default="sumofpairs")
    p.add_argument("--maxsize", "--maxbubblesize", type=int, default=None)
    p.add_argument("--notrim", action="store_true")
    p.add_argument("--nocontigs", action="store_true",
                   help="Every fasta record is a sample of its own.")
    p.add_argument("--sa", default=None, help="Load precomputed suffix array (int64 raw).")
    p.add_argument("--lcp", default=None, help="Load precomputed LCP array (int64 raw).")
    p.add_argument("--cache", action="store_true", help="Write .reveal.{t,sa,lcp} cache files.")
    p.add_argument("--gml", action="store_true", help="Write gml instead of gfa.")
    p.add_argument("--multi", action="store_true",
                   help="Parallel-edge graph mode: keep inversion edges and "
                        "'*' original-layout paths of gfa inputs through "
                        "the alignment (the reference's MultiDiGraph mode).")
    p.add_argument("--frontier", action="store_true",
                   help="Accepted for compatibility with reveal_tpu's CLI: "
                        "the device recursion is this command's route and "
                        "is always on (with --checkpoint it is refused, as "
                        "in reveal_tpu).")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="Accepted for compatibility with reveal_tpu's CLI; "
                        "changes nothing: the device route wins over it, as "
                        "--frontier does in reveal_tpu (with --checkpoint "
                        "it is refused).  The host level-synchronous loop "
                        "is align.rem.align_genomes(frontier=False, "
                        "threads=N).")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="Anchor-decision log for checkpoint/resume, on the "
                        "one route that can resume: the serial LIFO host "
                        "engine.  Every pick is appended as it happens; if "
                        "FILE already holds records for these inputs, the "
                        "run resumes by replaying them (graph surgery "
                        "+ SA split only, no re-enumeration).")
    p.set_defaults(func=rem_cmd)

    p = sub.add_parser("bubbles", parents=[gp], help="List bubbles in a gfa graph.")
    p.add_argument("graph", nargs=1)
    p.add_argument("-e", dest="exportcomplex", action="store_true",
                   help="Export complex bubble subgraphs as gfa.")
    p.add_argument("-s", dest="separate", action="store_true",
                   help="With -e: one gfa per complex bubble.")
    p.add_argument("--gml", action="store_true",
                   help="With -e: write gml instead of gfa.")
    p.set_defaults(func=bubbles_cmd)

    p = sub.add_parser("variants", parents=[gp], help="Call variants from bubbles.")
    p.add_argument("graph", nargs=1)
    p.add_argument("--vcf", action="store_true")
    p.add_argument("--bed", action="store_true")
    p.add_argument("--fastaout", action="store_true")
    p.add_argument("--split", action="store_true",
                   help="With --fastaout: one multi-fasta file per "
                        "variant, named <source>_<sink>.fasta.")
    p.add_argument("-r", "--reference", default=None)
    p.add_argument("--minsize", type=int, default=0)
    p.add_argument("--mindiff", type=int, default=0)
    p.add_argument("--maxdiff", type=int, default=None)
    p.add_argument("--type", default="all")
    p.add_argument("--nogaps", action="store_true")
    p.add_argument("--minflank", type=int, default=0)
    p.add_argument("--refonly", action="store_true")
    p.set_defaults(func=variants_cmd)

    for name in ("refine", "realign"):
        p = sub.add_parser(name, parents=[gp], help="Realign bubbles with the pair-HMM MSA.")
        p.add_argument("graph", nargs=1)
        _device_option(p, "the pair posteriors and, on cuda, of the "
                       "consistency transform")
        p.add_argument("--all", action="store_true")
        p.add_argument("--complex", action="store_true")
        p.add_argument("--simple", action="store_true")
        p.add_argument("-o", "--outfile", default=None)
        p.add_argument("-m", "--minlength", type=int, default=20)
        p.add_argument("--minsize", type=int, default=None)
        p.add_argument("--mindiff", type=int, default=0)
        p.add_argument("--maxdiff", type=int, default=None)
        p.add_argument("--maxsize", type=int, default=10000)
        p.add_argument("--maxcumsize", type=int, default=None)
        p.add_argument("--mincumsize", type=int, default=0)
        p.add_argument("--nogaps", action="store_true")
        p.add_argument("--minconf", type=int, default=0)
        p.add_argument("--constrans", type=int, default=2)
        p.add_argument("--consgap", action="store_true", default=False)
        p.add_argument("--nrefinements", type=int, default=100)
        p.add_argument(
            "--logadd-compat", dest="logadd_compat", action="store_true",
            help="ProbCons' float32 LOG_ADD lookup-table arithmetic for "
                 "every posterior, pair by pair on the host (slow; for "
                 "bit-equivalence attempts with ProbCons).",
        )
        p.add_argument("--uniqueonly", action="store_true")
        p.add_argument("--nproc", type=int, default=0,
                       help="Worker processes for the per-bubble MSA "
                            "phase (forked after the device stages; host "
                            "work only); default serial.")
        p.add_argument("--method", default="reveal_probcons",
                       choices=["reveal_probcons", "reveal_rem", "muscle",
                                "probcons", "msaprobs", "pecan"],
                       help="Bubble realignment method: the built-in "
                            "pair-HMM MSA (reveal_probcons, default), the "
                            "host anchor aligner (reveal_rem), or an "
                            "external aligner from $PATH.")
        p.add_argument("--params", dest="parameters", default="",
                       help="Extra parameters for external MSA tools.")
        p.add_argument("--checkpoint", default=None, metavar="FILE",
                       help="Per-bubble result log for checkpoint/"
                            "resume: each bubble's realignment is "
                            "appended as it completes; re-running with "
                            "the same FILE skips finished bubbles "
                            "(their pairs never join the device batch) "
                            "and splices the stored results.")
        p.add_argument("--wp", dest="wpen", type=int, default=1,
                       help="Chaining penalty weight (reveal_rem).")
        p.add_argument("--ws", dest="wscore", type=int, default=1,
                       help="Chaining score weight (reveal_rem).")
        p.set_defaults(func=refine_cmd)

    p = sub.add_parser("unzip", parents=[gp], help="Unzip bubbles (indel wiggle).")
    p.add_argument("graph", nargs=1)
    p.add_argument("-u", "--minunzip", type=int, default=0)
    p.add_argument("--mindiff", type=int, default=0)
    p.add_argument("--maxdiff", type=int, default=None)
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(func=unzip_cmd)

    p = sub.add_parser("extract", parents=[gp], help="Extract path sequence from graph.")
    p.add_argument("graph")
    p.add_argument("input", nargs="*")
    p.add_argument("-t", "--type", default="pathname",
                   choices=["pathname", "path"],
                   help="pathname, or a comma-separated node-id walk "
                        "like 1+,2-,3+.")
    p.add_argument("--all", action="store_true",
                   help="Extract every path in the graph.")
    p.add_argument("--nocycles", action="store_true",
                   help="Accepted for reference compatibility: the "
                        "DiGraph reader always ignores structural "
                        "(cycle-forming) edges.")
    p.add_argument("--width", type=int, default=100)
    p.set_defaults(func=extract_cmd)

    p = sub.add_parser("split", parents=[gp], help="Split graph into connected components.")
    p.add_argument("graph", nargs=1)
    p.set_defaults(func=split_cmd)

    p = sub.add_parser("merge", parents=[gp], help="Merge gfa graphs into one file.")
    p.add_argument("graphs", nargs="+")
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(func=merge_cmd)

    p = sub.add_parser("comp", parents=[gp], help="Reverse complement a graph.")
    p.add_argument("graph", nargs=1)
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(func=comp_cmd)

    p = sub.add_parser("subgraph", parents=[gp], help="Export a node-set subgraph.")
    p.add_argument("inputfiles", nargs="+", help="<graph.gfa> <node ids...>")
    p.add_argument("-o", "--outfile", default="subgraph.gfa")
    p.set_defaults(func=subgraph_cmd)

    p = sub.add_parser("stats", parents=[gp], help="Graph statistics.")
    p.add_argument("graph", nargs=1)
    p.set_defaults(func=stats_cmd)

    p = sub.add_parser("align", parents=[gp], help="Emit the full align pipeline as a shell script.")
    p.add_argument("inputfiles", nargs="+")
    _device_option(p, "every rem and refine stage")
    p.add_argument("-r", "--reference", nargs=1, default=None,
                   help="Reference for per-draft transform step.")
    p.add_argument("--transform", action="store_true")
    p.add_argument("--order", default="simultaneous",
                   choices=["simultaneous", "sequential"])
    p.add_argument("--chunksize", type=int, default=2)
    p.add_argument("--parallel", action="store_true",
                   help="Background the independent chunk jobs of each "
                        "sequential level with a wait barrier between "
                        "levels (reference README.md:45).")
    p.add_argument("--checkpoints", action="store_true",
                   help="Give every rem job and the refine stage a "
                        "--checkpoint file so re-running the SAME "
                        "emitted script after a crash or preemption "
                        "resumes each stage instead of recomputing it "
                        "(rem then runs the serial LIFO host engine); "
                        "chunk checkpoint files are removed with their "
                        "tempfiles.")
    p.add_argument("--run", action="store_true",
                   help="Execute the pipeline in-process instead of "
                        "printing the script: one device context and one "
                        "build of the kernels across all stages (chunk "
                        "jobs run serially; combine with --checkpoints "
                        "for resumability).")
    p.add_argument("-m", "--minlength", type=int, default=20)
    p.add_argument("--minconf", type=int, default=0)
    p.add_argument("--nounzip", action="store_true")
    p.add_argument("--norefine", action="store_true")
    p.add_argument("--novariants", action="store_true")
    p.add_argument("-o", "--output", default="prg")
    p.set_defaults(func=align_cmd)

    p = sub.add_parser("chop", parents=[gp], help="Overlap graph for k-length read mapping.")
    p.add_argument("graph", nargs=1)
    p.add_argument("-k", type=int, default=100)
    p.add_argument("--noextend", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(func=chop_cmd)

    p = sub.add_parser("plot", parents=[gp], help="MUM dotplot of two fasta files.")
    p.add_argument("fastas", nargs="+")
    p.add_argument("-m", "--minlength", type=int, default=20)
    p.add_argument("--norc", action="store_true")
    p.add_argument("--maxmums", type=int, default=10000)
    p.add_argument("-i", "--interactive", action="store_true")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--endpoints", action="store_true")
    p.add_argument("--showgaps", action="store_true")
    p.add_argument("-r", "--xr", dest="xregion", default=None,
                   help="Zoom regions on the x axis: <s1>-<e1>,<s2>-<e2>.")
    p.add_argument("--yr", dest="yregion", default=None,
                   help="Zoom regions on the y axis.")
    p.add_argument("--flanksize", default=None,
                   help="Flanking bases per region: <f1>,<f2>,...")
    p.add_argument("--extension", default="png",
                   choices=["png", "pdf", "ps", "eps", "svg"])
    _device_option(p, "the suffix-array build of --backend jax or jax-dist")
    p.set_defaults(func=plot_cmd)

    p = sub.add_parser("gplot", parents=[gp], help="Dotplot from a graph's shared nodes.")
    p.add_argument("graph")
    p.add_argument("-x", default=None)
    p.add_argument("-y", default=None)
    p.add_argument("-m", "--minlength", type=int, default=1)
    p.add_argument("-i", "--interactive", action="store_true")
    p.add_argument("-r", "--region", default=None)
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(func=gplot_cmd)

    p = sub.add_parser("matches", parents=[gp], help="Print MUMs between two fastas.")
    p.add_argument("fastas", nargs=2)
    p.add_argument("-m", "--minlength", type=int, default=20)
    p.add_argument("--rc", action="store_true")
    _device_option(p, "the suffix-array build of --backend jax or jax-dist")
    p.set_defaults(func=matches_cmd)

    p = sub.add_parser("transform", parents=[gp], help="Layout draft contigs against a reference (breakpoint graph).")
    p.add_argument("reference", nargs=1)
    p.add_argument("contigs", nargs="+")
    p.add_argument("-m", "--minlength", type=int, default=65)
    p.add_argument("-c", "--minctglength", type=int, default=1000)
    p.add_argument("--cutn", type=int, default=1000)
    p.add_argument("--nocluster", action="store_true")
    p.add_argument("--maxdist", type=int, default=90)
    p.add_argument("--mincluster", type=int, default=65)
    p.add_argument("--rearrangecost", type=int, default=1000)
    p.add_argument("--inversioncost", type=int, default=1)
    p.add_argument("--lambda", dest="_lambda", type=float, default=5)
    p.add_argument("--eps", type=float, default=1)
    p.add_argument("--alfa", type=float, default=1)
    p.add_argument("--gapopen", type=int, default=10)
    p.add_argument("--heap", dest="useheap", action="store_true")
    p.add_argument("--lastn", type=int, default=50)
    p.add_argument("--lastbp", type=int, default=10000)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--minchainsum", type=int, default=65)
    p.add_argument("--nooptimise", action="store_true")
    p.add_argument("--nobed", action="store_true")
    p.add_argument("-o", "--output", default=None)
    _device_option(p, "the suffix-array build of --backend jax or jax-dist")
    p.set_defaults(func=transform_cmd)

    p = sub.add_parser("finish", parents=[gp], help="Order/orient draft contigs into pseudomolecules.")
    p.add_argument("reference")
    p.add_argument("contigs")
    p.add_argument("-m", "--minlength", type=int, default=15,
                   help="Min MUM length (0 = auto by coverage).")
    p.add_argument("--cutn", type=int, default=1000)
    p.add_argument("--maxdist", type=int, default=90)
    p.add_argument("--mincluster", type=int, default=20)
    p.add_argument("--order", default="contigs",
                   choices=["contigs", "chains"],
                   help="Layout whole contigs, or decomposed chains "
                        "(splits chimeric contigs).")
    p.add_argument("--mineventsize", type=int, default=1500)
    p.add_argument("--minchainsum", type=int, default=1000)
    p.add_argument("--maxmums", type=int, default=0,
                   help="Max MUMs per chain DP (0 = all).")
    p.add_argument("--extiter", type=int, default=3,
                   help="Local-MUM cluster extension iterations.")
    p.add_argument("--maxextend", type=int, default=200)
    p.add_argument("--ml", dest="minlocallength", type=int, default=20)
    p.add_argument("--graph", dest="outputtype", action="store_const",
                   const="graph", default="fasta",
                   help="Emit a GFA breakpoint graph instead of fasta.")
    p.add_argument("--allcontigs", action="store_true", default=True)
    p.add_argument("--fixedgapsize", type=int, default=None,
                   help="Deprecated alias: implies --fixedsize --gapsize N.")
    p.add_argument("--fixedsize", action="store_true", default=False)
    p.add_argument("--gapsize", type=int, default=100)
    p.add_argument("--split", action="store_true",
                   help="One fasta file per pseudomolecule.")
    p.add_argument("--nounplaced", action="store_true")
    p.add_argument("-o", "--output", default=None)
    _device_option(p, "the suffix-array build of --backend jax or jax-dist")
    p.set_defaults(func=finish_cmd)

    p = sub.add_parser("convert", parents=[gp], help="Convert gfa<->gml/maf, fasta->gfa.")
    p.add_argument("graphs", nargs="+")
    p.add_argument("--type", default="gfa", choices=["gfa", "gml", "maf"])
    p.add_argument("--aligned", action="store_true", help="Treat fasta input as a pre-computed MSA.")
    p.set_defaults(func=convert_cmd)

    p = sub.add_parser("rearrangements", parents=[gp], help="Report structural rearrangement edges.")
    p.add_argument("graph", nargs=1)
    p.add_argument("-r", "--reference", default=None)
    p.set_defaults(func=rearrangements_cmd)

    p = sub.add_parser("chain", parents=[gp], help="Graph construction by global multiMUM chaining.")
    p.add_argument("fastas", nargs="+")
    p.add_argument("-m", "--minlength", type=int, default=20)
    p.add_argument("-n", "--minn", type=int, default=2)
    p.add_argument("--maxmums", type=int, default=10000)
    p.add_argument("--norecurse", action="store_true")
    p.add_argument("--gcmodel", default="sumofpairs")
    p.add_argument("--wpen", "--wp", type=int, default=1)
    p.add_argument("--wscore", "--ws", type=int, default=1)
    p.add_argument("-o", "--output", default=None)
    _device_option(p, "the suffix-array build of --backend jax or jax-dist")
    p.set_defaults(func=chain_cmd)

    p = sub.add_parser("annotate", parents=[gp], help="Add repeat classification to VCF records.")
    p.add_argument("vcf")
    p.add_argument("--mindiff", type=int, default=0)
    p.add_argument("--maxdiff", type=int, default=None,
                   help="Skip records whose allele difference is >= this.")
    p.add_argument("--species", default="human",
                   help="RepeatMasker -species flag (used only when "
                        "RepeatMasker is on PATH).")
    p.add_argument("--nproc", type=int, default=1,
                   help="RepeatMasker -pa processes (only with "
                        "RepeatMasker on PATH).")
    p.set_defaults(func=annotate_cmd)
    return parser


def _profiled(profiledir):
    """``torch.profiler`` over the whole command, its trace written into
    ``profiledir`` when the command ends."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(profiledir),
    )


def main(argv=None):
    import contextlib

    from .core import trace
    from .index.suffix import build_device

    logging.addLevelName(TRACE, "TRACE")
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "cmd", None):
        parser.print_help()
        return 1

    logging.basicConfig(
        level=args.loglevel,
        format="%(asctime)-15s %(levelname)s: %(message)s",
    )
    profiledir = getattr(args, "profiledir", None)
    trace_cm = (_profiled(profiledir) if profiledir
                else contextlib.nullcontext())
    # a profiled command carries its stage spans
    was_on = trace.enable(True) if profiledir else trace.ON
    trace.begin()
    try:
        with trace_cm, build_device(getattr(args, "device", "cuda")):
            return args.func(args) or 0
    except BrokenPipeError:
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0
    finally:
        trace.enable(was_on)


if __name__ == "__main__":
    sys.exit(main())
