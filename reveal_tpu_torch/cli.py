"""Command line of the torch port.

    python -m reveal_tpu_torch.cli rem A.fa|A.gfa B.fa|B.gfa [C ...] \\
        [--frontier] [--device cuda|cpu] [-m MINLENGTH] [-n MINN] \\
        [--maxmums N] [--wpen W] [--wscore W] [--seedsize S] \\
        [--pcutoff P] [--gcmodel M] [--maxsize N] [--notrim] [--multi] \\
        [-o out.gfa]
    python -m reveal_tpu_torch.cli refine G.gfa --all|--simple|--complex \\
        [--device cuda|cpu] [-o out.gfa] [refine options]

``rem --frontier`` (the flag is accepted and always on) runs the
recursion on ``--device`` (default ``cuda``; without a card that is an
error, never a quiet switch to the CPU): two single-sequence fastas
through the native host prefix and the device forest (what they decline,
and with ``REVEAL_TPU_DEVLOOP_MODE=full`` every such pair, through the
single-root device loop), three or more (up to 8 contig paths) through
the multi-genome device loop, and every other input (``.gfa`` inputs, multi-contig pairs, ``--notrim``, ``--seedsize``,
``--gcmodel``, ``--maxsize``) through the per-level device frontier.  An
input the multi loop declines (a segment with more than ``--maxmums``
candidates, which bacterial-scale inputs have at the default of 10,000,
more than 8 paths, or a capacity it cannot meet) goes to the per-level
frontier on the same device, as in ``reveal_tpu``; so does a pair the
single-root loop declines.  The GFA and the
identity log line are those of ``python -m reveal_tpu.cli rem``.

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
Its options and its output are those of ``python -m reveal_tpu.cli
refine``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

log = logging.getLogger(__name__)


def rem_cmd(args):
    from .align.graphops import prune_nodes
    from .align.rem import align_genomes
    from .core.io_gfa import seq2node, write_gfa

    G, idx = align_genomes(
        args.inputfiles,
        device=args.device,
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
        multi=args.multi,
    )
    if args.output is None:
        pref = []
        for f in args.inputfiles:
            bn = os.path.basename(f)
            pref.append(bn[: bn.find(".")] if "." in bn else bn)
        args.output = "_".join(pref) + ".gfa.gz"

    T = idx.main.T
    if len(G.graph["paths"]) > 2:
        prune_nodes(G, T=T)
    seq2node(G, T)
    # identity stats (reveal_tpu/cli.py rem_cmd)
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
    out = write_gfa(G, T, outputfile=args.output)
    log.info("Graph written to: %s", out)
    return out


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
    return out


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m reveal_tpu_torch.cli",
        description="reveal-tpu on PyTorch/CUDA (rem --frontier, refine)",
    )
    p.add_argument(
        "-l", "--log-level", dest="loglevel", type=int, default=20,
        help="Log level: 10=debug 20=info 30=warn 40=error.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser(
        "rem", help="Align two or more fasta or gfa files into a GFA.",
        description="Two single-sequence fastas: native host prefix, then "
        "the device forest, and the single-root device loop for what they "
        "decline (REVEAL_TPU_DEVLOOP_MODE=full: the loop alone).  Three or "
        "more (up to 8 contig paths): the "
        "multi-genome device loop.  Every other input, and every input the "
        "multi loop declines (a segment of more than --maxmums "
        "candidates: at the default 10,000, past about 100 kbp a genome "
        "at six genomes), runs the per-level device frontier.",
    )
    r.add_argument("inputfiles", nargs="+",
                   help="Two or more fasta or gfa inputs.")
    r.add_argument(
        "--frontier", action="store_true",
        help="Accepted for compatibility with reveal_tpu's CLI; the "
        "level-synchronous device recursion is this package's only route "
        "and is always on.",
    )
    r.add_argument(
        "--device", default="cuda",
        help="Torch device of the recursion: cuda (default) or cpu.",
    )
    r.add_argument(
        "-m", "--minlength", dest="minlength", type=int, default=20,
        help="Min length of an exact match (default 20).",
    )
    r.add_argument("-n", "--minn", type=int, default=2,
                   help="Min number of samples a multiMUM spans (default 2).")
    r.add_argument("--maxmums", type=int, default=10000,
                   help="Max candidates of one segment (default 10000); "
                        "the multi loop declines a segment with more, and "
                        "the frontier takes it.")
    r.add_argument("--wpen", "--wp", type=int, default=1,
                   help="Chaining gap-penalty weight (default 1).")
    r.add_argument("--wscore", "--ws", type=int, default=1,
                   help="Chaining match-score weight (default 1).")
    r.add_argument("--seedsize", type=int, default=0,
                   help="Seed anchors of at least this length first "
                        "(default 0: off).")
    r.add_argument("--pcutoff", type=float, default=1e-8,
                   help="P-value cutoff of an anchor (default 1e-8).")
    r.add_argument("--gcmodel", default="sumofpairs",
                   help="Gap-cost model of the chain (default "
                        "sumofpairs).")
    r.add_argument("--maxsize", "--maxbubblesize", type=int, default=None,
                   help="Do not align segments larger than this.")
    r.add_argument("--notrim", action="store_true",
                   help="Do not trim overlapping anchors of a chain.")
    r.add_argument("--multi", action="store_true",
                   help="Parallel-edge graph mode: keep inversion edges "
                        "and '*' original-layout paths of gfa inputs "
                        "through the alignment.")
    r.add_argument("-o", "--output", dest="output", default=None,
                   help="Output GFA (default: <a>_<b>.gfa.gz).")
    r.set_defaults(func=rem_cmd)

    for name in ("refine", "realign"):
        p2 = sub.add_parser(
            name, help="Realign bubbles with the pair-HMM MSA."
        )
        p2.add_argument("graph", nargs=1)
        p2.add_argument(
            "--device", default="cuda",
            help="Torch device of the pair posteriors and, on cuda, of the "
            "consistency transform: cuda (default) or cpu.",
        )
        p2.add_argument("--all", action="store_true")
        p2.add_argument("--complex", action="store_true")
        p2.add_argument("--simple", action="store_true")
        p2.add_argument("-o", "--outfile", default=None)
        p2.add_argument("-m", "--minlength", type=int, default=20)
        p2.add_argument("--minsize", type=int, default=None)
        p2.add_argument("--mindiff", type=int, default=0)
        p2.add_argument("--maxdiff", type=int, default=None)
        p2.add_argument("--maxsize", type=int, default=10000)
        p2.add_argument("--maxcumsize", type=int, default=None)
        p2.add_argument("--mincumsize", type=int, default=0)
        p2.add_argument("--nogaps", action="store_true")
        p2.add_argument("--minconf", type=int, default=0)
        p2.add_argument("--constrans", type=int, default=2)
        p2.add_argument("--consgap", action="store_true", default=False)
        p2.add_argument("--nrefinements", type=int, default=100)
        p2.add_argument(
            "--logadd-compat", dest="logadd_compat", action="store_true",
            help="ProbCons' float32 LOG_ADD lookup-table arithmetic for "
                 "every posterior, pair by pair on the host (slow; for "
                 "bit-equivalence attempts with ProbCons).",
        )
        p2.add_argument("--uniqueonly", action="store_true")
        p2.add_argument("--nproc", type=int, default=0,
                        help="Worker processes for the per-bubble MSA "
                             "phase (forked after the device stages; host "
                             "work only); default serial.")
        p2.add_argument("--method", default="reveal_probcons",
                        choices=["reveal_probcons", "reveal_rem", "muscle",
                                 "probcons", "msaprobs", "pecan"],
                        help="Bubble realignment method: the built-in "
                             "pair-HMM MSA (reveal_probcons, default), the "
                             "host anchor aligner (reveal_rem), or an "
                             "external aligner from $PATH.")
        p2.add_argument("--params", dest="parameters", default="",
                        help="Extra parameters for external MSA tools.")
        p2.add_argument("--checkpoint", default=None, metavar="FILE",
                        help="Per-bubble result log for checkpoint/"
                             "resume: each bubble's realignment is "
                             "appended as it completes; re-running with "
                             "the same FILE skips finished bubbles "
                             "(their pairs never join the device batch) "
                             "and splices the stored results.")
        p2.add_argument("--wp", dest="wpen", type=int, default=1,
                        help="Chaining penalty weight (reveal_rem).")
        p2.add_argument("--ws", dest="wscore", type=int, default=1,
                        help="Chaining score weight (reveal_rem).")
        p2.set_defaults(func=refine_cmd)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.loglevel, format="%(asctime)s %(levelname)s %(message)s"
    )
    return args.func(args)


if __name__ == "__main__":
    main(sys.argv[1:])
