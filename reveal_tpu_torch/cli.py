"""Command line of the torch port.

    python -m reveal_tpu_torch.cli rem A.fa B.fa [--frontier] \\
        [--device cuda|cpu] [-m MINLENGTH] [-o out.gfa]

Pairwise ``rem --frontier`` (the flag is accepted and always on): the
residual recursion runs on ``--device`` (default ``cuda``; without a
card that is an error, never a quiet switch to the CPU).  The GFA and the identity log line are those of
``python -m reveal_tpu.cli rem``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

log = logging.getLogger(__name__)


def rem_cmd(args):
    from reveal_tpu.core.io_gfa import seq2node, write_gfa

    from .align.rem import align_genomes

    G, idx = align_genomes(
        args.inputfiles,
        device=args.device,
        minlength=args.minlength,
    )
    if args.output is None:
        pref = []
        for f in args.inputfiles:
            bn = os.path.basename(f)
            pref.append(bn[: bn.find(".")] if "." in bn else bn)
        args.output = "_".join(pref) + ".gfa.gz"

    T = idx.main.T
    seq2node(G, T)
    # identity stats (reveal_tpu/cli.py rem_cmd, pairwise case)
    totbases = (
        idx.main.nT
        - int((T == ord("$")).sum())
        - int((T == ord("N")).sum())
        - int((T == ord("n")).sum())
    )
    alignedbases = alignednodes = 0
    for n, d in G.nodes.items():
        if isinstance(n, str) or d.get("aligned", 0) == 0:
            continue
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


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m reveal_tpu_torch.cli",
        description="reveal-tpu on PyTorch/CUDA (pairwise rem --frontier)",
    )
    p.add_argument(
        "-l", "--log-level", dest="loglevel", type=int, default=20,
        help="Log level: 10=debug 20=info 30=warn 40=error.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("rem", help="Align two fasta files into a GFA.")
    r.add_argument("inputfiles", nargs="+", help="Two fasta files.")
    r.add_argument(
        "--frontier", action="store_true",
        help="Accepted for compatibility with reveal_tpu's CLI; the "
        "level-synchronous device recursion is this package's only route "
        "and is always on.",
    )
    r.add_argument(
        "--device", default="cuda",
        help="Torch device of the forest recursion: cuda (default) or cpu.",
    )
    r.add_argument(
        "-m", dest="minlength", type=int, default=20,
        help="Min length of an exact match (default 20).",
    )
    r.add_argument("-o", "--output", dest="output", default=None,
                   help="Output GFA (default: <a>_<b>.gfa.gz).")
    r.set_defaults(func=rem_cmd)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.loglevel, format="%(asctime)s %(levelname)s %(message)s"
    )
    return args.func(args)


if __name__ == "__main__":
    main(sys.argv[1:])
