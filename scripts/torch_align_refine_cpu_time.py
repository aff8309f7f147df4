"""Time ``refine --device cpu`` on the unzipped graph of ``align``'s main case.

    python3 scripts/torch_align_refine_cpu_time.py [--seed 1] [--length 100000]

Writes ``simulate_population(6, length, seed)`` (``chip_smoke.py`` phase 7
(a)'s genomes) into a temporary directory, builds their GFA with the
port's host engine, unzips it (``unzip -u10``) and times the refine stage
of ``align`` on the CPU (``refine --all --maxsize=10000 --minsize=2
--mindiff=0 --minconf=0 --device cpu``).  Prints the seconds of each step,
refine's stage split and the process's peak resident memory.  This is
the run ``chip_smoke.py`` would need to hold the card's refined graph
byte for byte against the CPU's.
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--length", type=int, default=100_000)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    from reveal_tpu_torch import cli
    from reveal_tpu_torch.hmm import refine

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=root, prefix=".smoke_") as wd:
        fastas, _bp, _want = chip_smoke.write_population(6, args.length,
                                                         args.seed, wd)
        t_rem = chip_smoke.host_gfa(fastas, os.path.join(wd, "prg.gfa"))
        os.chdir(wd)
        try:
            t0 = time.perf_counter()
            cli.main(["unzip", "prg.gfa", "-u10"])
            t_unzip = time.perf_counter() - t0
            t0 = time.perf_counter()
            cli.main(["refine", "prg.unzipped.gfa", "--all",
                      "--maxsize=10000", "--minsize=2", "--mindiff=0",
                      "--minconf=0", "--device", "cpu", "-o",
                      "prg.unzipped.realigned.gfa"])
            t_refine = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    st = refine.LAST_STATS
    print("6 x %d bp, seed %d, %d CPUs: host-engine rem %.6f s, unzip %.6f "
          "s, refine --device cpu %.6f s (%d bubbles, route %s; extract "
          "%.6f s, stage 1 %.6f s, host MSA %.6f s, splice %.6f s); peak "
          "resident memory %.1f MiB"
          % (args.length, args.seed, os.cpu_count(), t_rem, t_unzip,
             t_refine, st["bubbles"], st["route"], st["extract_seconds"],
             st["stage1_seconds"], st["msa_seconds"], st["splice_seconds"],
             resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024))


if __name__ == "__main__":
    main()
