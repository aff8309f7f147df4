"""The control of the check: the plain reference with one stated guarantee
broken, put in the program's place, has to come out as not correct.

The configurations state ``trim: true`` among their options: overlapping
anchor candidates are trimmed before the chain (REVEAL's default, and a
step a faster program might be tempted to skip).  The control is the
reference run with the configuration's options but ``trim`` false; its
output is held to the reference's by the same comparison as the
program's (``compare.judge``).

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

prints one line a seed with the numbers compared and, last, a JSON object
with the smallest reading of each number over the seeds.  It runs on the
host only (NumPy), the seeds in parallel processes.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_reading(cell_name, seed, root=ROOT, size=None):
    """(seed, {number: value}, seconds) of the control against the
    reference on the cell's input from ``seed``; ``size`` overrides the
    configuration's ``genome_bp`` (for tests)."""
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import cells, commands, compare, genomes

    cell = cells.Cell(cell_name, root)
    config = dict(cell.config)
    if size:
        config["genome_bp"] = size
    workdir = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        fastas, _bases = genomes.write_inputs(config, cell.traffic, seed,
                                              workdir)
        command = commands.load(cell.traffic["command"])
        options = dict(cell.config.get("options", {}))
        t0 = time.perf_counter()
        want = command.reference(fastas, os.path.join(
            workdir, "ref" + command.OUTPUT), options)
        got = command.reference(fastas, os.path.join(
            workdir, "ctl" + command.OUTPUT), dict(options, trim=False))
        checks = compare.judge([(compare.text_of(got), 1,
                                 compare.text_of(want))])
        return seed, {k: v for k, (v, _lim) in checks.items()}, (
            time.perf_counter() - t0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--procs", type=int, default=4)
    args = p.parse_args(argv)
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(min(args.procs, len(args.seeds)))
    try:
        res = pool.starmap(control_reading,
                           [(args.workload, s) for s in args.seeds])
    finally:
        pool.close()
        pool.join()
    least = {}
    for seed, nums, sec in res:
        print("control %s seed %d: %s (%.1f s)" % (
            args.workload, seed, " ".join("%s %s" % kv for kv in
                                          nums.items()), sec))
        for k, v in nums.items():
            least[k] = min(least.get(k, v), v)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "least": least}))
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
