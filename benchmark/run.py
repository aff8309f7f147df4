"""Run one cell of the benchmark of ``reveal_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result (JSON); the numbers
compared against the plain reference close standard error.  The cells
are the ``workloads`` of ``BENCHMARK.json``.  Exits non-zero, printing no
result, when there is no card, when the program is missing, or when the
run loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed places inside the checkout, so that
# only a cell's first run in a checkout builds
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    return harness.main(args, ROOT)


if __name__ == "__main__":
    # the checkout's root in place of this script's folder
    sys.path[0] = ROOT
    sys.exit(main())
