"""Time the pair-HMM DP kernels of one or several checkouts on one card.

    python3 scripts/torch_pairhmm_time.py TREE [TREE ...]

Each TREE is the root of a checkout that holds ``reveal_tpu_torch`` (for
example the parent commit unpacked by ``git archive`` beside the working
tree).  The trees are timed in the order given, each in a process of its
own (it builds its own kernels), so ``parent . . parent`` compares two
versions in turns within one run.  Shapes: B=128 of 300-512 bp (513 x
640) and B=32 of 1100-2048 bp (2049 x 2176), the pairs ``chip_smoke.py``
times, made from the same seed.  Prints per call times from CUDA events
beside the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys


def _one(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import chip_smoke
    from reveal_tpu_torch.hmm import pairhmm_dp as dp
    from reveal_tpu_torch.hmm.pairhmm import default_params

    dev = torch.device("cuda")
    params = default_params(dev)
    rng = np.random.default_rng(7)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    for name, pairs, iters in (
            ("B=128 513x640", chip_smoke._related_pairs(rng, 128, 300, 512),
             20),
            ("B=32 2049x2176", chip_smoke._related_pairs(rng, 32, 1100, 2048),
             10)):
        (batch,) = list(dp.batches(pairs, dev))
        _L1p, _L2p, _idxs, x, y, lx, ly = batch
        xcls, ycls = dp._prep(x, y)
        xr, yr = dp._prep(dp._reverse_within(x, lx),
                          dp._reverse_within(y, ly))

        def kf():
            dp.fwd_dp(xcls, ycls, lx, params)

        def kb():
            dp.bwd_dp(xr, yr, lx, ly, params)

        kf(), kb()
        tf = (chip_smoke._event_ms(kf, iters)
              + chip_smoke._event_ms(kf, iters)) / 2
        tb = (chip_smoke._event_ms(kb, iters)
              + chip_smoke._event_ms(kb, iters)) / 2
        print("%s | tree %s | %s: fwd %.6f ms, bwd %.6f ms (x%d, twice)"
              % (smi, tree, name, tf, tb, iters), flush=True)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        _one(sys.argv[2])
        return
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree], check=True)


if __name__ == "__main__":
    main()
