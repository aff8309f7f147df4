"""Measurements behind the pair-HMM DP kernels' choices, on one CUDA card.

    python3 scripts/torch_pairhmm_tune.py plans   # the launch plan's options
    python3 scripts/torch_pairhmm_tune.py sass    # instructions per kernel

``plans`` times both kernels under either strip width
``pairhmm_dp.make_plan`` takes, at the shapes ``refine`` launches and at
two with few rows under wide columns, and marks the plan ``launch_plan``
picks: the table its rule and its test are taken from.
``sass`` disassembles the built library with ``cuobjdump`` and counts each
kernel's instructions, its MUFU (exp/log) instructions among them.  The
card's name and power limit stand once at the top; times are per call from
CUDA events.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from reveal_tpu_torch.hmm import pairhmm_dp as dp  # noqa: E402
from reveal_tpu_torch.hmm.pairhmm import default_params  # noqa: E402
from reveal_tpu_torch.kernels import build  # noqa: E402


def _batch(pairs, dev):
    (batch,) = list(dp.batches(pairs, dev))
    L1p, L2p, _idxs, x, y, lx, ly = batch
    xcls, ycls = dp._prep(x, y)
    xr, yr = dp._prep(dp._reverse_within(x, lx), dp._reverse_within(y, ly))
    return L1p, L2p, x, y, lx, ly, xcls, ycls, xr, yr


def _times(plan, xcls, ycls, xr, yr, lx, ly, params, iters):
    def kf():
        dp._launch_fwd(plan, xcls, ycls, lx, params)

    def kb():
        dp._launch_bwd(plan, xr, yr, lx, ly, params)

    kf(), kb()
    return (chip_smoke._event_ms(kf, iters), chip_smoke._event_ms(kb, iters))


def run_plans(dev):
    params = default_params(dev)
    rng = np.random.default_rng(11)
    # (pairs, x lengths, y lengths); the last two are short x against wide
    # y, where a chain of panels is longer than the rows that feed it
    shapes = [(128, (300, 512), None), (32, (1100, 2048), None),
              (960, (300, 512), None), (120, (1100, 2048), None),
              (60, (520, 1000), None), (1024, (2, 12), None),
              (2, 48, (5000, 6000)), (64, 30, (1100, 2048))]
    for B, xlen, ylen in shapes:
        if ylen is None:
            lo, hi = xlen
            pairs = chip_smoke._related_pairs(rng, B, lo, hi)
            top = dp.bucket_key("A" * hi, "A" * hi)
        else:
            pairs = [(a[:xlen], b) for a, b in
                     chip_smoke._related_pairs(rng, B, *ylen)]
            top = dp.bucket_key("A" * xlen, "A" * ylen[1])
        # one bucket: the pairs whose lengths reach the top bucket
        pairs = [(a, b) for a, b in pairs if dp.bucket_key(a, b) == top]
        L1p, L2p, _x, _y, lx, ly, xcls, ycls, xr, yr = _batch(pairs, dev)
        nb = len(pairs)
        chosen = dp.launch_plan(nb, L1p, L2p)
        for C in dp.PLAN_COLUMNS:
            plan = dp.make_plan(nb, L1p, L2p, C)
            tf, tb = _times(plan, xcls, ycls, xr, yr, lx, ly, params, 5)
            mark = " <- launch_plan" if C == chosen["C"] else ""
            print("plan B=%-4d %dx%d C=%-2d G=%-2d P=%-3d blocks=%-5d: "
                  "fwd %.6f ms, bwd %.6f ms, sum %.6f%s"
                  % (nb, L1p, L2p, C, plan["G"], plan["P"], plan["blocks"],
                     tf, tb, tf + tb, mark))


def run_sass():
    import collections
    import re

    exe = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([exe, "-sass", build.build()], check=True,
                          capture_output=True, text=True).stdout
    counts = collections.OrderedDict()
    name = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)",
                     line)
        if m and name:
            counts[name][m.group(1)] += 1
    for name, c in counts.items():
        short = re.sub(r".*?(pairhmm_..._kernelILi\d+E|window_resolve_kernel)"
                       r".*", r"\1", name)
        print("sass %-32s %5d instructions, %3d MUFU, %3d FADD+FMUL+FFMA+"
              "FMNMX, %2d SHFL, %2d LDG, %2d STG"
              % (short, sum(c.values()), c["MUFU"],
                 c["FADD"] + c["FMUL"] + c["FFMA"] + c["FMNMX"], c["SHFL"],
                 c["LDG"], c["STG"]))


def main():
    if len(sys.argv) != 2 or sys.argv[1] not in ("plans", "sass"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("torch_pairhmm_tune: no CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    if sys.argv[1] == "plans":
        run_plans(torch.device("cuda"))
    else:
        run_sass()


if __name__ == "__main__":
    main()
