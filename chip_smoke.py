"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py [--seed 1] [--length 2000000]

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card's name and power limit (nvidia-smi);
2. the build of every CUDA kernel of the port and of the native host
   engine, timed;
3. each kernel against its plain torch version on the card, at the
   main path's shapes plus edge cases, exact int32 equality, and both
   times from CUDA events over repeated launches;
4. the main path: two genomes from ``simulate_population(2, length,
   seed)`` through ``python -m reveal_tpu_torch.cli rem --frontier
   --device cuda`` in-process, its GFA held byte for byte against the
   host engine's (``reveal_tpu.align.rem.align_genomes``), with the
   forest's counters and the kernels' launch counts checked.

The line before the last is a JSON object describing the kernels; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

RBV = 1024   # repair candidates per round on the main path
WRV = 256    # window-resolve lookback


def _event_ms(fn, iters):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_window_resolve(dev):
    """Kernel vs plain on the card: main-path shapes and edge cases."""
    import numpy as np
    import torch

    from reveal_tpu_torch.index import window_resolve as wr

    rng = np.random.default_rng(0)
    max_err = 0
    cases = 0

    def compare(lcp, q, thr):
        nonlocal max_err, cases
        lcp_t = torch.from_numpy(lcp).to(dev)
        q_t = torch.from_numpy(q).to(dev)
        thr_t = torch.from_numpy(thr).to(dev)
        got = wr.window_resolve(lcp_t, q_t, thr_t, WRV)
        ref = wr.window_resolve_plain(lcp_t, q_t, thr_t, WRV)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        if err != 0:
            bad = int((got != ref).nonzero()[0, 0])
            raise AssertionError(
                "window_resolve differs from plain at r=%d (q=%d thr=%d): "
                "%d vs %d" % (bad, int(q[bad]), int(thr[bad]),
                              int(got[bad]), int(ref[bad]))
            )
        max_err = max(max_err, err)
        cases += 1

    npad = 1 << 22
    lcp = rng.integers(0, 100, size=npad, dtype=np.int32)
    # a block where every LCP is high: windows inside it have no hit
    lcp[1000000:1010000] = 1000
    q = rng.integers(0, npad, size=RBV, dtype=np.int32)
    thr = rng.integers(-5, 120, size=RBV, dtype=np.int32)
    edges = [
        (0, 50), (1, 50), (5, 50), (WRV - 1, 50), (WRV, 50),
        (npad - 1, 50), (npad, 50), (1234567, 0), (1234567, -3),
        (1005000, 500), (1009999, 1000), (1000100, 1001),
        (2000000, 2**31 - 1),
    ]
    for i, (qq, tt) in enumerate(edges):
        q[i], thr[i] = qq, tt
    compare(lcp, q, thr)
    for small in (1, 2, 100, 383, 1000):
        lcp_s = rng.integers(0, 20, size=small, dtype=np.int32)
        q_s = rng.integers(0, small + 1, size=RBV, dtype=np.int32)
        thr_s = rng.integers(-1, 22, size=RBV, dtype=np.int32)
        compare(lcp_s, q_s, thr_s)

    # times at the main path's shapes (plain, kernel, kernel, plain)
    lcp_t = torch.from_numpy(lcp).to(dev)
    q_t = torch.from_numpy(q).to(dev)
    thr_t = torch.from_numpy(thr).to(dev)
    for _ in range(10):
        wr.window_resolve(lcp_t, q_t, thr_t, WRV)
        wr.window_resolve_plain(lcp_t, q_t, thr_t, WRV)
    iters = 200

    def kern():
        wr.window_resolve(lcp_t, q_t, thr_t, WRV)

    def plain():
        wr.window_resolve_plain(lcp_t, q_t, thr_t, WRV)

    p1 = _event_ms(plain, iters)
    k1 = _event_ms(kern, iters)
    k2 = _event_ms(kern, iters)
    p2 = _event_ms(plain, iters)
    ms = (k1 + k2) / 2
    plain_ms = (p1 + p2) / 2
    print(
        "window_resolve: %d cases equal to plain (max_abs_err %d); "
        "npad=2^22 RBV=%d WRV=%d, per call from CUDA events over %d "
        "back-to-back calls (two turns): kernel %.6f ms, plain %.6f ms"
        % (cases, max_err, RBV, WRV, iters, ms, plain_ms)
    )
    return {
        "name": "window_resolve",
        "route": "cuda",
        "source": "reveal_tpu_torch/csrc/window_resolve.cu",
        "replaces": "reveal_tpu/index/devloop.py:114",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }


def run_main_path(seed, length, workdir):
    """Port CLI on the card vs the host engine; returns the counts."""
    from reveal_tpu.align.rem import align_genomes as host_align_genomes
    from reveal_tpu.core.io_fasta import fasta_writer
    from reveal_tpu.core.io_gfa import seq2node, write_gfa
    from reveal_tpu.utils.simulate import simulate_population

    from reveal_tpu_torch import cli
    from reveal_tpu_torch.index import devloop
    from reveal_tpu_torch.index import window_resolve as wr

    t0 = time.perf_counter()
    pop = simulate_population(2, length, seed=seed)
    fastas = []
    for name, seq, _ids in pop:
        fn = os.path.join(workdir, name + ".fa")
        fasta_writer(fn, [(name, seq)])
        fastas.append(fn)
    total_bp = sum(len(seq) for _n, seq, _i in pop)
    print("genomes: simulate_population(2, %d, seed=%d): %d + %d bp in "
          "%.3f s" % (length, seed, len(pop[0][1]), len(pop[1][1]),
                      time.perf_counter() - t0))

    t0 = time.perf_counter()
    G, idx = host_align_genomes(fastas, backend="auto")
    seq2node(G, idx.main.T)
    host_gfa = write_gfa(G, idx.main.T,
                         outputfile=os.path.join(workdir, "host.gfa"))
    t_host = time.perf_counter() - t0
    print("host engine (reveal_tpu, serial native recursion): %.6f s"
          % t_host)

    port_gfa = os.path.join(workdir, "port.gfa")
    wr.LAUNCHES = 0
    t0 = time.perf_counter()
    cli.main(["rem", *fastas, "--frontier", "--device", "cuda",
              "-o", port_gfa])
    t_e2e = time.perf_counter() - t0
    launches = wr.LAUNCHES
    st = dict(devloop.LAST_STATS)

    with open(host_gfa, "rb") as fh:
        host_bytes = fh.read()
    with open(port_gfa, "rb") as fh:
        port_bytes = fh.read()
    if host_bytes != port_bytes:
        raise AssertionError(
            "port GFA (%d bytes) differs from the host engine's (%d bytes)"
            % (len(port_bytes), len(host_bytes))
        )
    if st.get("abort") != 0 or st.get("fallback") is not None:
        raise AssertionError("device forest did not finish: %r" % st)
    if not st["forest"] > 0 or not st["repair_steps"] > 0:
        raise AssertionError("forest or repair did not run: %r" % st)
    if not launches > 0 or launches != st["repair_rounds_total"]:
        raise AssertionError(
            "window_resolve launched %d times for %d repair rounds"
            % (launches, st["repair_rounds_total"])
        )
    print("main path: GFA byte-identical to the host engine's (%d bytes)"
          % len(port_bytes))
    print(
        "forest: roots=%d slots=%d levels=%d repair_rounds=%d "
        "anchors=%d dispatches=%d chain_steps=%d trim_steps=%d"
        % (st["forest"], st["slots"], st["levels"], st["repair_steps"],
           st["anchors"], st["dispatches"], st["chain_steps"],
           st["trim_steps"])
    )
    print(
        "times: host_prefix %.6f s, forest %.6f s, end-to-end (fasta -> "
        "GFA, CLI in-process) %.6f s, %.6f Mbp/s (%d input bp)"
        % (st["host_prefix_seconds"], st["forest_seconds"], t_e2e,
           total_bp / 1e6 / t_e2e, total_bp)
    )
    # a second run of the same command: the warm timing
    t0 = time.perf_counter()
    cli.main(["rem", *fastas, "--frontier", "--device", "cuda",
              "-o", port_gfa])
    t_warm = time.perf_counter() - t0
    with open(port_gfa, "rb") as fh:
        if fh.read() != host_bytes:
            raise AssertionError("second run's GFA differs")
    st = devloop.LAST_STATS
    print(
        "warm run: host_prefix %.6f s, forest %.6f s, end-to-end %.6f s, "
        "%.6f Mbp/s" % (st["host_prefix_seconds"], st["forest_seconds"],
                        t_warm, total_bp / 1e6 / t_warm)
    )
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--length", type=int, default=2_000_000)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is False (torch %s)"
            % torch.__version__
        )
    sys.path.insert(0, REPO)
    from reveal_tpu_torch.kernels import build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi)
    print("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))

    t0 = time.perf_counter()
    so = build.build()
    build.load_library()
    print("kernels built: %s in %.3f s" % (os.path.relpath(so, REPO),
                                           time.perf_counter() - t0))
    from reveal_tpu.native import get_lib

    t0 = time.perf_counter()
    if get_lib() is None:
        raise RuntimeError("the native host engine failed to build")
    print("native host engine built/loaded in %.3f s"
          % (time.perf_counter() - t0))

    row = check_window_resolve(dev)
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".smoke_") as wd:
        row["launches"] = run_main_path(args.seed, args.length, wd)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
