"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py [--seed 1] [--length 2000000]
                          [--only kernels|profile|multi|chain|frontier|single|align|esa|dist|mesh]
                          [--tree DIR]

``--only kernels`` stops after phase 4 (about three minutes): the build
and the kernels against their plain versions, for work on a kernel.
``--only profile`` runs phases 1-2 and 5b only.  ``--only multi`` runs
phases 1-2, the window-resolve checks of phase 3 and phases 5c and 5f;
``--only chain`` phases 1-2 and 5f; ``--only frontier`` phases 1-2 and
5d; ``--only single`` phases 1-2 and 5e; ``--only align`` phases 1-2 and
7; ``--only esa`` phases 1-2 and 8;
``--only dist`` phases 1-2, 5d (b)-(d) (phase 9 (f) and (h) hold the mesh
frontier to their GFAs) and 9; ``--only mesh`` phases 1-2, 5d (b)-(d),
9 (d) and 9 (f)-(h).
``--tree DIR`` imports ``reveal_tpu_torch`` from the checkout at DIR
instead of this one (with ``--only profile``: the parent's forest timed
beside this one's, in turns, on one card in one go).

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card's name and power limit (nvidia-smi);
2. the build of every CUDA kernel of the port and of the native host
   engine (side by side), timed, with every kernel's registers and spills
   as ``ptxas -v`` printed them;
3. each kernel against its plain torch version on the card, at the main
   paths' shapes plus edge cases, with both times from CUDA events:
   window-resolve (exact int32 equality), the pair-HMM forward and
   backward DP (float32, limits stated below) under every kind of launch
   plan (pairs sharing a warp, a chain of up to 129 warps a pair; strips
   of 4 and 8 columns; at the two table shapes also the plan that
   ``refine``'s two-phase batches of those shapes launch; the square
   buckets of the stage-1+2 chain), and the two DP kernels alone at
   1,024 tiny pairs; the repair-pass kernel (``index/repair.py``) against
   its plain version (the batched rounds) on the card, at the inputs of
   every repair pass of the main path: two genomes from
   ``simulate_population(2, length, seed)`` go through ``cli rem
   --frontier --device cuda`` while each pass is run on copies plain,
   kernel, kernel, plain (SA, LCP, BWT and the counters exactly equal),
   with the times of both from CUDA events; the MEA-score row scan
   (``hmm/mea_score.py``) bit for bit against its plain loop at the
   shapes of both refine routes, the widest bucket and edge widths;
4. the card's posteriors against the native float64-exact host pair-HMM
   on a sample of pairs from each bucket;
5. ``rem``: the same two genomes through ``python -m
   reveal_tpu_torch.cli rem --frontier --device cuda`` in-process, its
   GFA held byte for byte against the port's serial host engine
   (``align_genomes_host``), with the forest's counters and the launch
   counts checked: one repair kernel launch a pass, no window-resolve
   launch;
5b. the same ``rem`` three times more: a warm-up, a run with a
   synchronised host clock around each call of the forest's stages
   (enumerate, trim, chain, anchor log, children, split, repair pass),
   and a run under ``torch.profiler`` over the forest (kernel launches,
   host syncs as ``cudaStreamSynchronize`` calls, device time, the
   card's busy share, the kernels that take the most device time);
5c. multi-genome ``rem``: ``simulate_population(n, length, seed)`` at
   the CLI's defaults through ``cli rem --frontier --device cuda`` (the
   multi-genome device loop), its GFA held byte for byte against the
   port's host engine: (a) 6 x 100 kbp, (b) 8 x 50 kbp (8 paths), (c) 3
   x 300 kbp with one genome cut in two contigs (4 paths).  Every repair
   round launches window-resolve once, no repair-pass launch.  Case (a)
   four times more: under ``torch.profiler`` (launches, host syncs, busy
   share), with a synchronised clock around
   the loop's stages, with torch's sync debug mode putting every host
   sync to the line of the port that made it, and with every repair
   round's window-resolve held exactly against its plain version
   (plain, kernel, kernel, plain; CUDA events);
5f. the multi chain's score pass (``index/chain_score.py``,
   ``csrc/chain_score_multi.cu``): two ``simulate_population(6, 80_000,
   seed)`` jobs (the panel_1a1f cell's shape) through ``cli rem --device
   cuda`` with every level's planes recorded at the wrapper, one launch a
   level with candidate columns checked, then each level's planes through
   the kernel and the plain loop on the card, bit for bit, with both
   times (CUDA events), the bound by operations and the latency floor;
   three synthetic levels past the panel's widths, the last past the
   shared-memory layout;
5d. the per-level device frontier (no kernel of its own: torch stages
   and the native repair walk) through ``cli rem --frontier --device
   cuda``, the host engine refused inside it, node state and text held
   against the port's host engine and every path of the GFA spelling its
   input: (a) ``simulate_population(6, 500_000, seed)``, past
   ``--maxmums``: the multi loop declines (``ABORT_MAXMUMS``) and the
   frontier takes it; (b) a 2 x 2 Mbp pair, each genome cut into contigs
   of 1.9 Mbp, 80 kbp and the rest; (c) nine paths of 50 kbp, past the
   multi loop's eight; (d) 4 x 50 kbp forced onto the frontier on the
   card and on the CPU, at the defaults and with ``--notrim``: equal GFA
   bytes;
5e. the single-root device loop (the whole pairwise recursion from the
   root in the forest's level loop with the flat chain, its repair passes
   on the repair-pass kernel) through ``cli rem --frontier --device
   cuda``, the host engine refused inside it: (a) ``simulate_population(2,
   500_000, seed)`` with the host prefix and forest stood in to decline,
   taken whole: GFA bytes against the host engine's, one repair launch a
   pass and no window-resolve launch; the default route and the host
   engine timed on the same pair; the loop again with its stage spans on
   and under ``torch.profiler`` (launches, host syncs, busy share, peak
   memory; ``chain_flat``'s calls, rounds, launches, host syncs and device
   time apart); (b) 2 x 1 Mbp with the forest stood in to decline: the
   loop aborts with ``ABORT_CHAIN_ROUNDS`` at level 0 (at
   seed 1) and the per-level frontier takes the pair, node state and text
   against the host engine's; (c) 2 x 200 kbp by the default route with
   the forest stood in to decline: the loop takes it, GFA bytes against
   the host engine's, then again with every repair pass held against its
   plain version (plain, kernel, kernel, plain; exact);
6. ``refine``: a six-path chain of bubbles (64 with alleles near 500 bp,
   8 near 1900 bp, 10-15% substitutions and indels up to 12 bp between
   alleles) written from ``--seed``, through ``cli refine --all
   --minsize 2 --maxsize 10000 --device cuda``, which takes the
   stage-1+2 chain for every bubble; every path of the refined GFA must
   spell its input, every bubble must come back aligned, the forward and
   backward kernels must each have been launched once per DP batch of
   the chain and the MEA-score kernel once per chunk.  The chain of the
   same bubbles then runs once more with a synchronised clock around its
   steps, each of its MEA-score launches held against the plain loop on
   its own input and each pair's score against the host MEA DP of its
   posterior.  The same GFA's 64 bubbles near 500 bp then go through the
   two-phase route on the card (stage 1 on the card, stage 2 on the
   host): the bubbles whose refined subgraph differs are counted and the
   transformed matrices held against the chain's.  Stage 1 of the two-phase route is then run
   again phase by phase (pack and copy in, classes and reversal, forward
   kernel, backward kernel, combine, cut with the MEA-score kernel, top-K
   and copy back).  A 13-bubble graph goes through the native float64
   route for stage 1 beside the card's, with the differing bubbles
   counted; the MEA-score kernel and the relaxation products are timed
   at the chain's shapes.  The 72-bubble run is repeated with ``--nproc
   4`` (the per-bubble MSA in processes forked after the card's stages:
   the serial run's bytes).  The posterior self-check
   (``hmm/selfcheck.py``) runs on the card, and ``refine --logadd-compat``
   on three small bubbles on the card and on the CPU (equal bytes);
6b. a graph of one six-path bubble of about 4 kbp (its chain tensor over
   ``msa.CHAIN_BYTES_CAP``) and four near 500 bp: the chain for four
   bubbles and the two-phase route for one in one run;
6c. ``refine`` (on the chain) of the GFA ``rem`` wrote for phase 5e
   (a)'s 2 x 500 kbp pair;
7. ``align``, the pipeline rem -> unzip -> refine -> variants (three
   VCFs) in one process: (a) ``python -m reveal_tpu_torch.cli align
   ... --run --device cuda -o prg`` on ``ALIGN_A`` = six genomes of 50
   kbp (``simulate_population(6, 50_000, seed)``; 5c (a)'s six of 100 kbp
   until the script outgrew its time): ``prg.gfa`` byte for byte the host
   engine's GFA of the same fastas (the multi loop, window-resolve once
   a repair round, no repair-pass launch), ``prg.unzipped.gfa`` and the
   anchored and unzipped VCFs the host ``unzip`` and ``variants`` of
   those bytes, every path of ``prg.unzipped.realigned.gfa`` spelling its
   input (the chain: forward, backward and MEA-score launches as the
   bubbles' shapes ask), ``prg.unzipped.realigned.gfa`` and
   ``prg.refined.vcf`` byte for byte those of ``refine --device cpu``
   and ``variants`` of the same unzipped GFA; each stage timed
   (synchronised clock) and each kernel's smallest and largest launch of
   the run held against its plain version on the same inputs; (b) ``align --run
   --order sequential --chunksize 2`` on ``simulate_population(4,
   50_000, seed)`` on the card and on the CPU: every file equal in bytes,
   the pair chunks on the forest (one repair-pass launch a pass, the
   smallest and largest passes held against plain), the ``.gfa`` level on the per-level
   frontier;
8. the device suffix-array build (``--backend jax``, ``index/suffix.
   build_esa_device``: torch code, no kernel of its own) and the device
   MUM scans: (a) on the roots of ``simulate_population(n, L, seed)`` at
   6 x 100 kbp, 2 x 2 Mbp, 6 x 1 Mbp and 2 x 16 Mbp (npad 2^20, 2^22,
   2^23, 2^25) SA, LCP and SAi exactly the native SA-IS + Kasai's and the
   suffix order checked in linear time (the first root also through
   ``sufcheck`` and with ``force64``), with the doubling rounds, the
   seconds of the rounds, the LCP descent and the copy to the host on a
   synchronised clock, the peak device memory and the native build's
   seconds; (b) ``cli rem --frontier --device cuda --backend jax`` on
   phase 5's pair (the forest) and on 6 x 100 kbp (the multi loop): the
   default backend's GFA bytes and kernel launches, both timed; (c)
   ``pairwise_mums_device`` on the device-built 2 x 2 Mbp root and
   ``frontier_mums`` over two children of it (the interleaved
   pseudo-segments of ``tests/test_frontier.py`` and the genomes'
   halves) against the host scans;
9. the multi-device routes (``parallel/``: torch code over
   ``torch.distributed``, no kernel of their own): (a) the distributed
   suffix-array build (``--backend jax-dist``) in a world of one under
   NCCL on phase 8's 2 x 2 Mbp and 2 x 16 Mbp roots (npad 2^22, 2^25),
   LCP stride None and "sqrt": SA, LCP and SAi exactly the native
   build's, the rounds, the LCP descent and the copy on a synchronised
   clock, the peak device memory, ``build_esa_device`` and the native
   build timed beside it; (b) ``cli rem --frontier --device cuda
   --backend jax-dist`` on phase 5's pair: the default backend's GFA
   bytes and kernel launches; (c) ``build_pipeline_step`` in the world of
   one at the CPU test's shapes and on the 2 x 2 Mbp root's SA and LCP
   (two segments, the genomes' halves) with 64 related pairs at the
   chain's 512 x 512 bucket: the count the host scans', ``cells``
   exact, the summed log-probability within 1e-5 of the native float64
   pair-HMM's, one launch each of the forward and backward DP kernels,
   each held against its plain version on the step's own batch; (d) gloo
   worlds of 2 and 4 processes on the machine's CPU, the 6 x 50 kbp root
   (npad 2^19) exactly the native build's on every rank, timed; (e) ``cli
   matches`` (and ``--rc``) with ``--backend jax --device cuda``: the
   standard output of ``--backend native``; (f) the mesh frontier
   (``align_genomes(..., mesh=make_mesh(1))``: the per-level frontier's
   slots sharded over the mesh's ranks, torch code over
   ``torch.distributed``, no kernel of its own) in the world of one under
   NCCL on phase 5d's cases (b) and (c): GFA bytes equal to the ones
   phase 5d wrote, the single-device frontier's levels, candidates and
   repair jobs, the stages' seconds, the collectives posted and the peak
   device memory beside phase 5d's; (g) the dry run
   (``parallel/dryrun.dryrun_multichip``: the sharded and distributed
   builds, the pipeline step, a pairwise and a three-genome mesh ``rem``
   against the single-device frontier) in the world of one; (h) in (d)'s
   gloo worlds of 2 and 4 on the host's CPU, the mesh frontier on phase
   5d (d)'s 4 x 50 kbp: every rank's GFA the card's bytes.

Limits: M and G0 cells where kernel and plain are both above LOG_ZERO/2
agree within 1e-4 * max(L1p, L2p) (float32 at magnitudes that grow with
the length); posteriors within gate = max(2e-3, 4e-5 * max(lx, ly)).  The
card's MEA score equals the host MEA DP of the card's own dense posterior
within 1e-5 relative (the two-phase cut) and 1e-6 (the chain), and the
native float64 route's score within 1e-2 * min(lx, ly): a score sums one
posterior per aligned base, the float32 errors of a pair's cells share
their sign, and sound runs read about 4e-3 a base at 2048 bp.  The MEA-
score kernel equals its plain loop exactly.  The chain's transformed
matrices are within 5e-3 of the two-phase route's, except cells within
that of the 0.01 cut that one route keeps and the other drops.

The line before the last is a JSON object describing the kernels; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# the fixture writers the port's CPU tests share
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_support import diverge, write_bubble_chain  # noqa: E402

RBV = 1024   # repair candidates per round of the batched rounds
WRV = 256    # window-resolve lookback

# NVIDIA H100 SXM, published peaks: HBM3 at 3.35 TB/s; float32 outside
# the tensor cores at 67 TFLOP/s; exp2/log2 at 16 results per clock per
# SM (CUDA programming guide, compute capability 9.0) on 132 SMs at the
# 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# one dependent round trip to the L2 cache: about 260 clocks on Hopper
# (published microbenchmarks; not measured by this script) at 1.98 GHz
L2_ROUND_TRIP_S = 260 / 1.98e9
# exp + log evaluations a DP cell needs in either direction when the
# in-row recurrence is run sequentially: the 5-way lse (5 + 1), two
# 2-way lse for the x inserts (4) and two for the y recurrence (4).  The
# seeds of the y inserts are LOG_ZERO in every cell but one: a select,
# not an lse
SFU_PER_CELL = 14

LOG_ZERO = -2e20

REFINE_KW = dict(minlength=20, minsize=2, maxsize=10000, minconf=0,
                 constrans=2, consgap=False, nrefinements=100)
# the two-phase comparison takes the bubbles up to this size (those near
# 500 bp of the 72-bubble graph)
TWO_PHASE_MAXSIZE = 1000


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
    # the function reads RBV windows of WRV LCP entries, q and thr, and
    # writes RBV results; one compare per window entry
    nbytes = RBV * WRV * 4 + 3 * RBV * 4
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = RBV * WRV / F32_OPS_PER_S * 1e3
    print(
        "window_resolve: %d cases equal to plain (max_abs_err %d); "
        "npad=2^22 RBV=%d WRV=%d, per call from CUDA events over %d "
        "back-to-back calls (two turns): kernel %.6f ms, plain %.6f ms, "
        "bound %.6f ms (%d bytes)"
        % (cases, max_err, RBV, WRV, iters, ms, plain_ms,
           max(bound_bytes, bound_ops), nbytes)
    )
    return {
        "name": "window_resolve",
        "route": "cuda",
        "source": "reveal_tpu_torch/csrc/window_resolve.cu",
        "replaces": "reveal_tpu/index/devloop.py:114",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": None,
    }


def write_genomes(seed, length, workdir):
    """Two fastas of ``simulate_population(2, length, seed)`` in
    ``workdir``; returns (paths, total bp)."""
    from reveal_tpu_torch.core.io_fasta import fasta_writer
    from reveal_tpu_torch.utils.simulate import simulate_population

    t0 = time.perf_counter()
    pop = simulate_population(2, length, seed=seed)
    fastas = []
    for name, seq, _ids in pop:
        fn = os.path.join(workdir, name + ".fa")
        fasta_writer(fn, [(name, seq)])
        fastas.append(fn)
    print("genomes: simulate_population(2, %d, seed=%d): %d + %d bp in "
          "%.3f s" % (length, seed, len(pop[0][1]), len(pop[1][1]),
                      time.perf_counter() - t0))
    return fastas, sum(len(seq) for _n, seq, _i in pop)


def hold_repair_passes(run):
    """``run()`` with every repair pass held against its plain version.

    ``repair.repair_segments`` is wrapped for the run: each pass is first
    run on fresh copies of SA, LCP and BWT plain, kernel, kernel, plain
    (``devloop.repair_rounds_plain``, the batched rounds, against the
    kernel), each call between two CUDA events, the outputs and counters
    held exactly equal; then the pass goes on as the path runs it.
    Returns (the passes' numbers, the largest difference: 0)."""
    import torch

    from reveal_tpu_torch.index import devloop, repair

    segments = repair.repair_segments
    passes = []
    worst = 0

    def hold(SA, LCP, BWT, SEG, beg, cq, centry_next, rc, SMAX, stats):
        nonlocal worst
        rest = (SEG, beg, cq, centry_next, rc, SMAX)
        times = {"plain": [], "kernel": []}
        outs = {}
        for turn in ("plain", "kernel", "kernel", "plain"):
            fn = devloop.repair_rounds_plain if turn == "plain" else segments
            arrs = (SA.clone(), LCP.clone(), BWT.clone())
            st = torch.zeros_like(stats)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*arrs, *rest, st)
            stop.record()
            torch.cuda.synchronize()
            times[turn].append(start.elapsed_time(stop))
            outs[turn] = (out[:3], st)
        (kern, kst), (ref, pst) = outs["kernel"], outs["plain"]
        for name, k, p in zip(("SA", "LCP", "BWT"), kern, ref):
            err = int((k.long() - p.long()).abs().max())
            worst = max(worst, err)
            if err:
                bad = int((k != p).nonzero()[0, 0])
                raise AssertionError(
                    "repair pass %d: kernel %s differs from plain at slot %d "
                    "(%d vs %d)" % (len(passes), name, bad, int(k[bad]),
                                    int(p[bad])))
        if not torch.equal(kst, pst):
            raise AssertionError("repair pass %d: kernel counters %s, plain "
                                 "%s" % (len(passes), kst.tolist(),
                                         pst.tolist()))
        applied, chain, moved = kst.tolist()
        # bytes: each moved slot's SA, LCP, BWT read and written once (the
        # search reads the same LCP words); a candidate's own words
        # (cq, centry_next, beg, SEG, SA, LCP, BWT at q, LCP at q + 1)
        nbytes = 24 * moved + 32 * applied
        passes.append({
            "rc": int(rc), "applied": applied, "chain": chain,
            "moved": moved, "ms": sum(times["kernel"]) / 2,
            "plain_ms": sum(times["plain"]) / 2, "bytes": nbytes,
            "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_chain_ms": chain * L2_ROUND_TRIP_S * 1e3,
        })
        return segments(SA, LCP, BWT, SEG, beg, cq, centry_next, rc, SMAX,
                        stats)

    repair.repair_segments = hold
    try:
        run()
    finally:
        repair.repair_segments = segments
    if not passes:
        raise AssertionError("the run made no repair pass")
    return passes, worst


def repair_summary(passes, worst, what):
    """Prints the held passes of one path; returns their totals (ms and
    bounds a pass, sums, the longest run, moved slots)."""
    k = len(passes)

    def total(key):
        return sum(p[key] for p in passes)

    ms, plain_ms = total("ms") / k, total("plain_ms") / k
    bound_ms = total("bound_bytes_ms") / k
    chain_ms = total("bound_chain_ms") / k
    print("repair_pass: kernel equal to plain (SA, LCP, BWT, counters; "
          "max_abs_err %d) on all %d repair passes of %s; per "
          "pass from CUDA events on fresh copies (plain, kernel, kernel, "
          "plain): kernel %.6f ms (sum %.6f, max %.6f), plain %.6f ms (sum "
          "%.6f, max %.6f); candidates applied %d, longest run %d, moved "
          "slots %d (%d bytes); bound per pass %.6f ms by bytes at 3.35 "
          "TB/s, %.6f ms as the longest run's chain of dependent L2 round "
          "trips (260 clocks at 1.98 GHz each)"
          % (worst, k, what, ms, total("ms"), max(p["ms"] for p in passes),
             plain_ms, total("plain_ms"),
             max(p["plain_ms"] for p in passes), total("applied"),
             max(p["chain"] for p in passes), total("moved"),
             total("bytes"), bound_ms, chain_ms))
    for i, p in sorted(enumerate(passes), key=lambda ip: -ip[1]["ms"])[:6]:
        print("  repair pass %2d: rc %6d, applied %6d, longest run %5d, "
              "moved %8d, kernel %.6f ms (%.3f us a step of the longest "
              "run), plain %.6f ms"
              % (i, p["rc"], p["applied"], p["chain"], p["moved"], p["ms"],
                 p["ms"] * 1e3 / max(p["chain"], 1), p["plain_ms"]))
    return {
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "bound_latency_ms": chain_ms,
        "passes": k,
        "ms_sum": total("ms"),
        "plain_ms_sum": total("plain_ms"),
        "longest_run": max(p["chain"] for p in passes),
        "moved_slots": total("moved"),
    }


def check_repair(fastas, workdir):
    """The repair-pass kernel against its plain version on the card, at
    the inputs of every repair pass of the main path (the forest of
    ``cli rem``: ``hold_repair_passes``).  Returns the row of the
    kernels line."""
    from reveal_tpu_torch import cli

    passes, worst = hold_repair_passes(lambda: cli.main([
        "rem", *fastas, "--frontier", "--device", "cuda", "-o",
        os.path.join(workdir, "repair_check.gfa")]))
    row = {
        "name": "repair_pass",
        "route": "cuda",
        "source": "reveal_tpu_torch/csrc/repair_pass.cu",
        "replaces": "reveal_tpu/index/devloop.py:114",
        "library_ms": None,
    }
    row.update(repair_summary(passes, worst, "the main path"))
    return row


def _related_pairs(rng, count, lo, hi):
    """``count`` pairs of sequences with lengths in [lo, hi]: y is x
    with about 12% substitutions and a few indels of up to 12 bp."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(count):
        n = int(rng.integers(lo, hi + 1))
        x = bases[rng.integers(0, 4, n)].copy()
        pairs.append((x.tobytes().decode(),
                      diverge(rng, x, 0.12, hi).decode()))
    return pairs


def _grid_err(got, ref, what):
    """Largest |got - ref| over cells where both are real (above
    LOG_ZERO / 2); the two must agree on which cells are."""
    real_g = got > LOG_ZERO / 2
    real_r = ref > LOG_ZERO / 2
    if bool((real_g != real_r).any()):
        raise AssertionError("%s: kernel and plain disagree on which "
                             "cells are LOG_ZERO" % what)
    if not bool(real_g.any()):
        return 0.0
    return float((got - ref).abs()[real_g].max())


def _plan_text(plan):
    return ("C=%d G=%d P=%d, %d blocks of %d warp"
            % (plan["C"], plan["G"], plan["P"], plan["blocks"],
               plan["warps_per_block"]))


def check_pairhmm(dev):
    """Forward and backward kernels vs their plain versions on the
    card, and the posterior after the combine; times at the two main
    shapes.  Returns the two rows of the kernels line."""
    import numpy as np
    import torch

    from reveal_tpu_torch.hmm import pairhmm_dp as dp
    from reveal_tpu_torch.hmm.pairhmm import default_params
    from reveal_tpu_torch.kernels import build

    params = default_params(dev)
    rng = np.random.default_rng(7)
    worst = {"fwd": 0.0, "bwd": 0.0, "post": 0.0}
    times = {}

    def compare(name, pairs, time_iters=0, plain_again=True, force=(),
                square=None):
        """Kernels against plain under the plan ``launch_plan`` picks and
        then under every strip width of ``force``, on the same plain
        grids: both strip widths and every way of laying pairs over warps
        are checked on every run, the main path's among them.  With
        ``square``, the pairs are padded to square x square as the
        stage-1+2 chain pads them, else bucketed as the two-phase route
        does."""
        if square:
            L1p = L2p = square
            x, y, lx, ly = dp.pack(pairs, square, square, dev)
        else:
            (batch,) = list(dp.batches(pairs, dev))
            L1p, L2p, _idxs, x, y, lx, ly = batch
        B = len(pairs)
        lim = 1e-4 * max(L1p, L2p)
        gate = torch.clamp(4e-5 * torch.maximum(lx, ly).float(), min=2e-3)
        xcls, ycls = dp._prep(x, y)
        xr, yr = dp._prep(dp._reverse_within(x, lx),
                          dp._reverse_within(y, ly))
        m_p, snap_p = dp.fwd_dp_plain(xcls, ycls, lx, params)
        b_p = dp.flip_within(dp.bwd_dp_plain(xr, yr, params), lx, ly)
        picked = dp.launch_plan(B, L1p, L2p)
        plans = [(name, picked)] + [
            ("%s C%d" % (name, C), dp.make_plan(B, L1p, L2p, C))
            for C in force]
        checked = []
        for label, plan in plans:
            m_k, snap_k = dp._launch_fwd(plan, xcls, ycls, lx, params)
            b_k = dp._launch_bwd(plan, xr, yr, lx, ly, params)
            torch.cuda.synchronize()
            e_f = max(_grid_err(m_k, m_p, label + " M"),
                      _grid_err(snap_k, snap_p, label + " snapshot"))
            e_b = _grid_err(b_k, b_p, label + " G0")
            if plan is picked:
                # the posterior as a user gets it; the wrappers pick the
                # same plan again
                del m_k, b_k, snap_k
                p_k, t_k = dp.posterior_batch(x, y, lx, ly, params)
            else:
                p_k, t_k = dp.combine(m_k, snap_k, b_k, lx, ly, params)
                del b_k, snap_k
            for fwd, direction in ((1, "fwd"), (0, "bwd")):
                # the wrapper's scratch is as large as the kernel takes it
                want = build.load_library().rtt_pairhmm_scratch_words(
                    fwd, B, L1p, plan["P"])
                if dp.scratch_words(direction, B, L1p, plan["P"]) != want:
                    raise AssertionError(
                        "%s: scratch_words(%s) is not the kernel's %d"
                        % (label, direction, want))
            checked.append((label, plan, e_f, e_b, p_k, t_k))
        # the plain posterior: the same combine on the plain grids
        p_p, t_p = dp.combine(m_p, snap_p, b_p, lx, ly, params)
        del m_p, b_p, snap_p
        torch.cuda.synchronize()
        for label, plan, e_f, e_b, p_k, t_k in checked:
            if not bool(torch.isfinite(p_k).all()):
                raise AssertionError("%s: posterior not finite" % label)
            per_pair = (p_k - p_p).abs().amax(dim=(1, 2))
            e_p = float(per_pair.max())
            e_t = float((t_k - t_p).abs().max())
            print("pairhmm %-25s B=%-4d L1p=%-5d L2p=%-5d max |M| err %.3e, "
                  "|G0| err %.3e (limit %.3e), posterior err %.3e (limit "
                  "%.3e), total err %.3e; plan %s"
                  % (label, B, L1p, L2p, e_f, e_b, lim, e_p,
                     float(gate.min()), e_t, _plan_text(plan)))
            if e_f > lim or e_b > lim:
                raise AssertionError(
                    "%s: DP grids differ by %g / %g, limit %g"
                    % (label, e_f, e_b, lim))
            if bool((per_pair > gate).any()):
                raise AssertionError("%s: posteriors differ by %g"
                                     % (label, e_p))
            worst["fwd"] = max(worst["fwd"], e_f)
            worst["bwd"] = max(worst["bwd"], e_b)
            worst["post"] = max(worst["post"], e_p)
        del checked, p_k, p_p
        if time_iters:
            def pf():
                dp.fwd_dp_plain(xcls, ycls, lx, params)

            def pb():
                dp.bwd_dp_plain(xr, yr, params)

            t = {"plan": _plan_text(picked)}
            t["plain_fwd"] = _event_ms(pf, 1)
            t["plain_bwd"] = _event_ms(pb, 1)
            for label, plan in plans:
                def kf():
                    dp._launch_fwd(plan, xcls, ycls, lx, params)

                def kb():
                    dp._launch_bwd(plan, xr, yr, lx, ly, params)

                kf(), kb()
                tf = (_event_ms(kf, time_iters)
                      + _event_ms(kf, time_iters)) / 2
                tb = (_event_ms(kb, time_iters)
                      + _event_ms(kb, time_iters)) / 2
                if plan is picked:
                    t["fwd"], t["bwd"] = tf, tb
                else:
                    print("pairhmm %-25s kernels alone (x%d, x%d): fwd "
                          "%.6f ms, bwd %.6f ms; plan %s"
                          % (label, time_iters, time_iters, tf, tb,
                             _plan_text(plan)))
            if plain_again:
                t["plain_fwd"] = (t["plain_fwd"] + _event_ms(pf, 1)) / 2
                t["plain_bwd"] = (t["plain_bwd"] + _event_ms(pb, 1)) / 2
            # The work the function needs on this run's data: the cells
            # within lx x ly (the rest of the grid is LOG_ZERO or, in the
            # forward's columns beyond ly, read by nobody), 14 exp/log
            # each; the whole grid is written once.
            cells = int(((lx.long() + 1) * (ly.long() + 1)).sum())
            grid = B * L1p * L2p
            nbytes = (grid * 4 + B * 5 * L2p * 4 + B * (L1p + L2p)
                      + 8 * B + 408)
            by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            by_ops = SFU_PER_CELL * cells / SFU_OPS_PER_S * 1e3
            t["bound"] = max(by_bytes, by_ops)
            t["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
            t["bound_padded_grid"] = max(
                by_bytes, SFU_PER_CELL * grid / SFU_OPS_PER_S * 1e3)
            times[name] = t
            print("pairhmm %-22s per call from CUDA events (plain, kernel x%d"
                  ", kernel x%d%s): fwd %.6f ms (plain %.6f), bwd "
                  "%.6f ms (plain %.6f); bound %.6f ms by %s (%d cells "
                  "within lx x ly, %.1f%% of the padded grid; %d bytes; "
                  "the bound over the whole padded grid, as before the "
                  "redesign, is %.6f ms); %.6f Gcells/s forward over the "
                  "cells within lx x ly"
                  % (name, time_iters, time_iters,
                     ", plain" if plain_again else "", t["fwd"],
                     t["plain_fwd"], t["bwd"], t["plain_bwd"], t["bound"],
                     t["bound_by"], cells, 100.0 * cells / grid, nbytes,
                     t["bound_padded_grid"], cells / t["fwd"] / 1e6))

    def time_only(name, pairs, iters):
        """Kernel times alone, at a shape too large for its plain
        version to be run beside it."""
        (batch,) = list(dp.batches(pairs, dev))
        L1p, L2p, _idxs, x, y, lx, ly = batch
        xcls, ycls = dp._prep(x, y)
        xr, yr = dp._prep(dp._reverse_within(x, lx),
                          dp._reverse_within(y, ly))

        def kf():
            dp.fwd_dp(xcls, ycls, lx, params)

        def kb():
            dp.bwd_dp(xr, yr, lx, ly, params)

        kf(), kb()
        t = {"fwd": (_event_ms(kf, iters) + _event_ms(kf, iters)) / 2,
             "bwd": (_event_ms(kb, iters) + _event_ms(kb, iters)) / 2}
        times[name] = t
        plan = dp.launch_plan(len(pairs), L1p, L2p)
        print("pairhmm %-22s B=%-4d L1p=%-5d L2p=%-5d kernels alone, per "
              "call from CUDA events (x%d, x%d): fwd %.6f ms, bwd %.6f ms; "
              "plan %s"
              % (name, len(pairs), L1p, L2p, iters, iters, t["fwd"],
                 t["bwd"], _plan_text(plan)))

    # the two shapes of the table; strips of 8 with one warp a panel are
    # what refine's large batches of these shapes launch
    compare("B128_L512", _related_pairs(rng, 128, 300, 512), time_iters=10,
            force=[8])
    # the plain version takes seconds a call here: timed once
    compare("B32_L2048", _related_pairs(rng, 32, 1100, 2048), time_iters=5,
            plain_again=False, force=[8])
    compare("len_1_and_2", [("A", "A"), ("AC", "G"), ("N", "a"),
                            ("ac", "GT"), ("A", "CG"), ("TT", "T"),
                            ("G", "G"), ("CA", "CA")])
    compare("unequal_lx_ly_1", [("ACGTACGTAC", "A"), ("ACG", "C"),
                                ("ACGTACGTACGTACGT", "G"), ("T", "T"),
                                ("NNACGT", "N"), ("acgtACGT", "t"),
                                ("GATTACA", "A"), ("CC", "C")])
    nl = _related_pairs(rng, 8, 48, 64)
    nl = [(a[:10] + "NNN" + a[13:30].lower() + a[30:], b[:20]
           + b[20:35].lower() + "N" + b[36:]) for a, b in nl]
    # two pairs a warp (picked) and one
    compare("N_and_lowercase", nl, force=[4])
    # few rows under wide columns: chains of 33 and 65 panels (strips of
    # 8), 65 and 129 (strips of 4), longer than the rows that feed them
    wide = _related_pairs(rng, 2, 5000, 6000)
    compare("wider_than_shared", [(a[:48], b) for a, b in wide], force=[4])
    # the widest bucket refine --maxsize 10000 can make (L2p = 16512)
    widest = _related_pairs(rng, 2, 9000, 10000)
    compare("widest_maxsize_10000", [(a[:48], b) for a, b in widest],
            force=[4])
    sw = [(a[:30], b) for a, b in _related_pairs(rng, 64, 1100, 2048)]
    compare("short_x_wide_y", sw, force=[4])
    # the many-tiny-bubbles batch of rem then refine
    time_only("B1024_tiny", _related_pairs(rng, 1024, 2, 16), 20)
    # the stage-1+2 chain's square buckets on the 72-bubble graph (a chunk
    # of 7 six-path bubbles near 500 bp, one near 1900 bp) and on the rem
    # GFA (two-path bubbles of a few bp)
    compare("chain_B105_L512", _related_pairs(rng, 105, 440, 510),
            time_iters=10, square=512)
    compare("chain_B15_L2048", _related_pairs(rng, 15, 1750, 2040),
            time_iters=5, plain_again=False, square=2048)
    compare("chain_B1024_L32", _related_pairs(rng, 1024, 1, 30), square=32)

    rows = []
    tiny = times["B1024_tiny"]
    main = times["B128_L512"]
    big = times["B32_L2048"]
    for key, fn_line in (("fwd", 119), ("bwd", 218)):
        rows.append({
            "name": "pairhmm_" + key,
            "route": "cuda",
            "source": "reveal_tpu_torch/csrc/pairhmm_dp.cu",
            "replaces": "reveal_tpu/hmm/pallas_pairhmm.py:%d" % fn_line,
            "max_abs_err": worst[key],
            "max_abs_err_posterior": worst["post"],
            "shape": "B=128 L1p=513 L2p=640",
            "plan": main["plan"],
            "ms": main[key],
            "plain_ms": main["plain_" + key],
            "bound_ms": main["bound"],
            "bound_by": main["bound_by"],
            "library_ms": None,
            "ms_B32_L1p2049_L2p2176": big[key],
            "plain_ms_B32_L1p2049_L2p2176": big["plain_" + key],
            "bound_ms_B32_L1p2049_L2p2176": big["bound"],
            "plan_B32_L1p2049_L2p2176": big["plan"],
            "ms_B1024_L1p17_L2p128": tiny[key],
        })
        for name, shape in (("chain_B105_L512", "B105_L1p512_L2p512"),
                            ("chain_B15_L2048", "B15_L1p2048_L2p2048")):
            t = times[name]
            rows[-1].update({"ms_" + shape: t[key],
                             "plain_ms_" + shape: t["plain_" + key],
                             "bound_ms_" + shape: t["bound"],
                             "plan_" + shape: t["plan"]})
    return rows


# the MEA-score kernel's latency chain a row (csrc/mea_score.cu): five
# dependent shuffles, two barriers and three shared-memory round trips,
# about 250 clocks (published Hopper latencies; not measured by this
# script) at 1.98 GHz
BLOCK_SCAN_S = 250 / 1.98e9

# the MEA-score shapes: what refine's two-phase route launches on the
# 72-bubble graph, the chain's on it and on the rem GFA, the widest
# bucket of --maxsize 10000, and edge widths
MEA_CASES = (
    ("two-phase B943 513x640", 943, 513, 640, 512),
    ("two-phase B120 2049x2176", 120, 2049, 2176, 2048),
    ("chain B105 512x512", 105, 512, 512, 511),
    ("chain B15 2048x2048", 15, 2048, 2048, 2047),
    ("chain B1024 32x32", 1024, 32, 32, 31),
    ("widest B1 65x16512", 1, 65, 16512, 64),
    ("edge B3 9x4", 3, 9, 4, 8),
    ("edge B2 17x28672", 2, 17, 28672, 16),
    ("edge no rows", 4, 33, 64, 0),
)
# the case of the kernels line until the main path's own inputs replace it
MEA_MAIN_CASE = "chain B105 512x512"


def _mea_bounds(B, L1p, L2p, nrows):
    """(bound ms, bound_by, latency floor ms) of a MEA-score launch: the
    rows scanned read once and the scores written, one add and two maxima
    a cell at the float32 peak; the floor is nrows block scans a wave of
    resident blocks."""
    from reveal_tpu_torch.hmm import mea_score as ms

    nbytes = B * nrows * L2p * 4 + B * 4
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 3 * B * nrows * L2p / F32_OPS_PER_S * 1e3
    threads, _k4 = ms.plan(L2p)
    smem = (2 * L2p + 32) * 4
    per_sm = max(1, min(32, 2048 // threads, 232448 // smem))
    waves = math.ceil(B / (132 * per_sm))
    floor = nrows * BLOCK_SCAN_S * waves * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", floor)


def time_mea(p, nrows, iters):
    """Kernel and plain ms a call (CUDA events; plain, kernel, kernel,
    plain), with the bound and the floor."""
    from reveal_tpu_torch.hmm import mea_score as ms

    ms.mea_score(p, nrows)
    pl1 = _event_ms(lambda: ms.mea_score_plain(p, nrows), 1)
    k1 = _event_ms(lambda: ms.mea_score(p, nrows), iters)
    k2 = _event_ms(lambda: ms.mea_score(p, nrows), iters)
    pl2 = _event_ms(lambda: ms.mea_score_plain(p, nrows), 1)
    bound, by, floor = _mea_bounds(*p.shape, nrows)
    return {"shape": "%d x %d x %d, %d rows" % (*p.shape, nrows),
            "ms": (k1 + k2) / 2, "plain_ms": (pl1 + pl2) / 2,
            "bound_ms": bound, "bound_by": by, "bound_latency_ms": floor}


def check_mea_score(dev):
    """The MEA-score kernel against its plain loop on the card, bit for
    bit, on posterior-like grids at every shape of MEA_CASES (rows beyond
    a pair's length zero, as a batch's shorter pairs have them), with
    the times of both.  Returns the row of the kernels line."""
    import torch

    from reveal_tpu_torch.hmm import mea_score as ms

    gen = torch.Generator(device=dev).manual_seed(5)
    times = []
    for name, B, L1p, L2p, nrows in MEA_CASES:
        p = torch.rand((B, L1p, L2p), generator=gen, device=dev) ** 8
        p[:, 0] = 0.0
        p[:, :, 0] = 0.0
        p[:, nrows + 1:] = 0.0
        short = torch.randint(0, nrows + 1, (B,), generator=gen, device=dev)
        rows = torch.arange(L1p, device=dev)
        p.mul_((rows[None, :] <= short[:, None]).float()[:, :, None])
        got = ms.mea_score(p, nrows)
        ref = ms.mea_score_plain(p, nrows)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError("mea_score %s differs from plain by %g"
                                 % (name, float((got - ref).abs().max())))
        threads, k4 = ms.plan(L2p)
        line = "mea_score %-26s equal to plain (max_abs_err 0); %d threads " \
               "a block, %d columns a thread" % (name, threads, 4 * k4)
        if B * L1p * L2p >= 1 << 20:
            t = time_mea(p, nrows, 10)
            times.append(dict(t, case=name))
            line += ("; per call from CUDA events (plain, kernel x10, "
                     "kernel x10, plain): kernel %.6f ms, plain %.6f ms, "
                     "bound %.6f ms by %s, row-chain floor %.6f ms"
                     % (t["ms"], t["plain_ms"], t["bound_ms"],
                        t["bound_by"], t["bound_latency_ms"]))
        print(line)
        del p
    main = next(t for t in times if t["case"] == MEA_MAIN_CASE)
    return {
        "name": "mea_score",
        "route": "cuda",
        "source": "reveal_tpu_torch/csrc/mea_score.cu",
        "replaces": "reveal_tpu/hmm/msa.py:600",
        "replaces_kind": "XLA-level code (the chain's lax.scan of cummax), "
                         "no Pallas kernel",
        "max_abs_err": 0.0,
        "shape": main["shape"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "bound_latency_ms": main["bound_latency_ms"],
        "library_ms": None,
        "cases": times,
    }


# a chunk of 7 six-path bubbles at Lq 512 and one at Lq 2048
RELAX_SHAPES = ((7, 6, 512), (1, 6, 2048))
# posterior cells of the 72-bubble graph at the least
REFINE_MIN_CELLS = 200_000_000


def time_relaxation(dev):
    """The consistency products on the card against their flop bound: two
    relaxation rounds (``msa.consistency_rounds``, float32, TF32 off) of
    the chain's two bucket shapes on the 72-bubble graph."""
    import torch

    from reveal_tpu_torch.hmm import msa

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for float32 matrix products")
    gen = torch.Generator(device=dev).manual_seed(9)
    out = []
    for B, N, Lq in RELAX_SHAPES:
        Q = torch.rand((B, N, N, Lq, Lq), generator=gen, device=dev)
        Q = torch.where(Q > 0.999, Q * 10, torch.zeros((), device=dev))
        Q = (Q + Q.transpose(1, 2).transpose(-1, -2)) / 2
        d = torch.arange(N, device=dev)
        Q[:, d, d] = torch.eye(Lq, device=dev)
        msa.consistency_rounds(Q.clone(), 2, False)
        ms = (_event_ms(lambda: msa.consistency_rounds(Q.clone(), 2, False),
                        3)
              + _event_ms(lambda: msa.consistency_rounds(Q.clone(), 2,
                                                         False), 3)) / 2
        flops = 2 * B * N * (N - 1) // 2 * (N - 2) * 2 * Lq ** 3
        bound = flops / F32_OPS_PER_S * 1e3
        print("consistency rounds B=%d N=%d Lq=%d, 2 rounds (%d float32 "
              "products of %d x %d, TF32 off): %.6f ms a call (CUDA events, "
              "two turns of 3, with the clone of Q), %.3e flops, bound %.6f "
              "ms at 67 TFLOP/s (%.1f%% of it)"
              % (B, N, Lq, 2 * B * N * (N - 1) // 2 * (N - 2), Lq, Lq, ms,
                 flops, bound, 100.0 * bound / ms))
        out.append({"shape": "B=%d N=%d Lq=%d" % (B, N, Lq), "ms": ms,
                    "bound_ms": bound})
    return out


def check_against_native(dev, seed):
    """The card's cut posteriors, totals and MEA scores against the
    native float64-exact host pair-HMM on pairs of both buckets."""
    import numpy as np

    from reveal_tpu_torch.hmm import msa
    from reveal_tpu_torch.hmm import pairhmm_dp as dp

    rng = np.random.default_rng(seed + 100)
    pairs = (_related_pairs(rng, 12, 300, 512)
             + _related_pairs(rng, 4, 1100, 2048)
             + [("A", "A"), ("ACGT", "AGT"), ("ACGTNNAC", "acgtac")])
    dev_res = msa.batch_posteriors_cut(pairs, device=dev)
    nat_res = msa.batch_posteriors_cut_native(pairs)
    dense = dp.batch_posteriors_dp(pairs, dev)
    worst_p = worst_s = worst_t = worst_scan = 0.0
    for (s1, s2), (pd, td, sd), (pn, tn, sn), (pfull, _t) in zip(
            pairs, dev_res, nat_res, dense):
        gate = max(2e-3, 4e-5 * max(len(s1), len(s2)))
        a = pd.dense()
        err = np.abs(a - pn)
        # a cell within the gate of the 0.01 cut may survive on one side
        # only
        at_cut = ((a == 0) | (pn == 0)) & (np.maximum(a, pn) < 0.01 + gate)
        err[at_cut] = 0.0
        if err.max(initial=0.0) > gate:
            raise AssertionError(
                "posterior of a %d x %d pair differs from the native "
                "float64 one by %g (gate %g)"
                % (len(s1), len(s2), err.max(), gate))
        # the card's row scan against the host MEA DP of the same matrix
        ref = msa._mea_dp_fast(np.ascontiguousarray(pfull))[1]
        scan = abs(sd - ref) / max(1.0, abs(ref))
        if scan > 1e-5:
            raise AssertionError(
                "MEA score %g of a %d x %d pair, the host MEA DP of the "
                "same posterior gives %g" % (sd, len(s1), len(s2), ref))
        worst_scan = max(worst_scan, scan)
        # float32 errors of one pair share their sign (they come from its
        # total) and add up over the aligned bases
        smax = 1e-2 * min(len(s1), len(s2))
        if abs(sd - sn) > smax:
            raise AssertionError("MEA score %g vs native %g (limit %g)"
                                 % (sd, sn, smax))
        worst_p = max(worst_p, float(err.max(initial=0.0)))
        worst_s = max(worst_s, abs(sd - sn) / min(len(s1), len(s2)))
        worst_t = max(worst_t, abs(td - tn))
    print("card vs native float64 pair-HMM on %d pairs: posterior err "
          "%.3e (gate max(2e-3, 4e-5 L)), MEA score err %.3e per base "
          "(limit 1e-2), total log-prob err %.3e; MEA score vs the host "
          "MEA DP of the card's own posterior: %.3e relative (limit 1e-5)"
          % (len(pairs), worst_p, worst_s, worst_t, worst_scan))


def run_rem(fastas, total_bp, workdir):
    """Port CLI on the card vs the port's host engine; returns the repair
    kernel's launches, the GFA path and the end-to-end seconds."""
    from reveal_tpu_torch import cli
    from reveal_tpu_torch.align.rem import align_genomes_host
    from reveal_tpu_torch.core.io_gfa import seq2node, write_gfa
    from reveal_tpu_torch.index import devloop, repair
    from reveal_tpu_torch.index import window_resolve as wr

    t0 = time.perf_counter()
    G, idx = align_genomes_host(fastas)
    seq2node(G, idx.main.T)
    host_gfa = write_gfa(G, idx.main.T,
                         outputfile=os.path.join(workdir, "host.gfa"))
    t_host = time.perf_counter() - t0
    print("host engine (the port's serial native recursion): %.6f s"
          % t_host)

    port_gfa = os.path.join(workdir, "port.gfa")
    wr.LAUNCHES = 0
    repair.LAUNCHES = 0
    t0 = time.perf_counter()
    cli.main(["rem", *fastas, "--frontier", "--device", "cuda",
              "-o", port_gfa])
    t_e2e = time.perf_counter() - t0
    launches = repair.LAUNCHES
    wr_launches = wr.LAUNCHES
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
    if not st["forest"] > 0 or not st["repair_applied"] > 0:
        raise AssertionError("forest or repair did not run: %r" % st)
    # two passes a level (A side, B side) in every dispatch
    passes = st["repair_rounds_total"]
    if not (launches > 0 and launches == st["repair_launches"] == passes
            and (st["dispatches"] > 1 or passes == 2 * st["levels"])):
        raise AssertionError(
            "repair_pass launched %d times for %d passes (%d levels, %d "
            "dispatches)" % (launches, passes, st["levels"],
                             st["dispatches"]))
    if wr_launches != 0:
        raise AssertionError("window_resolve launched %d times on rem"
                             % wr_launches)
    print("rem: GFA byte-identical to the host engine's (%d bytes)"
          % len(port_bytes))
    print(
        "forest: roots=%d slots=%d levels=%d repair passes=%d (repair_pass "
        "launches %d, window_resolve launches 0) anchors=%d dispatches=%d "
        "chain_steps=%d trim_steps=%d; repair candidates applied %d, "
        "longest run %d, moved slots %d"
        % (st["forest"], st["slots"], st["levels"], passes, launches,
           st["anchors"], st["dispatches"], st["chain_steps"],
           st["trim_steps"], st["repair_applied"], st["repair_chain_max"],
           st["repair_moved_slots"])
    )
    print(
        "rem times: host_prefix %.6f s, forest %.6f s, end-to-end (fasta "
        "-> GFA, CLI in-process) %.6f s, %.6f Mbp/s (%d input bp)"
        % (st["host_prefix_seconds"], st["forest_seconds"], t_e2e,
           total_bp / 1e6 / t_e2e, total_bp)
    )
    return launches, port_gfa, t_e2e


# the profiler's names of a kernel launch from the host
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchKernelExC")


def run_traced(run):
    """``run()`` with the program's stage spans on (``core/trace.py``);
    returns (the last command's record ``trace.LAST_STATS``, the seconds
    of the run)."""
    from reveal_tpu_torch.core import trace

    was = trace.enable(True)
    try:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    finally:
        trace.enable(was)
    return dict(trace.LAST_STATS), wall


def _trace_text(rec, prefix):
    """The record's spans whose label starts with ``prefix``."""
    from reveal_tpu_torch.core import trace

    return ", ".join(
        "%s %.6f s (self %.6f s, %d calls, %d reads waiting %.6f s)"
        % (label, rec[label], rec[label + ".self"], rec[label + ".calls"],
           rec[label + ".reads"], rec[label + ".wait"])
        for label in trace.LABELS
        if label.startswith(prefix) and label in rec)


def trace_counts(prof, mark=None):
    """Calls by name (host side) and (microseconds, calls) by name (the
    card's kernels and copies) from the raw events of a finished
    ``torch.profiler`` run, in one pass and without building its event
    tree (which takes minutes at a few hundred thousand launches).  With
    ``mark``, the name of ``record_function`` ranges, also the ranges'
    numbers: calls, traced seconds, the launches and host syncs made
    inside them, and the device time of the kernels and copies those
    ranges' operations started (matched by the profiler's correlation
    ids).  The ranges' own spans on the card's timeline are not device
    time."""
    import numpy as np
    from torch.autograd import DeviceType

    counts, device = {}, {}
    spans, host, linked = [], [], []
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        if evt.device_type() == DeviceType.CUDA:
            if name == mark:
                continue
            dur = evt.duration_ns()
            us, n = device.get(name, (0.0, 0))
            device[name] = (us + dur / 1e3, n + 1)
            if mark:
                linked.append((evt.linked_correlation_id(), dur))
        else:
            counts[name] = counts.get(name, 0) + 1
            if mark:
                t = evt.start_ns()
                if name == mark:
                    spans.append((t, t + evt.duration_ns()))
                else:
                    host.append((t, evt.correlation_id(),
                                 name in LAUNCH_CALLS,
                                 name == "cudaStreamSynchronize"))
    if not mark:
        return counts, device, None
    spans.sort()
    lo = np.array([a for a, _b in spans], dtype=np.int64)
    hi = np.array([b for _a, b in spans], dtype=np.int64)
    t = np.array([h[0] for h in host], dtype=np.int64)
    k = np.searchsorted(lo, t, side="right") - 1
    inside = (k >= 0) & (t < hi[np.maximum(k, 0)]) if len(lo) else (
        np.zeros(len(t), bool))
    corr = {h[1] for h, ok in zip(host, inside) if ok}
    return counts, device, {
        "calls": len(spans),
        "traced_s": float((hi - lo).sum()) / 1e9,
        "launches": sum(h[2] for h, ok in zip(host, inside) if ok),
        "host_syncs": sum(h[3] for h, ok in zip(host, inside) if ok),
        "device_s": sum(d for c, d in linked if c in corr) / 1e9,
    }


def profile_loop(module, fn_name, run, mark=None):
    """``run()`` with each call of ``module.fn_name`` traced under
    ``torch.profiler`` (the last call's trace is kept).  Host syncs are
    the ``cudaStreamSynchronize`` calls (the host waits for the card);
    ``scalar_reads`` counts ``aten::_local_scalar_dense`` (``.item()``,
    ``int()``, ``bool()`` of a device value), a subset of them.  With
    ``mark``, the numbers of its ranges are under "marked"
    (``trace_counts``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn = getattr(module, fn_name)
    traced = {}

    def profiled(*args, **kw):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            traced["wall"] = time.perf_counter() - t0
        traced["prof"] = prof
        return res

    setattr(module, fn_name, profiled)
    try:
        run()
    finally:
        setattr(module, fn_name, fn)
    counts, device, marked = trace_counts(traced.pop("prof"), mark)
    device_us = sum(us for us, _n in device.values())
    return {
        "launches": sum(v for k, v in counts.items() if k in LAUNCH_CALLS),
        "host_syncs": counts.get("cudaStreamSynchronize", 0),
        "scalar_reads": counts.get("aten::_local_scalar_dense", 0),
        "memcpy": counts.get("cudaMemcpyAsync", 0),
        "device_s": device_us / 1e6,
        "traced_wall_s": traced["wall"],
        "busy": ("%.1f%%" % (100.0 * device_us / 1e6 / traced["wall"])
                 if device_us > 0 else
                 "not measured (no device time traced)"),
        "device": sorted(((us, n, k) for k, (us, n) in device.items()),
                         reverse=True),
        "marked": marked,
    }


def print_profile(what, prof, extra=""):
    print("%s under torch.profiler: %d kernel launches, %d host syncs "
          "(cudaStreamSynchronize; of them %d aten::_local_scalar_dense; "
          "%d cudaMemcpyAsync)%s; device time %.6f s over a traced wall of "
          "%.6f s: card busy %s"
          % (what, prof["launches"], prof["host_syncs"],
             prof["scalar_reads"], prof["memcpy"], extra, prof["device_s"],
             prof["traced_wall_s"], prof["busy"]))
    for us, count, key in prof["device"][:6]:
        print("  device %.6f s in %d calls of %s" % (us / 1e6, count,
                                                    key[:90]))


def attribute_syncs(module, fn_name, run):
    """``run()`` with torch's sync debug mode set to warn inside each call
    of ``module.fn_name``: every operation that makes the host wait for
    the card is put to the innermost line of the port's own code that
    made it.  Returns [(count, "file:line"), ...], the most first."""
    import warnings

    import torch

    fn = getattr(module, fn_name)
    sites = {}
    mark = os.sep + "reveal_tpu_torch" + os.sep

    def showwarning(message, category, filename, lineno, file=None,
                    line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        frame = sys._getframe(1)
        while frame is not None and mark not in frame.f_code.co_filename:
            frame = frame.f_back
        site = ("%s:%d" % (frame.f_code.co_filename.split(mark)[-1],
                           frame.f_lineno) if frame is not None else
                "%s:%d" % (filename, lineno))
        sites[site] = sites.get(site, 0) + 1

    def watched(*args, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = showwarning
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")

    setattr(module, fn_name, watched)
    try:
        run()
    finally:
        setattr(module, fn_name, fn)
    return sorted(((n, k) for k, n in sites.items()), reverse=True)


def profile_forest(fastas, total_bp, workdir, label):
    """``rem`` three times more through the CLI, the forest watched: a
    warm-up run, a run with the program's stage spans on (``run_traced``),
    and a run with ``rem_device_forest`` traced (``profile_loop``)."""
    from reveal_tpu_torch import cli
    from reveal_tpu_torch.index import devloop

    out = os.path.join(workdir, "profile.gfa")

    def rem():
        cli.main(["rem", *fastas, "--frontier", "--device", "cuda", "-o",
                  out])

    t0 = time.perf_counter()
    rem()
    t_first = time.perf_counter() - t0
    rec, t_e2e = run_traced(rem)
    st = dict(devloop.LAST_STATS)
    print("%s rem (first run in the process %.6f s end to end), then with "
          "the stage spans on: %s; a level's stages: %s; %d host syncs; "
          "forest %.6f s, host prefix %.6f s, end to end %.6f s (%.6f "
          "Mbp/s)"
          % (label, t_first, _trace_text(rec, "rem."),
             _trace_text(rec, "level."), st["host_syncs"],
             st["forest_seconds"], st["host_prefix_seconds"], t_e2e,
             total_bp / 1e6 / t_e2e))
    prof = profile_loop(devloop, "rem_device_forest", rem)
    print_profile("%s forest" % label, prof)
    for us, count, key in prof["device"]:
        if "repair_pass" in key or "window_resolve" in key:
            print("  the port's own kernel %s: device %.6f s in %d calls, "
                  "%.6f ms a call" % (key[:90], us / 1e6, count,
                                      us / 1e3 / count))


# ----------------------------------------------------------------------
# phase 5c: multi-genome rem on the card
# ----------------------------------------------------------------------
# (label, genomes, bp a genome, the sample whose genome is cut into two
# contigs or None); every case at the CLI's defaults (-m 20, -n 2,
# --maxmums 10000)
MULTI_CASES = (
    ("a", 6, 100_000, None),     # the main case: 9,360 root multiMUMs
    ("b", 8, 50_000, None),      # D = 8 paths, the loop's full width
    ("c", 3, 300_000, 0),        # 4 paths of 3 samples
)


def write_population(n, length, seed, workdir, split=None, cuts=None):
    """Fastas of ``simulate_population(n, length, seed)`` in a new
    directory under ``workdir``: the genome of sample ``split`` cut in
    two contigs, or every genome cut into contigs of the lengths ``cuts``
    and the rest; returns (paths, total bp, {record name: sequence})."""
    from reveal_tpu_torch.core.io_fasta import fasta_writer
    from reveal_tpu_torch.utils.simulate import simulate_population

    wd = tempfile.mkdtemp(dir=workdir, prefix="pop%d_%d_" % (n, length))
    fastas, want = [], {}
    for i, (name, seq, _ids) in enumerate(
            simulate_population(n, length, seed=seed)):
        bounds = [0, len(seq) // 2] if i == split else [0]
        for c in cuts or ():
            bounds.append(bounds[-1] + c)
        bounds.append(len(seq))
        recs = [(name if len(bounds) == 2 else "%s_%d" % (name, k + 1),
                 seq[lo:hi])
                for k, (lo, hi) in enumerate(zip(bounds, bounds[1:]))]
        fn = os.path.join(wd, name + ".fa")
        fasta_writer(fn, recs)
        fastas.append(fn)
        want.update(recs)
    return fastas, sum(len(v) for v in want.values()), want


def host_gfa(fastas, out):
    """The port's serial host engine on ``fastas``, written as the CLI
    writes a GFA of more than two paths; returns seconds."""
    from reveal_tpu_torch.align.graphops import prune_nodes
    from reveal_tpu_torch.align.rem import align_genomes_host
    from reveal_tpu_torch.core.io_gfa import seq2node, write_gfa

    t0 = time.perf_counter()
    G, idx = align_genomes_host(fastas)
    if len(G.graph["paths"]) > 2:
        prune_nodes(G, T=idx.main.T)
    seq2node(G, idx.main.T)
    write_gfa(G, idx.main.T, outputfile=out)
    return time.perf_counter() - t0


def run_multi_case(label, fastas, total_bp, workdir):
    """One multi case through ``cli rem --device cuda``, its GFA held
    byte for byte against the host engine's; returns LAST_STATS with the
    window-resolve launches counted around the run."""
    import torch

    from reveal_tpu_torch import cli
    from reveal_tpu_torch.index import devloop_multi, repair
    from reveal_tpu_torch.index import window_resolve as wr

    t_host = host_gfa(fastas, os.path.join(workdir, "host_%s.gfa" % label))
    out = os.path.join(workdir, "port_%s.gfa" % label)
    torch.cuda.reset_peak_memory_stats()
    wr.LAUNCHES = 0
    repair.LAUNCHES = 0
    t0 = time.perf_counter()
    cli.main(["rem", *fastas, "--frontier", "--device", "cuda", "-o", out])
    t_e2e = time.perf_counter() - t0
    launches = wr.LAUNCHES
    st = dict(devloop_multi.LAST_STATS, launches=launches, e2e=t_e2e,
              host=t_host, peak=torch.cuda.max_memory_allocated())
    with open(os.path.join(workdir, "host_%s.gfa" % label), "rb") as fh:
        host_bytes = fh.read()
    with open(out, "rb") as fh:
        port_bytes = fh.read()
    if host_bytes != port_bytes:
        raise AssertionError(
            "multi case %s: port GFA (%d bytes) differs from the host "
            "engine's (%d bytes)" % (label, len(port_bytes), len(host_bytes)))
    if st.get("abort") != 0 or st.get("fallback") is not None:
        raise AssertionError("multi case %s: the loop did not finish: %r"
                             % (label, st))
    if not (launches > 0 and launches == st["window_resolve_launches"]
            == st["repair_rounds_total"]) or repair.LAUNCHES:
        raise AssertionError(
            "multi case %s: window_resolve launched %d times for %d repair "
            "rounds (repair_pass %d times)"
            % (label, launches, st["repair_rounds_total"], repair.LAUNCHES))
    print("multi case %s (%s): GFA byte-identical to the host engine's (%d "
          "bytes); %d paths, %d slots, caps %s; levels %d, repair rounds %d "
          "in %d passes (window_resolve launches %d, candidates applied %d, "
          "longest run %d, moved slots %d), chain column steps %d, trim "
          "rows %d, anchors %d, dispatches %d, host reads of the loop %d; "
          "loop %.6f s, end to end (fastas -> GFA, CLI in-process) %.6f s "
          "(%.6f Mbp/s), host engine %.6f s; peak device memory %.6f GB"
          % (label, ", ".join(os.path.basename(f) for f in fastas),
             len(port_bytes), st["paths"], st["slots"], st["caps"],
             st["levels"], st["repair_rounds_total"], st["repair_passes"],
             launches, st["repair_applied"], st["repair_chain_max"],
             st["repair_moved_slots"], st["chain_steps"], st["trim_steps"],
             st["anchors"], st["dispatches"], st["host_syncs"],
             st["loop_seconds"], t_e2e, total_bp / 1e6 / t_e2e, t_host,
             st["peak"] / 1e9))
    return st


def _cli_rem(fastas, out):
    from reveal_tpu_torch import cli

    return lambda: cli.main(["rem", *fastas, "--frontier", "--device",
                             "cuda", "-o", out])


def clock_multi(fastas, workdir):
    """Case (a) again with the program's stage spans on (``run_traced``)."""
    from reveal_tpu_torch.index import devloop_multi

    rec, _wall = run_traced(
        _cli_rem(fastas, os.path.join(workdir, "clock.gfa")))
    loop = devloop_multi.LAST_STATS["loop_seconds"]
    stages = sum(v for k, v in rec.items()
                 if k.startswith("multi.") and k.count(".") == 1)
    print("multi case a with the stage spans on: %s; a level's stages: "
          "%s; loop %.6f s (the stages %.6f s), %d host syncs waiting "
          "%.6f s"
          % (_trace_text(rec, "rem."), _trace_text(rec, "multi."), loop,
             stages, rec["reads"], rec["wait"]))


def profile_multi(label, fastas, workdir):
    """A multi case again with ``rem_device_multi`` traced
    (``profile_loop``): kernel launches, host syncs, device time and the
    card's busy share of the traced loop."""
    from reveal_tpu_torch.index import devloop_multi

    prof = profile_loop(
        devloop_multi, "rem_device_multi",
        _cli_rem(fastas, os.path.join(workdir, "profile_%s.gfa" % label)))
    print_profile("multi case %s" % label, prof,
                  ", the loop's own counted reads %d"
                  % devloop_multi.LAST_STATS["host_syncs"])
    return {k: prof[k] for k in ("launches", "host_syncs", "scalar_reads",
                                 "busy", "device_s", "traced_wall_s")}


def sync_sites_multi(fastas, workdir):
    """Case (a) again with every host sync of the loop put to the line of
    the port that made it (``attribute_syncs``)."""
    from reveal_tpu_torch.index import devloop_multi

    sites = attribute_syncs(
        devloop_multi, "rem_device_multi",
        _cli_rem(fastas, os.path.join(workdir, "syncs.gfa")))
    total = sum(n for n, _k in sites)
    print("multi case a under torch.cuda.set_sync_debug_mode('warn'): %d "
          "synchronizing operations at %d lines of the port (the loop's own "
          "counted reads %d); by line: %s"
          % (total, len(sites), devloop_multi.LAST_STATS["host_syncs"],
             ", ".join("%s %d" % (k, n) for n, k in sites)))
    return total


def hold_window_resolve(fastas, workdir):
    """Case (a) again with ``window_resolve`` wrapped: every repair round's
    (LCP, q, thr) goes through the plain version, the kernel, the kernel
    and the plain version, each between two CUDA events, the results held
    exactly equal; then the round goes on with the kernel's.  Returns the
    kernel's mean time, the plain version's, and the bound by bytes (the
    LCP words of the windows, q, thr and the result) at the path's own
    shapes."""
    import torch

    from reveal_tpu_torch import cli
    from reveal_tpu_torch.index import window_resolve as wr

    kernel = wr.window_resolve
    rounds = []
    worst = 0

    def hold(lcp, q, thr, wrv=WRV):
        nonlocal worst
        times = {wr.window_resolve_plain: [], kernel: []}
        outs = {}
        for fn in (wr.window_resolve_plain, kernel, kernel,
                   wr.window_resolve_plain):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            outs[fn] = fn(lcp, q, thr, wrv)
            stop.record()
            torch.cuda.synchronize()
            times[fn].append(start.elapsed_time(stop))
        got, ref = outs[kernel], outs[wr.window_resolve_plain]
        worst = max(worst, int((got.long() - ref.long()).abs().max()))
        if worst:
            bad = int((got != ref).nonzero()[0, 0])
            raise AssertionError(
                "window_resolve differs from plain in repair round %d at r=%d "
                "(q=%d thr=%d): %d vs %d" % (len(rounds), bad, int(q[bad]),
                                             int(thr[bad]), int(got[bad]),
                                             int(ref[bad])))
        nbytes = q.numel() * wrv * 4 + 3 * q.numel() * 4
        rounds.append((sum(times[kernel]) / 2,
                       sum(times[wr.window_resolve_plain]) / 2, nbytes,
                       q.numel(), lcp.numel()))
        return got

    wr.window_resolve = hold
    try:
        cli.main(["rem", *fastas, "--frontier", "--device", "cuda", "-o",
                  os.path.join(workdir, "hold.gfa")])
    finally:
        wr.window_resolve = kernel
    k = len(rounds)
    ms = sum(r[0] for r in rounds) / k
    plain_ms = sum(r[1] for r in rounds) / k
    bound_ms = sum(r[2] for r in rounds) / k / HBM_BYTES_PER_S * 1e3
    print("window_resolve on the multi path: equal to plain on all %d repair "
          "rounds of case a (RBV %d, npad %d); per call from CUDA events "
          "(plain, kernel, kernel, plain): kernel %.6f ms (sum %.6f), plain "
          "%.6f ms (sum %.6f), bound by bytes %.6f ms a call"
          % (k, rounds[0][3], rounds[0][4], ms, sum(r[0] for r in rounds),
             plain_ms, sum(r[1] for r in rounds), bound_ms))
    return {"rounds": k, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "rbv": rounds[0][3], "npad": rounds[0][4], "max_abs_err": worst}


def run_multi(seed, workdir):
    """Phase 5c.  Returns the window-resolve row's update (the multi
    path's launches, case a, and the kernel's times at its shapes) and
    case (a)'s (fastas, host-engine GFA, {record: sequence})."""
    cases = {}
    for label, n, length, split in MULTI_CASES:
        fastas, total_bp, want = write_population(n, length, seed, workdir,
                                                  split)
        st = run_multi_case(label, fastas, total_bp, workdir)
        if label == "a":
            st["profile"] = profile_multi(label, fastas, workdir)
            # phase 7 (a) runs align on these genomes against this GFA
            case_a = (fastas, os.path.join(workdir, "host_a.gfa"), want)
        cases[label] = (fastas, st)
    fastas_a, st_a = cases["a"]
    clock_multi(fastas_a, workdir)
    sync_sites_multi(fastas_a, workdir)
    held = hold_window_resolve(fastas_a, workdir)
    if held["rounds"] != st_a["launches"]:
        raise AssertionError("the held run made %d rounds, the main run %d"
                             % (held["rounds"], st_a["launches"]))
    return case_a, {
        "launches": st_a["launches"],
        "main_path": "rem, 3+ genomes: multi-loop repair rounds",
        "ms": held["ms"], "plain_ms": held["plain_ms"],
        "bound_ms": held["bound_ms"], "bound_by": "bytes",
        "max_abs_err": held["max_abs_err"],
        "path_shape": {"rbv": held["rbv"], "npad": held["npad"],
                       "wrv": WRV},
        "multi_cases": {
            label: {k: st[k] for k in ("paths", "levels", "launches",
                                       "host_syncs", "loop_seconds", "e2e",
                                       "host", "peak", "profile")
                    if k in st}
            for label, (_f, st) in cases.items()},
    }


# ----------------------------------------------------------------------
# phase 5f: the multi chain's score pass, kernel against plain
# ----------------------------------------------------------------------
# panel_1a1f-shaped jobs (genomes, bp a genome), one a seed
CHAIN_PANEL = (6, 80_000)
CHAIN_SEEDS = 2
# int32 lanes of the card (132 SMs x 64 a clock at 1.98 GHz) and of one SM
SM_INT_OPS_PER_S = 64 * 1.98e9
INT_OPS_PER_S = 132 * SM_INT_OPS_PER_S
# synthetic levels past the panel's: (D, rows, columns); the last is past
# the shared-memory layout of (1 + D) * (W + 1) words, so its rows work
# in device memory
CHAIN_SYNTHETIC = ((8, 200, 1000), (3, 60, 2500), (8, 3, 7000))


def _chain_bounds(dS, dE, dalb, hbp, W):
    """(bound by operations ms, latency floor ms, operations, widest
    walk) of one level of the score pass.  Operations: each pair i < j of
    live columns of a row costs 2D + 1 (deltas, tests, the maximum), a
    compatible one 2 more (the score) and 4 a present path pair
    (difference, absolute value, sum, mask).  The busiest SM bounds them:
    one row a block, so a row's work against one SM's int32 lanes, or the
    whole level against the card's.  The floor: the widest row's live
    columns, one block reduction and barrier each (BLOCK_SCAN_S)."""
    import torch

    D, R, _W1 = dS.shape
    alive = dalb[:, :W]
    npair_r = hbp.sum(0).to(torch.int64)
    lower = torch.ones(W, W, dtype=torch.bool, device=dS.device).tril(-1)
    ops_r = torch.zeros(R, dtype=torch.int64, device=dS.device)
    step = max(1, (1 << 26) // max(1, D * W * W))
    for r0 in range(0, R, step):
        r1 = min(R, r0 + step)
        ok = ((dS[:, r0:r1, :W, None] - dE[:, r0:r1, None, :W]) >= 0).all(0)
        live = alive[r0:r1, :, None] & alive[r0:r1, None, :] & lower
        npairs = live.sum((1, 2))
        ncompat = (live & ok).sum((1, 2))
        ops_r[r0:r1] = (npairs * (2 * D + 1)
                        + ncompat * (2 + 4 * npair_r[r0:r1]))
    ops = int(ops_r.sum())
    by_ops = max(ops / INT_OPS_PER_S, int(ops_r.max()) / SM_INT_OPS_PER_S)
    walk = int(alive.sum(1).max())
    return by_ops * 1e3, walk * BLOCK_SCAN_S * 1e3, ops, walk


def _hold_chain_level(args, label):
    """One level's planes through the kernel (a warm-up, then two timed)
    and the plain loop on the card, each between CUDA events; the two
    held bit-equal.  Returns (kernel ms, plain ms, _chain_bounds)."""
    import torch

    from reveal_tpu_torch.index import chain_score

    got = chain_score.chain_scores(*args)
    k_ms = _event_ms(lambda: chain_score.chain_scores(*args), 2)
    pl_ms = _event_ms(lambda: chain_score.chain_scores_plain(*args), 1)
    want = chain_score.chain_scores_plain(*args)
    if not torch.equal(got, want):
        r, j = (got != want).nonzero()[0].tolist()
        raise AssertionError(
            "chain score kernel differs from plain at %s, row %d column "
            "%d: %d vs %d" % (label, r, j, int(got[r, j]), int(want[r, j])))
    dS, dE, dalb, _dL, _dwl, _mulr, hbp, _pairs, _wp, W = args
    return k_ms, pl_ms, _chain_bounds(dS, dE, dalb, hbp, W)


def _chain_planes(rng, D, R, W, dev):
    """Random planes as chain_dense_multi builds them: near-sorted
    positions, every third row shorter, about 3 in 4 paths present."""
    import numpy as np
    import torch

    from reveal_tpu_torch.index import chain_score

    def t(a, dtype=torch.int32):
        return torch.as_tensor(a, dtype=dtype, device=dev).contiguous()

    haveD = rng.random((D, R)) < 0.75
    haveD[:2] = True
    n = np.where(np.arange(R) % 3 == 0, rng.integers(0, W + 1, R), W)
    dalb = np.arange(W + 1)[None, :] < n[:, None]
    dalb[:, W] = True
    dL = rng.integers(20, 200, (R, W + 1))
    dS = (np.arange(W + 1)[None, None, :] * 150
          + rng.integers(-400, 400, (D, R, W + 1)))
    hv = dalb[None] & haveD[:, :, None]
    dE = np.where(hv, dS + np.where(np.arange(W + 1) < W, dL, 0)[None], 0)
    dS = np.where(hv, dS, 0)
    pairs = chain_score.pair_index(D, dev)
    ia, ib = (p.cpu().numpy() for p in pairs)
    return (t(dS), t(dE), t(dalb, torch.bool), t(dL),
            t(rng.integers(-1000, 5000, (R, W + 1))),
            t(rng.integers(1, 16, R)), t(haveD[ia] & haveD[ib], torch.bool),
            pairs, 1, W)


def run_chain_scores(seed, workdir):
    """Phase 5f.  The chain score kernel against its plain loop on the
    card, bit for bit, on every level's planes of panel_1a1f-shaped jobs
    (6 x 80 kbp through ``cli rem --device cuda``, one a seed, the planes
    recorded at the wrapper) and on synthetic levels past them; each
    level's R, W, the kernel's and the plain loop's times (CUDA events),
    the bound by operations and the latency floor.  Checks one launch a
    level with candidate columns.  Returns a summary a job."""
    import numpy as np
    import torch

    from reveal_tpu_torch import cli
    from reveal_tpu_torch.index import chain_score, devloop_multi
    from reveal_tpu_torch.kernels import build

    lib = build.load_library()
    wrapper = chain_score.chain_scores
    jobs = []
    for k in range(CHAIN_SEEDS):
        fastas, _bp, _want = write_population(*CHAIN_PANEL, seed + k,
                                              workdir)
        levels = []

        def record(*args):
            levels.append(args)
            return wrapper(*args)

        chain_score.chain_scores = record
        before = chain_score.LAUNCHES
        t0 = time.perf_counter()
        try:
            cli.main(["rem", *fastas, "--device", "cuda", "-o",
                      os.path.join(workdir, "chain_%d.gfa" % k)])
        finally:
            chain_score.chain_scores = wrapper
        t_job = time.perf_counter() - t0
        st = devloop_multi.LAST_STATS
        wide = [a for a in levels if a[-1] > 0]
        if (st.get("abort") != 0 or st["dispatches"] != 1
                or st["chain_score_launches"] != len(wide)
                or chain_score.LAUNCHES - before != len(wide)
                or st["chain_steps"] != sum(a[-1] for a in levels)):
            raise AssertionError(
                "seed %d: %d chain score launches for %d levels with "
                "columns of %d chained (%r)"
                % (seed + k, st.get("chain_score_launches", -1), len(wide),
                   len(levels), {key: st.get(key) for key in (
                       "abort", "dispatches", "levels", "chain_steps")}))
        rows = []
        for i, args in enumerate(wide):
            k_ms, pl_ms, (b_ms, f_ms, ops, walk) = _hold_chain_level(
                args, "seed %d level %d" % (seed + k, i))
            rows.append((args[0].shape[1], args[-1], walk, ops, k_ms, pl_ms,
                         b_ms, f_ms))
        print("chain score, seed %d (6 x %d bp, rem %.3f s, loop %.3f s, %d "
              "levels): kernel equal to plain on all %d levels with "
              "columns; R/W/widest walk: kernel ms, plain ms, bound by "
              "operations ms, latency floor ms: %s"
              % (seed + k, CHAIN_PANEL[1], t_job, st["loop_seconds"],
                 st["levels"], len(wide), "; ".join(
                     "%d/%d/%d: %.6f, %.3f, %.6f, %.6f" % (r[:3] + r[4:])
                     for r in rows)))
        tot = [sum(r[i] for r in rows) for i in range(3, 8)]
        print("chain score, seed %d, the job's levels summed: %d launches, "
              "%d operations; kernel %.6f ms, plain %.3f ms, bound by "
              "operations %.6f ms, latency floor %.6f ms"
              % (seed + k, len(rows), *tot))
        jobs.append({"seed": seed + k, "launches": len(rows), "ops": tot[0],
                     "ms": tot[1], "plain_ms": tot[2], "bound_ms": tot[3],
                     "bound_latency_ms": tot[4],
                     "levels": [r[:2] for r in rows]})
    rng = np.random.default_rng(seed)
    for D, R, W in CHAIN_SYNTHETIC:
        args = _chain_planes(rng, D, R, W, torch.device("cuda"))
        k_ms, pl_ms, (b_ms, f_ms, ops, walk) = _hold_chain_level(
            args, "synthetic D %d R %d W %d" % (D, R, W))
        print("chain score, synthetic D %d R %d W %d (rows in %s): kernel "
              "equal to plain; kernel %.6f ms, plain %.3f ms, %d "
              "operations, bound by operations %.6f ms, latency floor %.6f "
              "ms (widest walk %d)"
              % (D, R, W, "shared memory" if lib.rtt_chain_score_on_chip(
                  D, W) else "device memory", k_ms, pl_ms, ops, b_ms, f_ms,
                 walk))
    return {
        "name": "chain_score_multi",
        "route": "cuda",
        "source": "reveal_tpu_torch/csrc/chain_score_multi.cu",
        "replaces": "reveal_tpu/index/devloop.py _build_kernel_multi",
        "replaces_kind": "XLA-level code (the multi chain's score pass), no "
                         "Pallas kernel",
        "max_abs_err": 0,
        "main_path": "rem, 3-8 paths: the multi loop's chain, a launch a "
                     "level",
        "launches": jobs[0]["launches"],
        "ms": jobs[0]["ms"], "plain_ms": jobs[0]["plain_ms"],
        "bound_ms": jobs[0]["bound_ms"], "bound_by": "operations",
        "bound_latency_ms": jobs[0]["bound_latency_ms"],
        "library_ms": None,
        "jobs": jobs,
    }


# ----------------------------------------------------------------------
# phase 5d: the per-level device frontier
# ----------------------------------------------------------------------
# (label, genomes, bp a genome, lengths of each genome's contigs but the
# last, or None for one contig); every case at the CLI's defaults
FRONTIER_CASES = (
    # the main case: past --maxmums (about 100 kbp a genome at six
    # genomes), so the multi loop declines (ABORT_MAXMUMS) and the frontier
    # takes the input; 6 x 1 Mbp (101,731 root multiMUMs) until the script
    # outgrew its time
    ("a", 6, 500_000, None),
    # a bacterial pair with two plasmids: not a forest input
    ("b", 2, 2_000_000, (1_900_000, 80_000)),
    # nine paths, past the multi loop's eight
    ("c", 9, 50_000, None),
)
# the card against the CPU on the frontier, at the defaults and --notrim
FRONTIER_CARD_CPU = (4, 50_000)


def node_state(G):
    """The aligned node set of a graph (tests/test_frontier.py): every
    interval node with its offsets and aligned flag.  The frontier and
    the serial engine build the same one."""
    return sorted(
        (n, tuple(sorted(G.nodes[n]["offsets"].items())),
         G.nodes[n].get("aligned", 0))
        for n in G.nodes if isinstance(n, tuple))


def _frontier_cli(fastas, out):
    """``cli rem --device cuda`` with ``align_genomes`` watched (the node
    state and text it returns, before the CLI prunes) and the host
    engine refused; returns (what was seen, seconds)."""
    from reveal_tpu_torch import cli
    from reveal_tpu_torch.align import rem

    seen = {}
    align, host_loop = rem.align_genomes, rem._align_loop

    def watched(*args, **kw):
        G, idx = align(*args, **kw)
        seen.update(state=node_state(G), T=idx.main.T.copy(),
                    all_nodes=len(G.nodes),
                    nodes=sum(1 for n in G.nodes if isinstance(n, tuple)))
        return G, idx

    def refused(*_a, **_k):
        raise AssertionError("the host engine ran inside cli rem")

    rem.align_genomes, rem._align_loop = watched, refused
    t0 = time.perf_counter()
    try:
        cli.main(["rem", *fastas, "--frontier", "--device", "cuda", "-o",
                  out])
    finally:
        rem.align_genomes, rem._align_loop = align, host_loop
    return seen, time.perf_counter() - t0


def run_frontier_case(label, fastas, total_bp, want, workdir, declines):
    """One frontier case through ``cli rem --device cuda``: node state
    and text held against the port's host engine, every path of the GFA
    spelling its input; ``declines``: the multi loop must have declined
    first with this abort name.  Returns the frontier's LAST_STATS with
    the run's numbers."""
    import numpy as np
    import torch

    from reveal_tpu_torch.align import rem
    from reveal_tpu_torch.index import devfrontier, devloop_multi

    t0 = time.perf_counter()
    G, idx = rem.align_genomes_host(fastas)
    t_host = time.perf_counter() - t0
    host_state, host_T = node_state(G), idx.main.T.copy()
    del G, idx
    out = os.path.join(workdir, "frontier_%s.gfa" % label)
    torch.cuda.reset_peak_memory_stats()
    seen, t_e2e = _frontier_cli(fastas, out)
    st = dict(devfrontier.LAST_STATS, e2e=t_e2e, host=t_host,
              peak=torch.cuda.max_memory_allocated(), nodes=seen["nodes"],
              all_nodes=seen["all_nodes"], fastas=fastas, gfa=out,
              total_bp=total_bp)
    multi = dict(devloop_multi.LAST_STATS)
    if seen["state"] != host_state:
        raise AssertionError("frontier case %s: node state differs from the "
                             "host engine's (%d against %d nodes)"
                             % (label, len(seen["state"]), len(host_state)))
    if not np.array_equal(seen["T"], host_T):
        raise AssertionError("frontier case %s: the text differs from the "
                             "host engine's" % label)
    if not st.get("levels") or not st.get("applies"):
        raise AssertionError("frontier case %s: the frontier did not run: "
                             "%r" % (label, st))
    if declines and (declines not in str(multi.get("fallback"))
                     or st["fallback"] != multi["fallback"]):
        raise AssertionError("frontier case %s: the multi loop should have "
                             "declined with %s: %r / %r"
                             % (label, declines, multi, st["fallback"]))
    _check_paths(out, want)
    print("frontier case %s (%d fastas, %d bp%s): node state (%d interval "
          "nodes of %d graph nodes) and text equal to the host engine's, "
          "every path spells "
          "its input, host engine not run; levels %d, apply calls %d, "
          "anchor steps %d, candidates %d, repair jobs %d, host syncs %d; "
          "enumerate %.6f s, pick + surgery %.6f s, apply %.6f s, repair "
          "%.6f s, frontier %.6f s, end to end (fastas -> GFA, CLI "
          "in-process) %.6f s (%.6f Mbp/s), host engine %.6f s; peak device "
          "memory %.6f GB"
          % (label, len(fastas), total_bp,
             ("; the multi loop declined (%s)" % multi["fallback"])
             if declines else "", st["nodes"], st["all_nodes"],
             st["levels"], st["applies"], st["steps"], st["candidates"], st["repair_jobs"], st["host_syncs"],
             st["enumerate_seconds"], st["pick_seconds"],
             st["apply_seconds"], st["repair_seconds"], st["seconds"],
             t_e2e, total_bp / 1e6 / t_e2e, t_host, st["peak"] / 1e9))
    return st


def frontier_gfa(fastas, device, out, **cfg):
    """``fastas`` forced onto the frontier (``_align_loop_frontier``) on
    ``device``, written as the CLI writes it; returns the GFA's bytes."""
    import torch

    from reveal_tpu_torch.align import rem

    ts, t, G, root_nodes = rem._read_inputs(fastas)
    idx = rem.ESAIndex.construct(ts, backend="native")
    idx.nodes = root_nodes
    rem._align_loop_frontier(G, t, idx, rem.PickerConfig(**cfg),
                             torch.device(device))
    return rem.write_rem_gfa(G, idx, out)


def run_frontier(seed, workdir, labels="abc"):
    """Phase 5d: cases ``labels`` of (a)-(c) through ``cli rem --device
    cuda`` and (d) the card against the CPU.  Returns {label: the case's
    stats, its fastas and GFA} and, under "d", (d)'s fastas and the
    card's GFA bytes at the defaults."""
    cases = {}
    for label, n, length, cuts in FRONTIER_CASES:
        if label not in labels:
            continue
        fastas, total_bp, want = write_population(n, length, seed, workdir,
                                                  cuts=cuts)
        cases[label] = run_frontier_case(
            label, fastas, total_bp, want, workdir,
            "ABORT_MAXMUMS" if label == "a" else
            "not eligible" if n > 8 else None)
    n, length = FRONTIER_CARD_CPU
    fastas, _bp, _want = write_population(n, length, seed, workdir)
    for cfg in ({}, {"trim": False}):
        got = {dev: frontier_gfa(fastas, dev, os.path.join(
            workdir, "frontier_d_%s.gfa" % dev), **cfg)
            for dev in ("cuda", "cpu")}
        if not cfg:
            cases["d"] = dict(fastas=fastas, gfa=got["cuda"])
        if got["cuda"] != got["cpu"]:
            raise AssertionError("frontier case d%s: GFA on the card (%d "
                                 "bytes) differs from the CPU's (%d bytes)"
                                 % (" --notrim" if cfg else "",
                                    len(got["cuda"]), len(got["cpu"])))
        print("frontier case d (%d x %d bp%s): GFA on the card equal to the "
              "CPU's (%d bytes)" % (n, length, ", --notrim" if cfg else "",
                                    len(got["cuda"])))
    return cases


# ----------------------------------------------------------------------
# phase 5e: the single-root device loop
# ----------------------------------------------------------------------
# bp a genome of each case, simulate_population(2, L, seed): (a) the main
# case, taken whole by the loop with the host prefix and forest stood in
# to decline (the JAX loop on a CPU at seed 1: 27 levels, 4,344 anchors,
# 3 dispatches);
# (b) past the loop's reach: the root's chain needs more than 384
# wavefront rounds (the JAX loop on a CPU at seed 1 aborts with
# ABORT_CHAIN_ROUNDS at level 0), so the per-level frontier takes it;
# (c) the default route with the forest stood in to decline
SINGLE_CASES = (("a", 500_000), ("b", 1_000_000), ("c", 200_000))


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def host_reference(fastas, out):
    """The port's serial host engine on a pair: (node state, text, the
    GFA's bytes as the CLI writes a pair, seconds)."""
    from reveal_tpu_torch.align.rem import align_genomes_host
    from reveal_tpu_torch.core.io_gfa import seq2node, write_gfa

    t0 = time.perf_counter()
    G, idx = align_genomes_host(fastas)
    state, T = node_state(G), idx.main.T.copy()
    seq2node(G, idx.main.T)
    write_gfa(G, idx.main.T, outputfile=out)
    return state, T, _read(out), time.perf_counter() - t0


def profile_split(module, outer, inner, run, count):
    """``profile_loop`` over ``module.outer`` with each call of
    ``module.inner`` marked by ``torch.profiler.record_function``: the
    whole trace's numbers, and under ``inner`` those of the marked calls
    (``trace_counts``) with the sum of ``count(result)`` over them."""
    import torch

    fn = getattr(module, inner)
    mark = "chip_smoke:" + inner
    counted = [0]

    def marked(*args, **kw):
        with torch.profiler.record_function(mark):
            res = fn(*args, **kw)
        counted[0] += count(res)
        return res

    setattr(module, inner, marked)
    try:
        prof = profile_loop(module, outer, run, mark)
    finally:
        setattr(module, inner, fn)
    prof[inner] = dict(prof.pop("marked"), count=counted[0])
    return prof


# devloop.LAST_STATS["fallback"] of a pair whose host prefix and forest
# were stood in to decline (``_single_cli(..., forest=False)``)
NO_FOREST = "forest: stood in"


def _single_cli(fastas, out, forest=True):
    """``cli rem --device cuda`` with the host engine refused
    (``_frontier_cli``); without ``forest`` the host prefix and forest
    decline before they run (a stand-in: no input property is known to
    make them decline), so the single-root loop takes the pair."""
    from reveal_tpu_torch.align import rem
    from reveal_tpu_torch.index import devloop

    def declines(*_a, **_k):
        devloop.LAST_STATS["fallback"] = "stood in"

    hybrid = rem._rem_device_hybrid
    if not forest:
        rem._rem_device_hybrid = declines
    try:
        return _frontier_cli(fastas, out)
    finally:
        rem._rem_device_hybrid = hybrid


def run_single_a(fastas, total_bp, workdir):
    """Case (a): the single-root loop takes the pair whole (the host
    prefix and forest stood in to decline);
    GFA bytes against the host engine's, one repair launch a pass and no
    window-resolve launch; the default route and the host engine timed on
    the same input; the loop again with its stages clocked and under
    ``torch.profiler`` (chain_flat apart).  Returns the repair row's
    numbers of this path."""
    import torch

    from reveal_tpu_torch.index import devloop, repair
    from reveal_tpu_torch.index import window_resolve as wr

    state, _T, host_bytes, t_host = host_reference(
        fastas, os.path.join(workdir, "single_a_host.gfa"))
    out = os.path.join(workdir, "single_a.gfa")
    torch.cuda.reset_peak_memory_stats()
    repair.LAUNCHES = wr.LAUNCHES = 0
    seen, t_e2e = _single_cli(fastas, out, forest=False)
    launches, wr_launches = repair.LAUNCHES, wr.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    st = dict(devloop.LAST_STATS)
    if st.get("abort") != 0 or st.get("fallback") != NO_FOREST or (
            "forest" in st):
        raise AssertionError("the single-root loop did not take case a "
                             "whole: %r" % st)
    if _read(out) != host_bytes or seen["state"] != state:
        raise AssertionError("single-root case a: the GFA (%d bytes) differs "
                             "from the host engine's (%d bytes)"
                             % (len(_read(out)), len(host_bytes)))
    passes = st["repair_rounds_total"]
    if not (launches > 0 and launches == st["repair_launches"] == passes
            and (st["dispatches"] > 1 or passes == 2 * st["levels"])):
        raise AssertionError(
            "repair_pass launched %d times for %d passes (%d levels, %d "
            "dispatches)" % (launches, passes, st["levels"],
                             st["dispatches"]))
    if wr_launches:
        raise AssertionError("window_resolve launched %d times on the "
                             "single-root loop" % wr_launches)
    print("single-root case a (2 x %d bp, the forest stood in to "
          "decline): GFA byte-identical to the host engine's (%d bytes), "
          "host engine not run inside; levels %d, anchors %d, dispatches "
          "%d, chain rounds %d (last dispatch), trim rows %d, repair "
          "passes %d (repair_pass launches %d, window_resolve 0), "
          "candidates applied "
          "%d, longest run %d, moved slots %d; loop %.6f s, end to end "
          "(fastas -> GFA, CLI in-process) %.6f s (%.6f Mbp/s); peak device "
          "memory %.6f GB"
          % (total_bp // 2, len(host_bytes), st["levels"], st["anchors"],
             st["dispatches"], st["chain_steps"], st["trim_steps"], passes,
             launches, st["repair_applied"], st["repair_chain_max"],
             st["repair_moved_slots"], st["loop_seconds"], t_e2e,
             total_bp / 1e6 / t_e2e, peak / 1e9))

    _seen, t_hybrid = _single_cli(
        fastas, os.path.join(workdir, "single_a_hybrid.gfa"))
    hyb = dict(devloop.LAST_STATS)
    if (_read(os.path.join(workdir, "single_a_hybrid.gfa")) != host_bytes
            or hyb.get("fallback") is not None or "forest" not in hyb):
        raise AssertionError("the default route on case a: %r" % hyb)
    print("single-root case a, the same pair: single-root loop %.6f s "
          "(end to end %.6f s); default route (host prefix %.6f s + forest "
          "%.6f s, end to end %.6f s); host engine %.6f s"
          % (st["loop_seconds"], t_e2e, hyb["host_prefix_seconds"],
             hyb["forest_seconds"], t_hybrid, t_host))

    def full():
        _single_cli(fastas, os.path.join(workdir, "single_a_run.gfa"),
                    forest=False)

    rec, t_clock = run_traced(full)
    print("single-root case a with the stage spans on: %s; a level's "
          "stages: %s; loop %.6f s, end to end %.6f s"
          % (_trace_text(rec, "rem."), _trace_text(rec, "level."),
             devloop.LAST_STATS["loop_seconds"], t_clock))
    torch.cuda.reset_peak_memory_stats()
    prof = profile_split(devloop, "rem_device_loop", "chain_flat", full,
                         lambda res: res[-1])
    print_profile("single-root case a (the loop)", prof,
                  "; peak device memory %.6f GB"
                  % (torch.cuda.max_memory_allocated() / 1e9))
    cf = prof["chain_flat"]
    chain_s = rec["level.chain"]
    level_s = sum(v for k, v in rec.items()
                  if k.startswith("level.") and k.count(".") == 1)
    print("single-root case a, chain_flat apart: %d calls (every level of "
          "every dispatch), %d wavefront rounds, %.6f s in its stage span "
          "level.chain (%.6f ms a round; the loop's other stages %.6f s); "
          "traced: %d kernel launches (%.1f a round), %d host syncs, device "
          "time %.6f s of its %.6f s traced"
          % (cf["calls"], cf["count"], chain_s,
             chain_s * 1e3 / max(cf["count"], 1), level_s - chain_s,
             cf["launches"],
             cf["launches"] / max(cf["count"], 1), cf["host_syncs"],
             cf["device_s"], cf["traced_s"]))
    for us, count, key in prof["device"]:
        if "repair_pass" in key:
            print("  the port's own kernel %s: device %.6f s in %d calls, "
                  "%.6f ms a call" % (key[:90], us / 1e6, count,
                                      us / 1e3 / count))

    return dict(launches=launches, levels=st["levels"],
                dispatches=st["dispatches"], loop_seconds=st["loop_seconds"],
                chain_rounds=cf["count"],
                chain_flat_seconds=chain_s,
                profile={k: prof[k] for k in ("launches", "host_syncs",
                                              "busy", "device_s",
                                              "traced_wall_s")})


def run_single_b(fastas, total_bp, want, workdir):
    """Case (b): the forest stood in to decline on a pair past the
    loop's reach: the loop
    aborts at level 0 with ABORT_CHAIN_ROUNDS and the per-level frontier
    takes the input on the card, with the host engine's node state and
    text, every path spelling its input."""
    import numpy as np

    from reveal_tpu_torch.index import devfrontier, devloop

    state, T, host_bytes, t_host = host_reference(
        fastas, os.path.join(workdir, "single_b_host.gfa"))
    out = os.path.join(workdir, "single_b.gfa")
    seen, t_e2e = _single_cli(fastas, out, forest=False)
    st, fr = dict(devloop.LAST_STATS), dict(devfrontier.LAST_STATS)
    why = ("%s; single-root loop: kernel abort code 8 (ABORT_CHAIN_ROUNDS)"
           % NO_FOREST)
    if (st.get("abort") != 8 or st.get("levels") != 1
            or st.get("fallback") != why or fr.get("fallback") != why
            or not fr.get("applies")):
        raise AssertionError("single-root case b: %r / %r" % (st, fr))
    if seen["state"] != state or not np.array_equal(seen["T"], T):
        raise AssertionError("single-root case b: node state or text differ "
                             "from the host engine's")
    _check_paths(out, want)
    print("single-root case b (2 x %d bp, the forest stood in to "
          "decline): the loop declined (%s) after %d dispatches, chain "
          "rounds %d, trim rows %d, in %.6f s; the per-level frontier took "
          "the pair: %d levels, %d apply calls, %d anchor steps, %.6f s; "
          "node state "
          "and text equal to the host engine's, every path spells its "
          "input, GFA bytes %s the host engine's; end to end %.6f s, host "
          "engine %.6f s"
          % (total_bp // 2, st["fallback"], st["dispatches"],
             st["chain_steps"], st["trim_steps"], st["loop_seconds"],
             fr["levels"], fr["applies"], fr["steps"], fr["seconds"],
             "equal to" if _read(out) == host_bytes
             else "differ (node numbering) from", t_e2e, t_host))


def run_single_c(fastas, total_bp, workdir):
    """Case (c): the default route with the forest stood in to decline
    (ABORT_DUP_REF, as the CPU tests do): the single-root loop takes the
    pair on the card, with the host engine's GFA bytes; then again with
    every repair pass held against plain (``hold_repair_passes``).
    Returns the held passes' numbers."""
    from reveal_tpu_torch.index import devloop, repair

    _state, _T, host_bytes, t_host = host_reference(
        fastas, os.path.join(workdir, "single_c_host.gfa"))
    out = os.path.join(workdir, "single_c.gfa")
    forest = devloop.rem_device_forest

    def declines(*_a, **_k):
        devloop.LAST_STATS.clear()
        devloop.LAST_STATS["abort"] = devloop.ABORT_DUP_REF

    def run():
        devloop.rem_device_forest = declines
        try:
            return _single_cli(fastas, out)
        finally:
            devloop.rem_device_forest = forest

    repair.LAUNCHES = 0
    _seen, t_e2e = run()
    st = dict(devloop.LAST_STATS)
    why = "forest: kernel abort code 4 (ABORT_DUP_REF)"
    if (st.get("fallback") != why or st.get("abort") != 0
            or repair.LAUNCHES != st.get("repair_launches")
            or not repair.LAUNCHES or _read(out) != host_bytes):
        raise AssertionError("single-root case c: %r, %d repair launches"
                             % (st, repair.LAUNCHES))
    print("single-root case c (2 x %d bp, the forest stood in to decline): "
          "%s; the single-root loop took the pair: levels %d, repair "
          "passes %d (launches %d), loop %.6f s, end to end %.6f s; GFA "
          "byte-identical to the host engine's (%d bytes, %.6f s)"
          % (total_bp // 2, st["fallback"], st["levels"],
             st["repair_rounds_total"], repair.LAUNCHES, st["loop_seconds"],
             t_e2e, len(host_bytes), t_host))
    held_passes, worst = hold_repair_passes(run)
    if len(held_passes) != st["repair_rounds_total"]:
        raise AssertionError("the held run made %d repair passes, the main "
                             "run %d" % (len(held_passes),
                                         st["repair_rounds_total"]))
    return repair_summary(held_passes, worst, "the single-root loop (case c)")


def run_single(seed, workdir):
    """Phase 5e: cases (a)-(c).  Returns the repair row's numbers of the
    single-root path: case (a)'s, with the passes of case (c) held against
    plain under ``held``."""
    out = {}
    for label, length in SINGLE_CASES:
        fastas, total_bp, want = write_population(2, length, seed, workdir)
        if label == "a":
            out.update(run_single_a(fastas, total_bp, workdir))
        elif label == "b":
            run_single_b(fastas, total_bp, want, workdir)
        else:
            out["held"] = run_single_c(fastas, total_bp, workdir)
    return out


def _check_paths(gfa, want):
    from reveal_tpu_torch.core.io_gfa import read_gfa
    from reveal_tpu_torch.graph.extract import extract

    G = read_gfa(gfa)
    for name, seq in want.items():
        got = extract(G, name)
        if got.upper() != seq.upper():
            raise AssertionError(
                "path %s of %s spells %d bp, its input %d bp, or differs"
                % (name, os.path.basename(gfa), len(got), len(seq)))
    return G


def _expected_batches(st):
    """(two-phase DP batches, chain chunks, chain DP batches) that a
    refine run with these stats makes on the card, reckoned from the
    bubbles' shapes by the rules of ``msa.batch_stage12_device`` and
    ``pairhmm_dp.batches``."""
    from reveal_tpu_torch.hmm import msa
    from reveal_tpu_torch.hmm import pairhmm_dp as dp

    two = sum(math.ceil(c / dp.batch_size(L1p, L2p, "cuda"))
              for (L1p, L2p), c in st["pair_shapes"].items())
    chunks = chain_dp = 0
    for (N, Lq), n in st["chain_shapes"].items():
        maxb = max(1, msa.CHUNK_BYTES // (N * N * Lq * Lq * 4))
        for lo in range(0, n, maxb):
            chunks += 1
            chain_dp += math.ceil(min(maxb, n - lo) * N * (N - 1) // 2
                                  / dp.batch_size(Lq, Lq, "cuda"))
    return two, chunks, chain_dp


def _refine_on_card(gfa, out, label, route, extra=()):
    """One ``cli refine`` run on the card (its default route) with the
    launch counts set to 0 just before it and read just after; checks
    them against the bubbles' shapes.  Returns (launches, stats,
    seconds)."""
    import torch

    from reveal_tpu_torch import cli
    from reveal_tpu_torch.hmm import mea_score
    from reveal_tpu_torch.hmm import pairhmm_dp as dp
    from reveal_tpu_torch.hmm import refine

    torch.cuda.reset_peak_memory_stats()
    dp.LAUNCHES["fwd"] = dp.LAUNCHES["bwd"] = 0
    mea_score.LAUNCHES = 0
    with _GcClock() as gc_clock:
        t0 = time.perf_counter()
        cli.main(["refine", gfa, "--all", "--minsize", "2", "--maxsize",
                  "10000", "--device", "cuda", "-o", out, *extra])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = dict(dp.LAUNCHES, mea=mea_score.LAUNCHES)
    st = dict(refine.LAST_STATS)
    _check_refine_stats(st, launches, label, route)
    print("%s: %d bubbles (%d on the chain, %d two-phase), %d pairs, %d "
          "posterior cells; launches: forward %d = backward %d, mea_score "
          "%d (chain chunks %d, chain DP batches %d, two-phase batches "
          "%d); extract %.6f s, stage 1+2 on the card (chain) %.6f s, "
          "two-phase stage 1 on the card %.6f s, host MSA %.6f s, splice "
          "%.6f s, end to end (GFA -> GFA, CLI in-process) %.6f s; peak "
          "device memory %.6f GB"
          % (label, st["bubbles"], st["chain_bubbles"],
             st["bubbles"] - st["chain_bubbles"], st["pairs"], st["cells"],
             launches["fwd"], launches["bwd"], launches["mea"],
             st["chain_batches"], st["chain_dp_batches"],
             _expected_batches(st)[0], st["extract_seconds"],
             st["chain_seconds"], st["stage1_seconds"], st["msa_seconds"],
             st["splice_seconds"], secs,
             torch.cuda.max_memory_allocated() / 1e9))
    print("%s: Python's cyclic garbage collector during the run: %s"
          % (label, gc_clock.text()))
    return launches, st, secs


class _GcClock:
    """Seconds and count of the collections of Python's cyclic garbage
    collector, by generation, inside a ``with`` block."""

    def __init__(self):
        self.secs = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t = 0.0

    def _on(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.secs[info["generation"]] += time.perf_counter() - self._t
            self.count[info["generation"]] += 1

    def __enter__(self):
        import gc

        gc.callbacks.append(self._on)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._on)

    def text(self):
        return ", ".join("generation %d: %d collections, %.6f s"
                         % (g, self.count[g], self.secs[g]) for g in range(3))


def _check_refine_stats(st, launches, label, route):
    """The route taken, every bubble refined and aligned, and the launch
    counts the bubbles' shapes ask for: forward = backward = the chain's
    DP batches and the two-phase batches, one MEA-score launch a chain
    chunk and a two-phase batch."""
    two, chunks, chain_dp = _expected_batches(st)
    if st["route"] != route:
        raise AssertionError("%s: route %s, expected %s"
                             % (label, st["route"], route))
    if (chunks, chain_dp) != (st["chain_batches"], st["chain_dp_batches"]):
        raise AssertionError(
            "%s: %d chain chunks and %d DP batches, reckoned %d and %d"
            % (label, st["chain_batches"], st["chain_dp_batches"], chunks,
               chain_dp))
    want = two + chain_dp
    if not (launches["fwd"] == launches["bwd"] == want and want > 0
            and launches["mea"] == two + chunks):
        raise AssertionError(
            "%s: %d forward, %d backward and %d mea_score launches for %d "
            "DP batches and %d chain chunks"
            % (label, launches["fwd"], launches["bwd"], launches["mea"],
               want, chunks))
    if st["refined"] != st["bubbles"] or not st["pairs"] > 0:
        raise AssertionError("%s: refine stats %r"
                             % (label, {k: v for k, v in st.items()
                                        if k != "digests"}))
    if st["aligned_bubbles"] != st["bubbles"]:
        raise AssertionError("%s: %d of %d refined bubbles are marked "
                             "aligned" % (label, st["aligned_bubbles"],
                                          st["bubbles"]))


class _ChainWatch:
    """Hooks around the chain or a refine run: the chain's MEA-score
    inputs and outputs (``msa.mea_score``, kept on the card), and, with
    ``against`` (one mats dict a bubble, in bubble order), every bubble's
    transformed matrices as the host MSA receives them
    (``msa._refine_stage``) held against those."""

    def __init__(self, against=None):
        self.scans = []
        self.against = against
        self.delta = 0.0
        self.one_sided = 0
        self.calls = 0

    def __enter__(self):
        from reveal_tpu_torch.hmm import msa

        self._mea, self._stage = msa.mea_score, msa._refine_stage

        def mea(p, nrows=None):
            out = self._mea(p, nrows)
            self.scans.append((p.clone(), nrows, out.clone()))
            return out

        def stage(aln, masks, mats, N):
            if self.against is not None:
                self._compare(self.against[self.calls], mats)
            self.calls += 1
            return self._stage(aln, masks, mats, N)

        msa.mea_score, msa._refine_stage = mea, stage
        return self

    def __exit__(self, *exc):
        from reveal_tpu_torch.hmm import msa

        msa.mea_score, msa._refine_stage = self._mea, self._stage

    def _compare(self, ref, mats):
        import numpy as np

        gate = 5e-3
        for k, a in ref.items():
            b = np.asarray(mats[k])
            if a.shape != b.shape:
                raise AssertionError("transformed matrix %r: %s against %s"
                                     % (k, a.shape, b.shape))
            one = (a == 0) != (b == 0)
            at_cut = one & (np.maximum(a, b) < 0.01 + gate)
            d = np.abs(a - b)
            d[at_cut] = 0.0
            self.one_sided += int(at_cut.sum())
            self.delta = max(self.delta, float(d.max(initial=0.0)))
            if self.delta > gate:
                raise AssertionError(
                    "transformed matrices of the two routes differ by %g "
                    "(gate %g)" % (self.delta, gate))


def chain_split(problems):
    """The chain of ``refine``'s bubbles once more
    (``msa.batch_stage12_device`` as refine_all calls it), with a
    synchronised host clock around its steps.  Prints seconds per step;
    returns its output."""
    import torch

    from reveal_tpu_torch.hmm import msa

    steps = ("_posteriors_device", "mea_score", "consistency_rounds",
             "_fetch_pairs", "compact_rows")
    secs = dict.fromkeys(steps, 0.0)
    originals = {name: getattr(msa, name) for name in steps}

    def clocked(name):
        fn = originals[name]

        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            return res
        return run

    for name in steps:
        setattr(msa, name, clocked(name))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = msa.batch_stage12_device(
            problems, consistency=REFINE_KW["constrans"],
            consgap=REFINE_KW["consgap"], device="cuda")
        total = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(msa, name, fn)
    top = sum(secs[n] for n in steps[:4])
    print("chain of refine's bubbles again, step by step (synchronised host "
          "clock): pack, copy in and the DP kernels (posteriors) %.6f s, "
          "MEA-score kernel %.6f s, relaxation rounds %.6f s, the a<b "
          "blocks to the host %.6f s (of which top-K and copy %.6f s, the "
          "rest the host's densifying), the rest (bucketing, cut, the "
          "tensor Q, scores, distances) %.6f s; %.6f s in all"
          % (secs["_posteriors_device"], secs["mea_score"],
             secs["consistency_rounds"], secs["_fetch_pairs"],
             secs["compact_rows"], total - top, total))
    return out


def check_chain_scans(scans):
    """The MEA-score kernel on the chain's own posteriors: each launch of
    the run equals the plain loop bit for bit, and every pair's score
    equals the host MEA DP (``msa._mea_dp_fast``) of its dense posterior
    to 1e-6 relative.  Returns {(B, L1p, L2p): (p, nrows, launches)},
    the last launch's input of each shape kept for timing."""
    import numpy as np
    import torch

    from reveal_tpu_torch.hmm import mea_score as ms
    from reveal_tpu_torch.hmm import msa

    shapes = {}
    worst = 0.0
    pairs = 0
    for p, nrows, got in scans:
        ref = ms.mea_score_plain(p, nrows)
        if not torch.equal(got, ref):
            raise AssertionError(
                "mea_score on the chain's posteriors %s differs from plain "
                "by %g" % (tuple(p.shape), float((got - ref).abs().max())))
        host = p.cpu().numpy()
        for k in range(host.shape[0]):
            want = msa._mea_dp_fast(host[k])[1]
            rel = abs(float(got[k]) - want) / max(1.0, abs(want))
            worst = max(worst, rel)
            if rel > 1e-6:
                raise AssertionError("chain MEA score %g, host MEA DP of "
                                     "the same posterior %g"
                                     % (float(got[k]), want))
        pairs += host.shape[0]
        key = tuple(p.shape)
        shapes[key] = (p, nrows, shapes.get(key, (0, 0, 0))[2] + 1)
    print("chain: mea_score equal to plain on all %d launches (%d pairs) "
          "of the chain run again; MEA scores against the host MEA DP of the "
          "card's own dense posteriors: %.3e relative (limit 1e-6); shapes "
          "%s" % (len(scans), pairs, worst,
                  ", ".join("%d x %d x %d (%d launches)" % (*k, v[2])
                            for k, v in shapes.items())))
    return shapes


def run_refine(seed, workdir):
    """The refine path at a real size on the chain; its chain once more,
    step by step, with every MEA-score launch checked; the two-phase route
    on the card for the same graph; the native float64 route for stage 1
    on a smaller graph."""
    from reveal_tpu_torch.core.io_gfa import read_gfa
    from reveal_tpu_torch.hmm import refine

    gfa = os.path.join(workdir, "bubbles.gfa")
    bubbles = []
    want = write_bubble_chain(gfa, seed, bubbles=bubbles)
    out = os.path.join(workdir, "bubbles.refined.gfa")
    launches, st, secs = _refine_on_card(gfa, out, "refine", "chain")
    if (st["bubbles"] != 72 or st["pairs"] != 72 * 15
            or st["cells"] < REFINE_MIN_CELLS or st["chain_bubbles"] != 72):
        raise AssertionError("refine: %d bubbles (%d on the chain), %d "
                             "pairs, %d cells"
                             % (st["bubbles"], st["chain_bubbles"],
                                st["pairs"], st["cells"]))
    _check_paths(out, want)
    print("refine: every path of the refined GFA spells its input; chain "
          "shapes (N, Lq): %s" % sorted(st["chain_shapes"].items()))
    # the same with the per-bubble MSA in four processes forked after the
    # card's stages (they must get host data only)
    out4 = os.path.join(workdir, "bubbles.refined.nproc4.gfa")
    _l4, st4, secs4 = _refine_on_card(gfa, out4, "refine --nproc 4", "chain",
                                      extra=("--nproc", "4"))
    if st4["pool_processes"] != 4 or _read(out4) != _read(out):
        raise AssertionError("refine --nproc 4: %d pool processes, GFA "
                             "equal to the serial run's: %s"
                             % (st4["pool_processes"],
                                _read(out4) == _read(out)))
    print("refine --nproc 4 --device cuda: GFA byte-identical to the serial "
          "run's (%d bytes); end to end %.6f s (host MSA %.6f s) against "
          "%.6f s (host MSA %.6f s) serial"
          % (len(_read(out)), secs4, st4["msa_seconds"], secs,
             st["msa_seconds"]))
    with _ChainWatch() as watch:
        chain = chain_split(bubbles)
    shapes = check_chain_scans(watch.scans)
    del watch

    # the two-phase route on the card for the graph's bubbles near 500 bp
    # (the float64 host transform of the eight near 1900 bp took 90-140 s),
    # its matrices held against the chain's bubble by bubble
    import torch

    keep = [max(len(a) for a in b) <= TWO_PHASE_MAXSIZE for b in bubbles]
    with _ChainWatch(against=[mats for (mats, _dist), k in zip(chain, keep)
                              if k]) as two, _GcClock() as gc_two:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        refine.refine_all(read_gfa(gfa), device="cuda", route="two-phase",
                          **dict(REFINE_KW, maxsize=TWO_PHASE_MAXSIZE))
        secs2 = time.perf_counter() - t0
    del chain
    st2 = dict(refine.LAST_STATS)
    chain_digests = [d for d, k in zip(st["digests"], keep) if k]
    differ = sum(a != b for a, b in zip(chain_digests, st2["digests"]))
    if (len(st2["digests"]) != len(chain_digests) or two.calls != sum(keep)
            or sum(keep) != 64):
        raise AssertionError("the two routes refined %d and %d of %d "
                             "bubbles near 500 bp"
                             % (len(chain_digests), len(st2["digests"]),
                                sum(keep)))
    print("refine, the two-phase route on the card for the graph's bubbles "
          "near 500 bp: %d of %d bubbles' refined subgraphs differ from the "
          "chain's; "
          "transformed matrices within %.3e of the chain's (gate 5e-3; %d "
          "cells within the gate of the 0.01 cut kept on one side only); "
          "stage 1 %.6f s, host MSA %.6f s, splice %.6f s, end to end %.6f "
          "s, peak device memory %.6f GB"
          % (differ, len(st2["digests"]), two.delta, two.one_sided,
             st2["stage1_seconds"], st2["msa_seconds"],
             st2["splice_seconds"], secs2,
             torch.cuda.max_memory_allocated() / 1e9))
    print("refine, the two-phase route: Python's cyclic garbage collector "
          "during the run: %s" % gc_two.text())
    split = stage1_split([b for b, k in zip(bubbles, keep) if k], st2)

    # the native float64 stage 1 against the card's, on 13 bubbles
    small = os.path.join(workdir, "bubbles13.gfa")
    write_bubble_chain(small, seed + 1, n_small=12, n_big=1)
    refine.refine_all(read_gfa(small), device="cuda", route="two-phase",
                      **REFINE_KW)
    card = dict(refine.LAST_STATS)
    t0 = time.perf_counter()
    refine.refine_all(read_gfa(small), stage1="native", **REFINE_KW)
    nat = dict(refine.LAST_STATS)
    if len(card["digests"]) != len(nat["digests"]) or not card["digests"]:
        raise AssertionError("the two stage-1 routes refined %d and %d "
                             "bubbles" % (len(card["digests"]),
                                          len(nat["digests"])))
    print("refine, 13 bubbles (12 near 500 bp, 1 near 1900 bp) on the "
          "two-phase route, stage 1 by the native float64 host pair-HMM "
          "instead of the card: %d of %d bubbles' refined subgraphs differ; "
          "stage 1 %.6f s on the host (card %.6f s), whole run %.6f s"
          % (sum(a != b for a, b in zip(card["digests"], nat["digests"])),
             len(nat["digests"]), nat["stage1_seconds"],
             card["stage1_seconds"], time.perf_counter() - t0))
    return launches, split, shapes


def run_refine_options(seed, workdir):
    """The posterior self-check on the card (``hmm/selfcheck.py``), and
    ``refine --logadd-compat`` on three small bubbles on the card and on
    the CPU: every posterior from the table twin on the host, the same
    bytes on both devices."""
    from reveal_tpu_torch import cli
    from reveal_tpu_torch.hmm import msa, refine
    from reveal_tpu_torch.hmm.selfcheck import check_posterior_oracle

    # the reference's lengths up to 180 bp (the float64 oracle is a
    # Python loop: 2.3 s at 180 bp, 17 s at 511 and 33 s at 700 on a host)
    lengths = (23, 57, 180)
    t0 = time.perf_counter()
    err, terr, name = check_posterior_oracle(lengths=lengths, device="cuda")
    print("posterior self-check on %s (pairs of %s bp against the float64 "
          "oracle): max |posterior error| %.3e (limit max(2e-3, 4e-5 L)), "
          "max |total log-prob error| %.3e (limit 5e-2), %.6f s"
          % (name, ", ".join(map(str, lengths)), err, terr,
             time.perf_counter() - t0))
    gfa = os.path.join(workdir, "compat_bubbles.gfa")
    want = write_bubble_chain(gfa, seed, n_small=3, small=40, n_big=0,
                              npaths=3, flank=20)
    got = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(workdir, "compat_%s.gfa" % dev)
        t0 = time.perf_counter()
        try:
            cli.main(["refine", gfa, "--all", "--minsize", "2", "--device",
                      dev, "--logadd-compat", "-o", out])
        finally:
            msa.set_logadd_compat(False)
        st = dict(refine.LAST_STATS)
        if not st["compat"] or st["route"] != "two-phase" or (
                st["chain_bubbles"] or st["refined"] != 3):
            raise AssertionError("refine --logadd-compat on %s: %r"
                                 % (dev, st))
        got[dev] = (_read(out), time.perf_counter() - t0)
        _check_paths(out, want)
    if got["cuda"][0] != got["cpu"][0]:
        raise AssertionError("refine --logadd-compat: the card's GFA differs "
                             "from the CPU's")
    print("refine --logadd-compat, 3 bubbles of 3 paths near 40 bp: GFA on "
          "the card equal to the CPU's (%d bytes; %.6f s and %.6f s), the "
          "two-phase route with the table twin's posteriors on the host"
          % (len(got["cpu"][0]), got["cuda"][1], got["cpu"][1]))


def run_mixed(seed, workdir):
    """A graph with one six-path bubble of about 4 kbp alleles (its chain
    tensor over CHAIN_BYTES_CAP) and four near 500 bp: the chain for
    four, the two-phase route for one, in one run."""
    from reveal_tpu_torch.hmm import msa

    gfa = os.path.join(workdir, "mixed.gfa")
    bubbles = []
    want = write_bubble_chain(gfa, seed + 2, n_small=4, small=500, n_big=1,
                              big=4000, bubbles=bubbles)
    big = max(bubbles, key=lambda al: max(map(len, al)))
    Lq = msa._bucket_len(max(map(len, big)) + 1)
    if 36 * Lq * Lq * 4 <= msa.CHAIN_BYTES_CAP:
        raise AssertionError("the big bubble (Lq %d) fits under the cap"
                             % Lq)
    out = os.path.join(workdir, "mixed.refined.gfa")
    _l, st, _secs = _refine_on_card(gfa, out, "refine, mixed graph",
                                    "chain", ("--nrefinements", "10"))
    if (st["bubbles"], st["chain_bubbles"]) != (5, 4):
        raise AssertionError("mixed graph: %d bubbles, %d on the chain"
                             % (st["bubbles"], st["chain_bubbles"]))
    _check_paths(out, want)
    print("refine, mixed graph: the 4 bubbles near 500 bp on the chain, the "
          "one of Lq %d (%.3f GB as a chain tensor) on the two-phase "
          "route; every path spells its input" % (Lq, 36 * Lq * Lq * 4e-9))


def stage1_split(bubbles, st):
    """Stage 1 of the run just made, phase by phase: the pairs ``refine``
    formed (all allele pairs of every bubble) go through the steps of
    ``msa.batch_posteriors_cut`` with the card synchronised between
    them.  Prints seconds per phase, the kernels' time per batch shape
    (launches x time) and their share of stage 1.  Returns, for every
    batch shape, the plan the kernels ran under and their times."""
    import collections

    import torch

    from reveal_tpu_torch.hmm import pairhmm
    from reveal_tpu_torch.hmm import pairhmm_dp as dp

    dev = torch.device("cuda")
    params = pairhmm.default_params(dev)
    pairs = [(al[a], al[b]) for al in bubbles
             for a in range(len(al)) for b in range(a + 1, len(al))]
    shapes = dict(collections.Counter(dp.bucket_key(a, b) for a, b in pairs))
    if shapes != st["pair_shapes"]:
        raise AssertionError("the bubbles' pairs have shapes %r, refine "
                             "saw %r" % (shapes, st["pair_shapes"]))

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    launched = []
    phases = ["pack and copy in", "classes and reversal", "forward kernel",
              "backward kernel", "combine", "cut and MEA row scan",
              "top-K and copy back"]
    for turn in ("warm-up", "timed"):
        secs = dict.fromkeys(phases, 0.0)
        per_shape = collections.defaultdict(lambda: [0, 0.0, 0.0, 0])
        t_all = clock()
        it = dp.batches(pairs, dev)
        while True:
            t0 = clock()
            batch = next(it, None)
            t1 = clock()
            secs[phases[0]] += t1 - t0
            if batch is None:
                break
            L1p, L2p, idxs, x, y, lx, ly = batch
            xcls, ycls = dp._prep(x, y)
            xr, yr = dp._prep(dp._reverse_within(x, lx),
                              dp._reverse_within(y, ly))
            t2 = clock()
            m, snap = dp.fwd_dp(xcls, ycls, lx, params)
            t3 = clock()
            b0 = dp.bwd_dp(xr, yr, lx, ly, params)
            t4 = clock()
            p, tot = dp.combine(m, snap, b0, lx, ly, params)
            del b0
            t5 = clock()
            nrows = int(lx.max())
            pairhmm.posterior_cut(p, nrows=nrows)
            t6 = clock()
            pairhmm.fetch_posteriors_compact(p, tot, nrows=nrows)
            t7 = clock()
            del p, m
            for name, dt in zip(phases[1:], (t2 - t1, t3 - t2, t4 - t3,
                                             t5 - t4, t6 - t5,
                                             (t7 - t6) - (t6 - t5))):
                secs[name] += dt
            row = per_shape[(L1p, L2p, len(idxs))]
            row[0] += 1
            row[1] += t3 - t2
            row[2] += t4 - t3
            row[3] = dp.launch_plan(len(idxs), L1p, L2p)
        total = clock() - t_all
        if turn == "warm-up":
            continue
        kern = secs["forward kernel"] + secs["backward kernel"]
        print("stage 1 of refine again, phase by phase (synchronised host "
              "clock; %d pairs, %d batches): %s; sum %.6f s (refine's own "
              "stage1_seconds: %.6f; this loop took %.6f s with the cut run "
              "a second time on its own to time it apart)"
              % (len(pairs), sum(r[0] for r in per_shape.values()),
                 ", ".join("%s %.6f s" % (k, secs[k]) for k in phases),
                 sum(secs.values()), st["stage1_seconds"], total))
        for (L1p, L2p, nb), (n, tf, tb, plan) in sorted(per_shape.items()):
            print("  batch %4d x %d x %d: %d launch(es) each way, forward "
                  "%.6f ms, backward %.6f ms a launch; plan %s"
                  % (nb, L1p, L2p, n, tf / n * 1e3, tb / n * 1e3,
                     _plan_text(plan)))
            launched.append({"batch": "%d x %d x %d" % (nb, L1p, L2p),
                             "launches": n, "plan": _plan_text(plan),
                             "fwd_ms": tf / n * 1e3, "bwd_ms": tb / n * 1e3})
        print("  the two kernels: launches x time = %.6f s forward + %.6f s "
              "backward = %.6f s, %.1f%% of this stage 1"
              % (secs["forward kernel"], secs["backward kernel"], kern,
                 100.0 * kern / sum(secs.values())))
    return launched


# ----------------------------------------------------------------------
# phase 7: the align pipeline on the card
# ----------------------------------------------------------------------
# (b): genomes and bp a genome of the sequential case
ALIGN_SEQUENTIAL = (4, 50_000)
# every file align --run writes at its defaults
ALIGN_FILES = ("prg.gfa", "prg.unzipped.gfa", "prg.unzipped.realigned.gfa",
               "prg.anchored.vcf", "prg.unzipped.vcf", "prg.refined.vcf")


def _sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _launch_counts():
    from reveal_tpu_torch.hmm import mea_score
    from reveal_tpu_torch.hmm import pairhmm_dp as dp
    from reveal_tpu_torch.index import repair
    from reveal_tpu_torch.index import window_resolve as wr

    return {"window_resolve": wr.LAUNCHES, "repair_pass": repair.LAUNCHES,
            "fwd": dp.LAUNCHES["fwd"], "bwd": dp.LAUNCHES["bwd"],
            "mea_score": mea_score.LAUNCHES}


def _zero_launch_counts():
    from reveal_tpu_torch.hmm import mea_score
    from reveal_tpu_torch.hmm import pairhmm_dp as dp
    from reveal_tpu_torch.index import repair
    from reveal_tpu_torch.index import window_resolve as wr

    wr.LAUNCHES = repair.LAUNCHES = mea_score.LAUNCHES = 0
    dp.LAUNCHES["fwd"] = dp.LAUNCHES["bwd"] = 0


class _PipelineWatch:
    """``align --run`` watched stage by stage: ``cli.main`` (which
    ``_run_pipeline_script`` calls for every line) wrapped with a
    synchronised clock, the kernels' launches over the stage and the
    stats it left; and each kernel's wrapper wrapped to keep the inputs
    and output of its smallest and of its largest launch (the first of
    each size; cloned, no launch is added), to hold against the plain
    version after the run."""

    KERNELS = ("window_resolve", "fwd", "bwd", "mea_score")

    def __init__(self, dev):
        self.dev = dev
        self.stages = []
        self.kept = {}

    def _wants(self, name, size):
        """Which of this kernel's kept launches one of ``size`` replaces:
        ("smallest",), ("largest",), both or none."""
        kept = self.kept.get(name, {})
        return tuple(
            which for which, better in (("smallest", size.__lt__),
                                        ("largest", size.__gt__))
            if which not in kept or better(kept[which][0]))

    def _keep(self, name, size, args, out):
        wants = self._wants(name, size)
        if wants:
            clone = (lambda v: v.clone() if hasattr(v, "clone") else v)
            launch = (size, tuple(clone(a) for a in args),
                      tuple(clone(o) for o in out))
            for which in wants:
                self.kept.setdefault(name, {})[which] = launch

    def __enter__(self):
        from reveal_tpu_torch import cli
        from reveal_tpu_torch.hmm import msa, pairhmm
        from reveal_tpu_torch.hmm import pairhmm_dp as dp
        from reveal_tpu_torch.index import devfrontier, devloop, devloop_multi
        from reveal_tpu_torch.index import repair
        from reveal_tpu_torch.index import window_resolve as wr
        from reveal_tpu_torch.hmm import refine

        self._orig = {"main": cli.main, "wr": wr.window_resolve,
                      "fwd": dp.fwd_dp, "bwd": dp.bwd_dp,
                      "mea_msa": msa.mea_score, "mea_ph": pairhmm.mea_score,
                      "repair": repair.repair_segments}
        orig = self._orig

        def stage(argv):
            for mod in (devloop, devloop_multi, devfrontier, refine):
                mod.LAST_STATS.clear()
            before = _launch_counts()
            _sync(self.dev)
            t0 = time.perf_counter()
            rc = orig["main"](argv)
            _sync(self.dev)
            secs = time.perf_counter() - t0
            after = _launch_counts()
            stats = {name: dict(mod.LAST_STATS) for name, mod in (
                ("forest", devloop), ("multi", devloop_multi),
                ("frontier", devfrontier), ("refine", refine))}
            self.stages.append((argv[0], secs,
                                {k: after[k] - before[k] for k in after},
                                stats))
            return rc

        def window_resolve(lcp, q, thr, wrv=WRV):
            out = orig["wr"](lcp, q, thr, wrv)
            self._keep("window_resolve", q.numel() * wrv, (lcp, q, thr, wrv),
                       (out,))
            return out

        def fwd(xcls, ycls, lx, params):
            out = orig["fwd"](xcls, ycls, lx, params)
            self._keep("fwd", xcls.shape[0] * xcls.shape[1] * ycls.shape[1],
                       (xcls, ycls, lx, params), out)
            return out

        def bwd(xcls, ycls, lx, ly, params):
            out = orig["bwd"](xcls, ycls, lx, ly, params)
            self._keep("bwd", xcls.shape[0] * xcls.shape[1] * ycls.shape[1],
                       (xcls, ycls, lx, ly, params), (out,))
            return out

        def mea(which):
            def run(p, nrows=None):
                out = orig[which](p, nrows)
                self._keep("mea_score", p.numel(), (p, nrows), (out,))
                return out
            return run

        def repair_pass(SA, LCP, BWT, SEG, beg, cq, centry_next, rc, SMAX,
                        stats):
            # the pass works in place: its inputs are cloned before the
            # launch; its size is (npad, crossing suffixes), the count read
            # off the card (one host sync a pass); a pass with none is not
            # kept
            size = (SA.numel(), int(rc))
            wants = self._wants("repair_pass", size) if size[1] else ()
            if wants:
                args = tuple(t.clone() for t in (SA, LCP, BWT, SEG, beg, cq,
                                                 centry_next, rc, stats))
            out = orig["repair"](SA, LCP, BWT, SEG, beg, cq, centry_next,
                                 rc, SMAX, stats)
            if wants:
                launch = (size, args + (SMAX,), tuple(
                    t.clone() for t in out[:3] + (stats,)))
                for which in wants:
                    self.kept.setdefault("repair_pass", {})[which] = launch
            return out

        cli.main = stage
        repair.repair_segments = repair_pass
        wr.window_resolve = window_resolve
        dp.fwd_dp, dp.bwd_dp = fwd, bwd
        msa.mea_score, pairhmm.mea_score = mea("mea_msa"), mea("mea_ph")
        return self

    def __exit__(self, *exc):
        from reveal_tpu_torch import cli
        from reveal_tpu_torch.hmm import msa, pairhmm
        from reveal_tpu_torch.hmm import pairhmm_dp as dp
        from reveal_tpu_torch.index import window_resolve as wr

        from reveal_tpu_torch.index import repair

        o = self._orig
        cli.main, wr.window_resolve = o["main"], o["wr"]
        repair.repair_segments = o["repair"]
        dp.fwd_dp, dp.bwd_dp = o["fwd"], o["bwd"]
        msa.mea_score, pairhmm.mea_score = o["mea_msa"], o["mea_ph"]

    def run(self, argv):
        """The outer ``align`` call (not itself a stage)."""
        return self._orig["main"](argv)

    def hold(self, label):
        """Each kept launch against the plain version on the same inputs:
        the repair pass (SA, LCP, BWT and its counters), window-resolve
        and ``mea_score`` exactly, the DP grids within
        1e-4 * max(L1p, L2p) on the cells both call real.  Returns
        {kernel: {"smallest" | "largest": (max |error|, shape, kernel ms,
        plain ms)}}, the times of the smallest launch only."""
        import torch

        from reveal_tpu_torch.hmm import mea_score as ms
        from reveal_tpu_torch.hmm import pairhmm_dp as dp
        from reveal_tpu_torch.index import window_resolve as wr

        from reveal_tpu_torch.index import devloop

        errs = {}
        for name, which, args, out in sorted(
                (name, which, args, out)
                for name, launches in self.kept.items()
                for which, (_size, args, out) in launches.items()):
            if name == "repair_pass":
                SA, LCP, BWT, SEG, beg, cq, cnext, rc, stats, SMAX = args
                # the counters go on from where the launch found them (the
                # longest run is a maximum over passes)
                st = stats.clone()
                ref = devloop.repair_rounds_plain(
                    SA.clone(), LCP.clone(), BWT.clone(), SEG, beg, cq, cnext,
                    rc, SMAX, st)
                err = max(int((k.long() - p.long()).abs().max())
                          for k, p in zip(out[:3], ref[:3]))
                shape = "npad %d, CCAP %d, rc %d" % (SA.numel(), cq.numel(),
                                                     int(rc))
                ok = err == 0 and torch.equal(out[3], st)
            elif name == "window_resolve":
                lcp, q, thr, wrv = args
                ref = wr.window_resolve_plain(lcp, q, thr, wrv)
                err = int((out[0].long() - ref.long()).abs().max())
                shape = "RBV %d, npad %d" % (q.numel(), lcp.numel())
                ok = err == 0
            elif name == "mea_score":
                p, nrows = args
                ref = ms.mea_score_plain(p, nrows)
                err = float((out[0] - ref).abs().max())
                shape = "%d x %d x %d" % tuple(p.shape)
                ok = torch.equal(out[0], ref)
            else:
                xcls, ycls, lx = args[:3]
                params = args[-1]
                lim = 1e-4 * max(xcls.shape[1], ycls.shape[1])
                shape = "%d x %d x %d" % (xcls.shape[0], xcls.shape[1],
                                          ycls.shape[1])
                if name == "fwd":
                    m_p, snap_p = dp.fwd_dp_plain(xcls, ycls, lx, params)
                    err = max(_grid_err(out[0], m_p, label + " fwd M"),
                              _grid_err(out[1], snap_p,
                                        label + " fwd snapshot"))
                else:
                    ly = args[3]
                    ref = dp.flip_within(dp.bwd_dp_plain(xcls, ycls, params),
                                         lx, ly)
                    err = _grid_err(out[0], ref, label + " bwd G0")
                ok = err <= lim
            if not ok:
                raise AssertionError("%s: %s's %s launch differs from its "
                                     "plain version by %g at %s"
                                     % (label, name, which, err, shape))
            errs.setdefault(name, {})[which] = (err, shape) + (
                self._times(name, args) if which == "smallest"
                else (None, None)) + self._bound(name, args, out)
        return errs

    @staticmethod
    def _bound(name, args, out):
        """(bound ms, bound_by) of a kept launch, reckoned as the
        kernels line reckons its rows: window-resolve by its windows'
        bytes; the DP kernels by 14 exp/log a cell within lx x ly (the
        forward's ly is the columns before its '~' padding, class 5);
        ``mea_score`` by ``_mea_bounds``; the repair pass by the bytes of
        the slots it moved and the candidates it applied (its counters
        after the launch less before)."""
        if name == "window_resolve":
            _lcp, q, _thr, wrv = args
            by_bytes = (q.numel() * wrv * 4 + 3 * q.numel() * 4) \
                / HBM_BYTES_PER_S * 1e3
            by_ops = q.numel() * wrv / F32_OPS_PER_S * 1e3
        elif name == "mea_score":
            p, nrows = args
            bound, by, _floor = _mea_bounds(
                *p.shape, p.shape[1] if nrows is None else nrows)
            return bound, by
        elif name == "repair_pass":
            before, after = args[8].tolist(), out[3].tolist()
            nbytes = (24 * (after[2] - before[2])
                      + 32 * (after[0] - before[0]))
            return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"
        else:
            xcls, ycls, lx = args[:3]
            ly = args[3] if name == "bwd" else (ycls[:, 1:] < 5).sum(1)
            B, L1p = xcls.shape
            L2p = ycls.shape[1]
            cells = int(((lx.long() + 1) * (ly.long() + 1)).sum())
            nbytes = (B * L1p * L2p * 4 + B * 5 * L2p * 4 + B * (L1p + L2p)
                      + 8 * B + 408)
            by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            by_ops = SFU_PER_CELL * cells / SFU_OPS_PER_S * 1e3
        return (max(by_bytes, by_ops),
                "bytes" if by_bytes >= by_ops else "operations")

    def _times(self, name, args):
        """(kernel ms, plain ms) of one call on the kept inputs, from CUDA
        events in turns plain, kernel, kernel, plain (none off a card)."""
        import torch

        from reveal_tpu_torch.hmm import mea_score as ms
        from reveal_tpu_torch.hmm import pairhmm_dp as dp
        from reveal_tpu_torch.index import devloop, repair
        from reveal_tpu_torch.index import window_resolve as wr

        if torch.device(self.dev).type != "cuda":
            return (None, None)
        if name == "repair_pass":
            def pair(fn):
                def run():
                    fresh = [t.clone() for t in args[:9]]
                    fresh[8].zero_()
                    fn(*fresh[:8], args[9], fresh[8])
                return run
            kernel = pair(repair.repair_segments)
            plain = pair(devloop.repair_rounds_plain)
        elif name == "window_resolve":
            kernel = lambda: wr.window_resolve(*args)  # noqa: E731
            plain = lambda: wr.window_resolve_plain(*args)  # noqa: E731
        elif name == "mea_score":
            kernel = lambda: ms.mea_score(*args)  # noqa: E731
            plain = lambda: ms.mea_score_plain(*args)  # noqa: E731
        elif name == "fwd":
            kernel = lambda: dp.fwd_dp(*args)  # noqa: E731
            plain = lambda: dp.fwd_dp_plain(*args)  # noqa: E731
        else:
            kernel = lambda: dp.bwd_dp(*args)  # noqa: E731
            plain = lambda: dp.flip_within(  # noqa: E731
                dp.bwd_dp_plain(args[0], args[1], args[4]), args[2], args[3])
        t = {kernel: [], plain: []}
        for fn in (plain, kernel, kernel, plain):
            t[fn].append(_event_ms(fn, 1))
        return (sum(t[kernel]) / 2, sum(t[plain]) / 2)


def _run_align(fastas, outdir, dev, extra=()):
    """``cli align FASTAS --run --device DEV -o prg`` in ``outdir`` with
    the launch counts set to 0 just before it; returns (watch, seconds
    end to end, launches, {file: bytes})."""
    os.makedirs(outdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(outdir)
    try:
        _zero_launch_counts()
        with _PipelineWatch(dev) as watch:
            _sync(dev)
            t0 = time.perf_counter()
            watch.run(["align", *fastas, "--run", "--device", dev, "-o",
                       "prg", *extra])
            _sync(dev)
            secs = time.perf_counter() - t0
        launches = _launch_counts()
    finally:
        os.chdir(cwd)
    files = {fn: _read(os.path.join(outdir, fn))
             for fn in sorted(os.listdir(outdir))}
    return watch, secs, launches, files


def _held_line(errs):
    return ", ".join("%s %s %s max |err| %.3e, kernel %s ms, plain %s ms, "
                     "bound %.6f ms by %s"
                     % (k, which, v[1], v[0], v[2], v[3], v[4], v[5])
                     for k, launches in sorted(errs.items())
                     for which, v in sorted(launches.items(), reverse=True))


def _stage_line(watch, secs):
    return ", ".join(
        ["%s %.6f s" % (name, s) for name, s, _l, _st in watch.stages]
        + ["end to end %.6f s (the stages %.6f s)"
           % (secs, sum(s for _n, s, _l, _st in watch.stages))])


def _host_unzip_variants(gfa, workdir):
    """``unzip -u10`` and ``variants --vcf`` of ``gfa`` and of its
    unzipped graph, host code only, in a directory of their own: the
    bytes the pipeline's host stages must give."""
    from reveal_tpu_torch import cli

    wd = os.path.join(workdir, "host_stages")
    os.makedirs(wd, exist_ok=True)
    with open(os.path.join(wd, "prg.gfa"), "wb") as fh:
        fh.write(_read(gfa))
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        cli.main(["unzip", "prg.gfa", "-u10"])
        for src, dst in (("prg.gfa", "prg.anchored.vcf"),
                         ("prg.unzipped.gfa", "prg.unzipped.vcf")):
            with open(dst, "w") as fh, contextlib.redirect_stdout(fh):
                cli.main(["variants", src, "--vcf"])
    finally:
        os.chdir(cwd)
    return {fn: _read(os.path.join(wd, fn)) for fn in
            ("prg.unzipped.gfa", "prg.anchored.vcf", "prg.unzipped.vcf")}


def _refine_cpu(unzipped, workdir):
    """The align script's ``refine`` line on the CPU for ``unzipped`` and
    ``variants --vcf`` of its result, in a directory of their own: the
    bytes the pipeline's refine stage and its VCF must give.  Returns
    ({file: bytes}, seconds of the refine)."""
    from reveal_tpu_torch import cli

    wd = os.path.join(workdir, "cpu_refine")
    os.makedirs(wd)
    with open(os.path.join(wd, "prg.unzipped.gfa"), "wb") as fh:
        fh.write(_read(unzipped))
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        t0 = time.perf_counter()
        cli.main(["refine", "prg.unzipped.gfa", "--all", "--maxsize=10000",
                  "--minsize=2", "--mindiff=0", "--minconf=0", "-o",
                  "prg.unzipped.realigned.gfa", "--device", "cpu"])
        secs = time.perf_counter() - t0
        with open("prg.refined.vcf", "w") as fh, \
                contextlib.redirect_stdout(fh):
            cli.main(["variants", "prg.unzipped.realigned.gfa", "--vcf"])
    finally:
        os.chdir(cwd)
    return {fn: _read(os.path.join(wd, fn)) for fn in
            ("prg.unzipped.realigned.gfa", "prg.refined.vcf")}, secs


# phase 7 (a)'s genomes: (n, bp a genome)
ALIGN_A = (6, 50_000)


def run_align_a(case, workdir, dev="cuda"):
    """Phase 7 (a): ``align --run`` on the genomes of ``ALIGN_A``.
    Returns the kernels' launches and their errors against plain."""
    from reveal_tpu_torch.hmm import refine

    fastas, host_gfa, want = case
    out = os.path.join(workdir, "align_a")
    watch, secs, launches, files = _run_align(fastas, out, dev)
    names = [s[0] for s in watch.stages]
    if names != ["rem", "unzip", "refine", "variants", "variants",
                 "variants"] or sorted(files) != sorted(ALIGN_FILES):
        raise AssertionError("align (a): stages %s, files %s"
                             % (names, sorted(files)))
    (_n, t_rem, l_rem, st_rem), _u, (_r, t_ref, l_ref, st_ref) = \
        watch.stages[:3]
    multi, st = st_rem["multi"], st_ref["refine"]
    # the rem stage: the multi loop whole, the host engine's bytes
    if files["prg.gfa"] != _read(host_gfa):
        raise AssertionError("align (a): prg.gfa (%d bytes) differs from "
                             "the host engine's (%d bytes)"
                             % (len(files["prg.gfa"]),
                                len(_read(host_gfa))))
    if multi.get("abort") != 0 or multi.get("fallback") is not None:
        raise AssertionError("align (a): the multi loop did not finish: %r"
                             % multi)
    rounds = multi["repair_rounds_total"]
    if not (rounds > 0 and l_rem["window_resolve"] == rounds
            == launches["window_resolve"]) or launches["repair_pass"]:
        raise AssertionError(
            "align (a): window_resolve launched %d times (%d in rem) for %d "
            "repair rounds; repair_pass %d times"
            % (launches["window_resolve"], l_rem["window_resolve"], rounds,
               launches["repair_pass"]))
    # the host stages: the host unzip and variants of those bytes
    host = _host_unzip_variants(host_gfa, workdir)
    for fn, data in host.items():
        if files[fn] != data:
            raise AssertionError("align (a): %s differs from the host "
                                 "stages' (%d against %d bytes)"
                                 % (fn, len(files[fn]), len(data)))
    # the refine stage: the chain on the card, every path spells its input
    _check_refine_stats(st, {"fwd": l_ref["fwd"], "bwd": l_ref["bwd"],
                             "mea": l_ref["mea_score"]}, "align (a) refine",
                        "chain" if dev == "cuda" else "two-phase")
    if (l_ref["fwd"], l_ref["bwd"], l_ref["mea_score"]) != (
            launches["fwd"], launches["bwd"], launches["mea_score"]):
        raise AssertionError("align (a): DP or MEA-score launches outside "
                             "the refine stage: %r" % launches)
    _check_paths(os.path.join(out, "prg.unzipped.realigned.gfa"), want)
    errs = watch.hold("align (a)")
    if sorted(errs) != sorted(_PipelineWatch.KERNELS):
        raise AssertionError("align (a): kernels held: %s" % sorted(errs))
    print("align (a) (%s, %d paths; align --run --device %s -o prg): "
          "prg.gfa byte-identical to the host engine's (%d "
          "bytes); prg.unzipped.gfa, prg.anchored.vcf, prg.unzipped.vcf "
          "equal to the host unzip and variants of those bytes; every path "
          "of prg.unzipped.realigned.gfa spells its input"
          % (", ".join(os.path.basename(f) for f in fastas), len(want), dev,
             len(files["prg.gfa"])))
    print("align (a) stages (synchronised host clock; in one process, the "
          "kernels built before): %s" % _stage_line(watch, secs))
    print("align (a) launches: window_resolve %d (= the rem stage's %d "
          "repair rounds in %d levels), repair_pass %d; refine: %d bubbles "
          "(%d on the chain), %d pairs, forward %d = backward %d, mea_score "
          "%d (chain chunks %d, chain DP batches %d, two-phase batches %d); "
          "refine: extract %.6f s, chain %.6f s, host MSA %.6f s, splice "
          "%.6f s"
          % (launches["window_resolve"], rounds, multi["levels"],
             launches["repair_pass"], st["bubbles"], st["chain_bubbles"],
             st["pairs"], launches["fwd"], launches["bwd"],
             launches["mea_score"], st["chain_batches"],
             st["chain_dp_batches"], _expected_batches(st)[0],
             st["extract_seconds"], st["chain_seconds"], st["msa_seconds"],
             st["splice_seconds"]))
    print("align (a), each kernel's smallest and largest launch of the run "
          "against its plain version on the same inputs (the smallest timed: "
          "one call each, CUDA events, plain, kernel, kernel, plain): %s"
          % _held_line(errs))
    script = run_align_script(fastas, os.path.join(workdir, "align_a_sh"),
                              dev, files)
    # the refine stage and its VCF against the CPU's, byte for byte
    cpu, t_cpu = _refine_cpu(os.path.join(out, "prg.unzipped.gfa"), workdir)
    for fn, data in cpu.items():
        if files[fn] != data:
            raise AssertionError("align (a): %s differs from refine --device "
                                 "cpu's (%d against %d bytes)"
                                 % (fn, len(files[fn]), len(data)))
    print("align (a): prg.unzipped.realigned.gfa (%d bytes) and "
          "prg.refined.vcf (%d bytes) byte-identical to refine --device cpu "
          "and variants of the same unzipped GFA; the CPU's refine %.6f s "
          "(%d bubbles, route %s)"
          % (len(cpu["prg.unzipped.realigned.gfa"]), len(cpu["prg.refined.vcf"]),
             t_cpu, refine.LAST_STATS["bubbles"], refine.LAST_STATS["route"]))
    return {
        "launches": launches,
        "held": errs,
        "seconds": {"e2e": secs, "stages": [(n, s) for n, s, _l, _st
                                            in watch.stages],
                    "processes": script},
        "bubbles": st["bubbles"], "cpu_refine_seconds": t_cpu,
    }


def run_align_script(fastas, outdir, dev, want):
    """The script ``align`` prints, each line its own process (as a user
    runs it with ``sh``), timed line by line; its files must be the
    in-process run's ``want``.  Returns [(line, seconds)]."""
    import reveal_tpu_torch

    os.makedirs(outdir)
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(reveal_tpu_torch.__file__))
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    script = subprocess.run(
        [sys.executable, "-m", "reveal_tpu_torch.cli", "align", *fastas,
         "--device", dev, "-o", "prg"], check=True, capture_output=True,
        text=True, cwd=outdir, env=env).stdout
    timed = []
    t_all = time.perf_counter()
    for line in script.splitlines():
        if not line or line.startswith("#"):
            continue
        t0 = time.perf_counter()
        subprocess.run(line.replace("python -m", sys.executable + " -m", 1),
                       shell=True, check=True, cwd=outdir, env=env,
                       stderr=subprocess.DEVNULL)
        timed.append((line.split()[3], time.perf_counter() - t0))
    total = time.perf_counter() - t_all
    got = {fn: _read(os.path.join(outdir, fn))
           for fn in sorted(os.listdir(outdir))}
    if got != want:
        raise AssertionError("align (a): the script's files differ from "
                             "the in-process run's: %s"
                             % [f for f in want if got.get(f) != want[f]])
    print("align (a) as its printed script, one process a line (%d lines): "
          "%s; %.6f s in all; the same files as align --run"
          % (len(timed), ", ".join("%s %.6f s" % t for t in timed), total))
    return timed


def run_align_b(seed, workdir, dev="cuda", other="cpu"):
    """Phase 7 (b): ``align --run --order sequential --chunksize 2`` on
    ``ALIGN_SEQUENTIAL`` genomes on the card and on the CPU: every file
    equal in bytes; on the card the pair chunks launch the repair pass
    once a pass and the ``.gfa`` level runs the per-level frontier."""
    n, length = ALIGN_SEQUENTIAL
    fastas, total_bp, want = write_population(n, length, seed, workdir)
    opts = ("--order", "sequential", "--chunksize", "2")
    runs = {}
    for d in (dev, other):
        runs[d] = _run_align(fastas, os.path.join(workdir, "align_b_" + d),
                             d, opts)
    watch, secs, launches, files = runs[dev]
    cpu_files = runs[other][3]
    if sorted(files) != sorted(ALIGN_FILES) or files != cpu_files:
        raise AssertionError(
            "align (b): files %s on %s, %s on %s; differing: %s"
            % (sorted(files), dev, sorted(cpu_files), other,
               [f for f in files if files[f] != cpu_files.get(f)]))
    rems = [s for s in watch.stages if s[0] == "rem"]
    if len(rems) != 3:
        raise AssertionError("align (b): %d rem stages" % len(rems))
    passes = 0
    for _n, _s, lau, st in rems[:2]:
        f = st["forest"]
        if f.get("abort") != 0 or not (
                lau["repair_pass"] == f["repair_launches"]
                == f["repair_rounds_total"] > 0):
            raise AssertionError("align (b): a pair chunk's forest: %r, "
                                 "launches %r" % (f, lau))
        passes += lau["repair_pass"]
    last = rems[2]
    if not last[3]["frontier"].get("levels", 0) > 0 or (
            last[2]["repair_pass"] or last[2]["window_resolve"]):
        raise AssertionError("align (b): the .gfa level: %r, launches %r"
                             % (last[3]["frontier"], last[2]))
    st = [s for s in watch.stages if s[0] == "refine"][0]
    _check_refine_stats(st[3]["refine"], {"fwd": st[2]["fwd"],
                                          "bwd": st[2]["bwd"],
                                          "mea": st[2]["mea_score"]},
                        "align (b) refine",
                        "chain" if dev == "cuda" else "two-phase")
    _check_paths(os.path.join(workdir, "align_b_" + dev,
                              "prg.unzipped.realigned.gfa"), want)
    errs = watch.hold("align (b)")
    if sorted(errs) != sorted(("repair_pass",) + _PipelineWatch.KERNELS[1:]):
        raise AssertionError("align (b): kernels held: %s" % sorted(errs))
    print("align (b) (%d x %d bp, --order sequential --chunksize 2): every "
          "file equal on %s and %s (%s); pair chunks: repair_pass %d "
          "launches = passes; the .gfa level on the per-level frontier (%d "
          "levels); refine: %d bubbles, forward %d, backward %d, mea_score "
          "%d; kernels against plain: %s"
          % (n, length, dev, other,
             ", ".join("%s %d B" % (f, len(files[f])) for f in ALIGN_FILES),
             passes, last[3]["frontier"]["levels"],
             st[3]["refine"]["bubbles"], launches["fwd"], launches["bwd"],
             launches["mea_score"],
             _held_line(errs)))
    print("align (b) stages on %s: %s" % (dev, _stage_line(watch, secs)))
    print("align (b) stages on %s: %s" % (other, _stage_line(*runs[other][:2])))
    return {"repair_pass": passes, "launches": launches, "seconds": secs,
            "cpu_seconds": runs[other][1],
            "held": errs}


def run_align(seed, workdir, case=None, dev="cuda", other="cpu"):
    """Phase 7.  ``case`` is (fastas, host-engine GFA, {record:
    sequence}); without it the genomes of ``ALIGN_A`` are written and the
    host engine run here.  ``dev`` and ``other`` are the devices under
    test and compared with (``cpu`` for both rehearses the phase on a
    host without a card)."""
    if case is None:
        n, length = ALIGN_A
        fastas, _bp, want = write_population(n, length, seed, workdir)
        gfa = os.path.join(workdir, "host_align.gfa")
        t = host_gfa(fastas, gfa)
        print("align (a): the host engine's GFA of %d x %d bp in %.6f s"
              % (n, length, t))
        case = (fastas, gfa, want)
    a = run_align_a(case, workdir, dev)
    b = run_align_b(seed, workdir, dev, other)
    return a, b


def run_rem_then_refine(rem_gfa, workdir):
    """``refine --all --minsize 2`` on the GFA ``rem`` wrote: phase 5e
    (a)'s 2 x 500 kbp pair (phase 5's 2 x 2 Mbp GFA until the script
    outgrew its time, its 3,466 tiny bubbles 65-102 s of extraction)."""
    from reveal_tpu_torch.core.io_gfa import read_gfa
    from reveal_tpu_torch.graph.extract import extract

    G = read_gfa(rem_gfa)
    want = {name: extract(G, name) for name in G.graph["paths"]}
    out = os.path.join(workdir, "port.refined.gfa")
    _l, st, secs = _refine_on_card(rem_gfa, out, "rem then refine", "chain")
    if st["chain_bubbles"] != st["bubbles"]:
        raise AssertionError("rem then refine: %d of %d bubbles on the "
                             "chain" % (st["chain_bubbles"], st["bubbles"]))
    _check_paths(out, want)
    print("rem then refine (%s): %d bubbles, paths round-trip; refine "
          "%.6f s" % (os.path.basename(rem_gfa), st["bubbles"], secs))


# ----------------------------------------------------------------------
# phase 8: the device suffix-array build and the device MUM scans
# ----------------------------------------------------------------------
# (a)'s roots: (label, genomes, bp a genome), padded to 2^20, 2^22, 2^23
# and 2^25 slots; uncut simulate_population(n, L, seed) texts
ESA_CASES = (("6 x 100 kbp", 6, 100_000), ("2 x 2 Mbp", 2, 2_000_000),
             ("6 x 1 Mbp", 6, 1_000_000), ("2 x 16 Mbp", 2, 16_000_000))
# the MUM scans' minimum length (c)
ESA_MINL = 20


def population_text(n, length, seed):
    """The root text of ``simulate_population(n, length, seed)``, one
    sample a genome as ``rem`` reads its fastas: (T, nsep)."""
    from reveal_tpu_torch.core.textstore import TextStore
    from reveal_tpu_torch.utils.simulate import simulate_population

    ts = TextStore()
    for name, seq, _ids in simulate_population(n, length, seed=seed):
        ts.add_sample(name)
        ts.add_sequence(seq)
    T, _so, nsep = ts.build()
    return T, nsep


def suffix_order_holds(T, SA):
    """Whether SA is the suffix array of T, in linear time: SA is a
    permutation, and every two neighbours a = SA[i-1], b = SA[i] have
    (T[a], ISA[a+1]) < (T[b], ISA[b+1]), the empty suffix ranked lowest
    (Burkhardt and Kaerkkaeinen's check).  ``suffix.sufcheck`` sorts the
    text again by doubling on the host: 13 s at 4 Mbp on an 8-core CPU,
    too long for the larger roots."""
    import numpy as np

    n = len(T)
    if len(SA) != n or not np.all(np.bincount(SA, minlength=n) == 1):
        return False
    isa = np.empty(n + 1, np.int64)
    isa[SA] = np.arange(n)
    isa[n] = -1
    a, b = SA[:-1], SA[1:]
    ta, tb = T[a], T[b]
    return bool(np.all((ta < tb) | ((ta == tb) & (isa[a + 1] < isa[b + 1]))))


def check_device_esa(seed, dev):
    """Phase 8 (a): ``build_esa(T, "jax", device=dev)`` against the
    native SA-IS + Kasai on each root of ``ESA_CASES``: SA, LCP and SAi
    exactly equal, the suffix order checked; the first root again with
    ``force64`` (its arrays the int32 build's) and through
    ``suffix.sufcheck``.  Returns ({label: numbers}, the 2 x 2 Mbp root
    as (T, nsep, SA, LCP) of the device build)."""
    import numpy as np
    import torch

    from reveal_tpu_torch.index import suffix

    cuda = torch.device(dev).type == "cuda"
    # the first sort of a process sets up its workspace: not timed
    suffix.build_esa(population_text(2, 30_000, seed)[0], "jax", device=dev)
    out, root = {}, None
    for k, (label, n, length) in enumerate(ESA_CASES):
        t0 = time.perf_counter()
        T, nsep = population_text(n, length, seed)
        t_text = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = suffix.build_esa(T, "native")
        t_native = time.perf_counter() - t0
        _sync(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = suffix.build_esa(T, "jax", device=dev)
        t_dev = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base if cuda else 0
        st = dict(suffix.LAST_STATS)
        for name, g, w in zip(("SA", "LCP", "SAi"), got, want):
            if g.shape != w.shape or not np.array_equal(g, w):
                bad = np.nonzero(g != w)[0] if g.shape == w.shape else [-1]
                raise AssertionError(
                    "device ESA %s: %s differs from the native build's (%s "
                    "against %s slots; first difference at %d)"
                    % (label, name, g.shape, w.shape, int(bad[0])))
        t0 = time.perf_counter()
        if not suffix_order_holds(T, got[0]):
            raise AssertionError("device ESA %s: the suffix order does not "
                                 "hold" % label)
        t_check = time.perf_counter() - t0
        extra = ""
        if k == 0:
            if not suffix.sufcheck(T, got[0]):
                raise AssertionError("device ESA %s: sufcheck fails" % label)
            t0 = time.perf_counter()
            got64 = suffix.build_esa_device(T, torch.device(dev),
                                            force64=True)
            t64 = time.perf_counter() - t0
            if not suffix.LAST_STATS["int64"] or any(
                    not np.array_equal(a, b) for a, b in zip(got64, got)):
                raise AssertionError("device ESA %s: the int64 build differs "
                                     "from the int32 build" % label)
            extra = ("; sufcheck holds; force64 (int64 ranks) equal to the "
                     "int32 build, %.6f s" % t64)
        out[label] = dict(n=st["n"], npad=st["npad"], rounds=st["rounds"],
                          rounds_seconds=st["rounds_seconds"],
                          lcp_seconds=st["lcp_seconds"],
                          copy_seconds=st["copy_seconds"], seconds=t_dev,
                          peak_bytes=peak, native_seconds=t_native)
        print("device ESA %s (n %d, npad 2^%d): SA, LCP, SAi equal to the "
              "native build's, suffix order holds (%.6f s on the host)%s; "
              "%d doubling rounds of at most %d; synchronised clock: text to "
              "the card and the rounds %.6f s, LCP descent and SAi %.6f s, "
              "copy to the host %.6f s, build_esa %.6f s; peak device memory "
              "%.6f GB above the %.6f GB held before; native SA-IS + Kasai "
              "%.6f s on the host; the text made in %.6f s"
              % (label, st["n"], st["npad"].bit_length() - 1, t_check, extra,
                 st["rounds"], st["npad"].bit_length() - 1,
                 st["rounds_seconds"], st["lcp_seconds"],
                 st["copy_seconds"], t_dev, peak / 1e9,
                 (base if cuda else 0) / 1e9, t_native, t_text))
        if n == 2 and length == 2_000_000:
            root = (T, nsep, got[0], got[1])
    return out, root


def run_rem_backends(label, fastas, workdir, dev="cuda", backend="jax"):
    """Phase 8 (b), 9 (b): ``cli rem --frontier --device DEV`` on
    ``fastas`` with the default backend, then with ``--backend BACKEND``
    (``jax``, the device build, or ``jax-dist``, the distributed build):
    the same GFA bytes and the same kernel launches (counts set to 0 just
    before each run).  Returns the ``--backend`` run's launches."""
    import torch

    from reveal_tpu_torch import cli
    from reveal_tpu_torch.index import repair, suffix
    from reveal_tpu_torch.index import window_resolve as wr
    from reveal_tpu_torch.parallel import dsa

    stats = dsa.LAST_STATS if backend == "jax-dist" else suffix.LAST_STATS
    runs = {}
    for run in ("default", backend):
        out = os.path.join(workdir, "esa_%s_%s.gfa"
                           % (label.replace(" ", ""), run))
        argv = ["rem", *fastas, "--frontier", "--device", str(dev), "-o",
                out]
        if run != "default":
            argv += ["--backend", backend]
        stats.clear()
        wr.LAUNCHES = repair.LAUNCHES = 0
        t0 = time.perf_counter()
        cli.main(argv)
        secs = time.perf_counter() - t0
        runs[run] = {"gfa": _read(out), "seconds": secs,
                     "window_resolve": wr.LAUNCHES,
                     "repair_pass": repair.LAUNCHES,
                     "esa": dict(stats)}
    d, j = runs["default"], runs[backend]
    if d["esa"] or not j["esa"]:
        raise AssertionError("rem %s: the device build ran %s with the "
                             "default backend, %s with --backend %s"
                             % (label, d["esa"], j["esa"], backend))
    if j["gfa"] != d["gfa"]:
        raise AssertionError("rem %s --backend %s: GFA (%d bytes) differs "
                             "from the default backend's (%d bytes)"
                             % (label, backend, len(j["gfa"]),
                                len(d["gfa"])))
    launches = {k: j[k] for k in ("window_resolve", "repair_pass")}
    if launches != {k: d[k] for k in launches} or not (
            any(launches.values()) or torch.device(dev).type == "cpu"):
        raise AssertionError("rem %s: launches %s with --backend %s, %s "
                             "with the default" % (label, launches, backend,
                                                   d))
    print("rem %s --backend %s --device %s: GFA byte-identical to the "
          "default backend's (%d bytes); window_resolve %d, repair_pass %d "
          "launches, as with the default; end to end (CLI in-process) %.6f s "
          "against %.6f s with the default backend; the device build %d "
          "rounds, %.6f s (rounds %.6f, LCP %.6f, copy %.6f)"
          % (label, backend, dev, len(j["gfa"]), launches["window_resolve"],
             launches["repair_pass"], j["seconds"], d["seconds"],
             j["esa"]["rounds"], sum(j["esa"][k] for k in (
                 "rounds_seconds", "lcp_seconds", "copy_seconds")),
             j["esa"]["rounds_seconds"], j["esa"]["lcp_seconds"],
             j["esa"]["copy_seconds"]))
    return dict(launches, seconds=j["seconds"],
                default_seconds=d["seconds"])


def child_segments(sa, lcp, labels, k):
    """The root's SA split by ``labels`` (slot -> segment 0..k-1), each
    segment with its own LCP: the minimum of the parent's LCP over the
    slots between two of its own, as ``tests/test_frontier.py:88-101``
    builds it.  Returns [(SA, LCP) int32] for ``frontier_mums``."""
    import numpy as np

    segs = []
    for s in range(k):
        pos = np.nonzero(labels == s)[0]
        clcp = np.zeros(len(pos), dtype=np.int64)
        if len(pos) > 1:
            clcp[1:] = np.minimum.reduceat(lcp[: pos[-1] + 1], pos[:-1] + 1)
        segs.append((sa[pos].astype(np.int32), clcp.astype(np.int32)))
    return segs


def check_device_mums(root, dev, minl=ESA_MINL):
    """Phase 8 (c) on (a)'s 2 x 2 Mbp root built on the card:
    ``pairwise_mums_device`` against the host ``pairwise_mums`` as sorted
    (l, a, b), and ``frontier_mums`` over two children of the root against
    the host scan of each child: the interleaved pseudo-segments of
    ``tests/test_frontier.py`` (slots of even and of odd rank), and the
    suffixes that start in the first half of either genome against the
    rest."""
    import numpy as np
    import torch

    from reveal_tpu_torch.index import frontier
    from reveal_tpu_torch.index.mums import pairwise_mums, pairwise_mums_device

    T, nsep, sa, lcp = root
    nsep0 = int(nsep[0])
    Td = torch.from_numpy(T).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    got = pairwise_mums_device(
        Td, *(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (sa, lcp)),
        nsep0, minl)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = pairwise_mums(T, sa, lcp, nsep0, minl=minl)
    t_host = time.perf_counter() - t0
    want = sorted((m[0], m[2][0][1], m[2][1][1]) for m in host)
    if sorted(zip(*(x.tolist() for x in got))) != want or not want:
        raise AssertionError("pairwise_mums_device: %d MUMs, the host scan "
                             "%d" % (len(got[0]), len(want)))
    print("pairwise_mums_device on the 2 x 2 Mbp root (device-built SA/LCP, "
          "minl %d): %d MUMs equal to the host pairwise_mums; %.6f s (the "
          "host scan %.6f s)" % (minl, len(want), t_dev, t_host))
    n = len(sa)
    half = ((sa >= nsep0 // 2) & (sa <= nsep0)) | (
        sa >= nsep0 + 1 + (n - nsep0 - 1) // 2)
    for name, labels in (("interleaved", np.arange(n) % 2),
                         ("genome halves", half.astype(np.int64))):
        segs = child_segments(sa, lcp, labels, 2)
        _sync(dev)
        t0 = time.perf_counter()
        fm = frontier.frontier_mums(segs, Td, nsep0, minl)
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        hs = [pairwise_mums(T, csa.astype(np.int64), clcp.astype(np.int64),
                            nsep0, minl=minl) for csa, clcp in segs]
        t_host = time.perf_counter() - t0
        for s, (g, w) in enumerate(zip(fm, hs)):
            if sorted(g) != sorted(w):
                raise AssertionError("frontier_mums (%s) segment %d: %d "
                                     "MUMs, the host scan %d"
                                     % (name, s, len(g), len(w)))
        print("frontier_mums over two %s children of the 2 x 2 Mbp root "
              "(%s slots): %s MUMs equal to the per-segment host scans; %.6f "
              "s (the host scans %.6f s)"
              % (name, " + ".join(str(len(c[0])) for c in segs),
                 " + ".join(str(len(g)) for g in fm), t_dev, t_host))


def run_esa(seed, length, fastas, workdir, dev):
    """Phase 8: (a) the device build against the native one, (b) ``rem
    --backend jax`` against the default backend on the 2 x ``length``
    pair of ``fastas`` (the forest) and on 6 x 100 kbp (the multi loop),
    (c) the device MUM scans.  Returns (b)'s launches."""
    _esa, root = check_device_esa(seed, dev)
    six, _bp, _want = write_population(6, 100_000, seed, workdir)
    rem = {"pair": run_rem_backends("2 x %d bp" % length, fastas, workdir,
                                    dev),
           "six": run_rem_backends("6 x 100 kbp", six, workdir, dev)}
    check_device_mums(root, dev)
    return rem


# ----------------------------------------------------------------------
# phase 9: the distributed suffix-array build and the sharded pipeline step
# ----------------------------------------------------------------------
# (a)'s roots: those of phase 8 at npad 2^22 and 2^25
DIST_CASES = (("2 x 2 Mbp", 2, 2_000_000), ("2 x 16 Mbp", 2, 16_000_000))
# (d): gloo worlds on the card machine's CPU, and the root they build
# (6 x 100 kbp, npad 2^20, until the script outgrew its time)
DIST_WORLDS = (2, 4)
DIST_WORLD_ROOT = (6, 50_000)
# (c)'s real batch: pairs of 400-511 bp at the chain's 512 x 512 bucket
STEP_PAIRS, STEP_SQUARE = 64, 512


def _equal_esa(label, got, want):
    import numpy as np

    for name, g, w in zip(("SA", "LCP", "SAi"), got, want):
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError("%s: %s differs from the native build's"
                                 % (label, name))


def check_dist_esa(seed, dev):
    """Phase 9 (a): ``build_esa_distributed`` in a world of one under
    NCCL on the roots of ``DIST_CASES``, LCP stride None and "sqrt": SA,
    LCP and SAi exactly the native build's; the rounds, the LCP descent
    and the gather and copy on a synchronised clock, the peak device
    memory, the collectives posted; ``build_esa_device`` and the native
    build timed beside it.  Returns the first root (T, nsep, SA, LCP)."""
    import torch
    import torch.distributed as dist

    from reveal_tpu_torch.index import suffix
    from reveal_tpu_torch.parallel import dsa
    from reveal_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=dev)
    if dist.get_backend(mesh.group) != "nccl" or mesh.size != 1:
        raise AssertionError("the mesh is %s of %d ranks, not a world of "
                             "one under NCCL"
                             % (dist.get_backend(mesh.group), mesh.size))
    # the first sorts of a process set up their workspaces: not timed
    dsa.build_esa_distributed(population_text(2, 30_000, seed)[0], mesh)
    root = None
    for label, n, length in DIST_CASES:
        T, nsep = population_text(n, length, seed)
        t0 = time.perf_counter()
        want = suffix.build_esa(T, "native")
        t_native = time.perf_counter() - t0
        _sync(dev)
        t0 = time.perf_counter()
        suffix.build_esa(T, "jax", device=dev)
        t_single = time.perf_counter() - t0
        for stride in (None, "sqrt"):
            _sync(dev)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            got = dsa.build_esa_distributed(T, mesh, lcp_ckpt_stride=stride)
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            st = dict(dsa.LAST_STATS)
            _equal_esa("distributed build %s stride %s" % (label, stride),
                       got, want)
            if st["p2p"] or st["P"] != 1:
                raise AssertionError("a world of one posted %d p2p "
                                     "exchanges" % st["p2p"])
            print("distributed build %s (n %d, npad 2^%d), world of one "
                  "(NCCL), LCP stride %s (kept every %s level): SA, LCP, SAi "
                  "equal to the native build's; %d doubling rounds of at most "
                  "%d; synchronised clock: rounds %.6f s, LCP descent and cap "
                  "%.6f s, gather and copy to the host %.6f s, "
                  "build_esa_distributed %.6f s; peak device memory %.6f GB "
                  "above the %.6f GB held before; %d all_gathers, %d p2p; "
                  "build_esa_device %.6f s, native SA-IS + Kasai %.6f s"
                  % (label, st["n"], st["npad"].bit_length() - 1, stride,
                     st["stride"] or 1, st["rounds"], st["nlev"] - 1,
                     st["rounds_seconds"], st["lcp_seconds"],
                     st["copy_seconds"], secs, peak / 1e9, base / 1e9,
                     st["all_gathers"], st["p2p"], t_single, t_native))
        if root is None:
            root = (T, nsep, want[0], want[1])
    return root


def run_dist_worlds(seed, workdir, frontier):
    """Phase 9 (d): gloo worlds of ``DIST_WORLDS`` ranks on this
    machine's CPU (processes started and stopped here), the
    ``DIST_WORLD_ROOT`` root built over each, exactly the native build on
    every rank, timed around the call; (h) in the same worlds the mesh frontier
    (``rem_on_world``) on phase 5d (d)'s 4 x 50 kbp: every rank's GFA
    the bytes of the card's single-device frontier."""
    from reveal_tpu_torch.align import rem
    from reveal_tpu_torch.index import suffix
    from reveal_tpu_torch.parallel import dsa
    from reveal_tpu_torch.parallel.distributed import World

    T, _nsep = population_text(*DIST_WORLD_ROOT, seed)
    want = suffix.build_esa(T, "native")
    card = frontier["d"]
    for P in DIST_WORLDS:
        store = os.path.join(workdir, "dist_world_%d" % P)
        t0 = time.perf_counter()
        with World(P, "file://" + store, device="cpu",
                   timeout=300) as world:
            # the processes start, join the group and build a small text
            world.run(dsa.build_on_world, T[:1000], device="cpu")
            t_up = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = world.run(dsa.build_on_world, T, device="cpu")
            secs = time.perf_counter() - t0
            t0 = time.perf_counter()
            mesh_rem = world.run(rem.rem_on_world, card["fastas"],
                                 device="cpu")
            rem_secs = time.perf_counter() - t0
        for rank, (got, st) in enumerate(res):
            _equal_esa("gloo world of %d, rank %d" % (P, rank), got, want)
        st = res[0][1]
        print("distributed build %d x %d bp (n %d, npad 2^%d) in a gloo "
              "world of %d ranks on the host's CPU: every rank's SA, LCP, "
              "SAi equal to the native build's; %d rounds; %.6f s for the "
              "call (rank 0: rounds %.6f s, LCP %.6f s, gather %.6f s; %d "
              "p2p exchanges, widest %d slots = 3 x sh); the world up "
              "(started, joined, a 1 kbp build) in %.3f s"
              % (*DIST_WORLD_ROOT, st["n"], st["npad"].bit_length() - 1, P,
                 st["rounds"], secs,
                 st["rounds_seconds"], st["lcp_seconds"], st["copy_seconds"],
                 st["p2p"], st["widest"], t_up))
        for rank, r in enumerate(mesh_rem):
            if r["gfa"] != card["gfa"]:
                raise AssertionError(
                    "mesh frontier in a gloo world of %d, rank %d: GFA (%d "
                    "bytes) differs from the card's (%d bytes)"
                    % (P, rank, len(r["gfa"]), len(card["gfa"])))
        ms = mesh_rem[0]["stats"]
        print("mesh frontier 4 x 50 kbp (phase 5d d) in a gloo world of %d "
              "ranks on the host's CPU: every rank's GFA equal to the card's "
              "single-device frontier (%d bytes); %.6f s for the call; rank "
              "0: levels %d, enumerate %.6f s, pick + surgery %.6f s, apply "
              "%.6f s, repair %.6f s; %d p2p, %d all_gathers, %d "
              "all_reduces, widest %d slots (sh %d, %d padding slots)"
              % (P, len(card["gfa"]), rem_secs, ms["levels"],
                 ms["enumerate_seconds"], ms["pick_seconds"],
                 ms["apply_seconds"], ms["repair_seconds"], ms["p2p"],
                 ms["all_gathers"], ms["all_reduces"], ms["widest"],
                 ms["mesh_sh"], ms["mesh_padded"]))


# (f): phase 5d's cases through the mesh frontier in the world of one
MESH_CASES = ("b", "c")


def run_mesh_frontier(frontier, dev):
    """Phase 9 (f): ``align_genomes(..., mesh=make_mesh(1))`` in the world
    of one under NCCL on phase 5d's cases ``MESH_CASES``, the GFA written
    as ``cli rem`` writes it: the bytes phase 5d's single-device frontier
    wrote, its levels, candidates and repair jobs; levels, the stages'
    seconds (each stage ends in a read on the host, the repairs in a
    device sync), the collectives posted and the peak device memory
    beside the single-device frontier's."""
    import torch
    import torch.distributed as dist

    from reveal_tpu_torch.align import rem
    from reveal_tpu_torch.index import devfrontier
    from reveal_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, dev)
    if dist.get_backend(mesh.group) != "nccl":
        raise AssertionError("the mesh's backend is %s, not NCCL"
                             % dist.get_backend(mesh.group))
    out = {}
    for label in MESH_CASES:
        single = frontier[label]
        _sync(dev)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        G, idx = rem.align_genomes(single["fastas"], mesh=mesh)
        gfa = rem.write_rem_gfa(G, idx, single["gfa"] + ".mesh.gfa")
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        st = dict(devfrontier.LAST_STATS)
        del G, idx
        if gfa != _read(single["gfa"]):
            raise AssertionError("mesh frontier case %s: GFA (%d bytes) "
                                 "differs from phase 5d's" % (label, len(gfa)))
        for key in ("levels", "applies", "steps", "candidates",
                    "repair_jobs"):
            if st[key] != single[key]:
                raise AssertionError("mesh frontier case %s: %s %d, the "
                                     "single-device frontier's %d"
                                     % (label, key, st[key], single[key]))
        if st["mesh_P"] != 1 or st["p2p"] or st["mesh_replicated"]:
            raise AssertionError("mesh frontier case %s: %r" % (label, st))
        print("mesh frontier case %s (%d fastas, %d bp), world of one "
              "(NCCL): GFA equal to phase 5d's (%d bytes); levels %d, apply "
              "calls %d, candidates %d, repair jobs %d (the single-device "
              "frontier's); enumerate %.6f s, pick + surgery %.6f s, apply "
              "%.6f s, repair %.6f s, frontier %.6f s (single-device: "
              "%.6f / %.6f / %.6f / %.6f / %.6f s), fastas to GFA %.6f s; %d "
              "all_gathers, %d all_reduces, %d p2p; host syncs %d (%d); peak "
              "device memory %.6f GB (single-device %.6f GB)"
              % (label, len(single["fastas"]), single["total_bp"], len(gfa),
                 st["levels"], st["applies"], st["candidates"],
                 st["repair_jobs"], st["enumerate_seconds"],
                 st["pick_seconds"], st["apply_seconds"],
                 st["repair_seconds"], st["seconds"],
                 single["enumerate_seconds"], single["pick_seconds"],
                 single["apply_seconds"], single["repair_seconds"],
                 single["seconds"], secs, st["all_gathers"],
                 st["all_reduces"], st["p2p"], st["host_syncs"],
                 single["host_syncs"], peak / 1e9, single["peak"] / 1e9))
        out[label] = dict(st, peak=peak, e2e=secs)
    return out


def run_dryrun(dev):
    """Phase 9 (g): the port's multichip dry run in the world of one."""
    from reveal_tpu_torch.parallel.dryrun import dryrun_multichip
    from reveal_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    line = dryrun_multichip(make_mesh(1, dev))
    print("%s (a world of one under NCCL on %s) in %.3f s"
          % (line, dev, time.perf_counter() - t0))


def hold_dp(x, y, lx, ly, label):
    """The forward and backward DP kernels against their plain versions
    on one batch (the step's own), limit 1e-4 x max(L1p, L2p) on the
    real cells; both times from CUDA events.  Returns {kernel: (err,
    shape, ms, plain_ms, bound_ms, bound_by)}."""
    import torch

    from reveal_tpu_torch.hmm import pairhmm_dp as dp
    from reveal_tpu_torch.hmm.pairhmm import default_params

    params = default_params(x.device)
    B, L1p, L2p = x.shape[0], x.shape[1], y.shape[1]
    xcls, ycls = dp._prep(x, y)
    xr, yr = dp._prep(dp._reverse_within(x, lx), dp._reverse_within(y, ly))
    plan = dp.launch_plan(B, L1p, L2p)
    lim = 1e-4 * max(L1p, L2p)
    runs = {
        "fwd": (lambda: dp.fwd_dp_plain(xcls, ycls, lx, params)[0],
                lambda: dp._launch_fwd(plan, xcls, ycls, lx, params)[0]),
        "bwd": (lambda: dp.flip_within(dp.bwd_dp_plain(xr, yr, params),
                                       lx, ly),
                lambda: dp._launch_bwd(plan, xr, yr, lx, ly, params)),
    }
    cells = int(((lx.long() + 1) * (ly.long() + 1)).sum())
    nbytes = (B * L1p * L2p * 4 + B * 5 * L2p * 4 + B * (L1p + L2p)
              + 8 * B + 408)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = SFU_PER_CELL * cells / SFU_OPS_PER_S * 1e3
    out = {}
    for name, (plain, kernel) in runs.items():
        err = _grid_err(kernel(), plain(), "%s %s" % (label, name))
        if err > lim:
            raise AssertionError("%s %s: kernel and plain differ by %g "
                                 "(limit %g)" % (label, name, err, lim))
        p_ms = _event_ms(plain, 1)
        k_ms = (_event_ms(kernel, 3) + _event_ms(kernel, 3)) / 2
        p_ms = (p_ms + _event_ms(plain, 1)) / 2
        out[name] = (err, [B, L1p, L2p], k_ms, p_ms, max(by_bytes, by_ops),
                     "bytes" if by_bytes >= by_ops else "operations")
        print("pipeline step %s %s kernel %d x %d x %d: max err %.3e against "
              "plain (limit %.3e); %.6f ms (plain %.6f ms; plain, kernel x3, "
              "kernel x3, plain); bound %.6f ms by %s; plan %s"
              % (label, name, B, L1p, L2p, err, lim, k_ms, p_ms,
                 out[name][4], out[name][5], _plan_text(plan)))
    return out


def run_pipeline_steps(root, seed, dev):
    """Phase 9 (c): ``build_pipeline_step`` in the world of one under
    NCCL, (1) at ``tests/test_torch_mesh.py``'s shapes (16 interleaved
    pseudo-segments of a 2 x 500 bp root, 8 pairs of 24 x 28 bp) and (2,
    "real") on the root's SA and LCP (phase 9 (a)'s 2 x 2 Mbp) split by
    the genomes' halves into two segments, in one group, with
    ``STEP_PAIRS`` related pairs
    at the chain's 512 x 512 bucket: the count that of the host scans
    (minl 1), ``cells`` exactly sum(lx * ly), the summed log-probability
    within 1e-5 of the native float64 pair-HMM's sum, one launch each of
    the forward and backward DP kernels a step, each held against its
    plain version on the step's own batch.  Returns the real step's
    launches and held numbers."""
    import numpy as np
    import torch

    from reveal_tpu_torch.hmm import msa
    from reveal_tpu_torch.hmm import pairhmm_dp as dp
    from reveal_tpu_torch.hmm.pairhmm import _pad_with_dummy
    from reveal_tpu_torch.index.frontier import pack_segments
    from reveal_tpu_torch.index import suffix
    from reveal_tpu_torch.index.mums import pairwise_mums
    from reveal_tpu_torch.parallel.mesh import (_columns4,
                                                build_pipeline_step,
                                                make_mesh)

    mesh = make_mesh(device=dev)
    rng = np.random.default_rng(seed + 21)
    T, nsep = population_text(2, 500, seed)
    sa, lcp, _sai = suffix.build_esa(T, "native")
    small = child_segments(sa, lcp, np.arange(len(sa)) % 16, 16)
    s1 = ["".join(rng.choice(list("ACGT"), size=24)) for _ in range(8)]
    s2 = ["".join(rng.choice(list("ACGT"), size=28)) for _ in range(8)]
    small_pairs = list(zip(s1, s2))
    xb = np.stack([_pad_with_dummy(a.encode(), 32) for a in s1])
    yb = np.stack([_pad_with_dummy(b.encode(), 32) for b in s2])
    cases = [("small", T, nsep, small, small_pairs, (xb, yb))]
    T2, nsep2, sa2, lcp2 = root
    n = len(sa2)
    n0 = int(nsep2[0])
    half = ((sa2 >= n0 // 2) & (sa2 <= n0)) | (
        sa2 >= n0 + 1 + (n - n0 - 1) // 2)
    big = child_segments(sa2, lcp2, half.astype(np.int64), 2)
    pairs = _related_pairs(rng, STEP_PAIRS, STEP_SQUARE * 25 // 32,
                           STEP_SQUARE - 1)
    x, y, _lx, _ly = dp.pack(pairs, STEP_SQUARE, STEP_SQUARE, "cpu")
    cases.append(("real", T2, nsep2, big, pairs, (x.numpy(), y.numpy())))
    held = {}
    for label, Tc, nsep_c, segs, prs, (xb, yb) in cases:
        nsep0 = int(nsep_c[0])
        SA, LCP, SEG = pack_segments(segs, n_groups=mesh.size)
        lx = np.array([len(a) for a, _ in prs], dtype=np.int32)
        ly = np.array([len(b) for _, b in prs], dtype=np.int32)
        t0 = time.perf_counter()
        host = [pairwise_mums(Tc, csa.astype(np.int64),
                              clcp.astype(np.int64), nsep0, minl=1)
                for csa, clcp in segs]
        t_host = time.perf_counter() - t0
        want = sum(len(h) for h in host)
        want_top = max(m[0] for h in host for m in h)
        nat = msa.batch_posteriors_cut_native(prs)
        nat_sum = float(sum(t for _p, t, _s in nat))
        step = build_pipeline_step(mesh, nsep0)
        step(Tc, SA, LCP, SEG, xb, yb, lx, ly)  # workspaces: not timed
        _sync(dev)
        dp.LAUNCHES["fwd"] = dp.LAUNCHES["bwd"] = 0
        t0 = time.perf_counter()
        count, cl, cp, cells, logprob = step(Tc, SA, LCP, SEG, xb, yb, lx,
                                             ly)
        count, cells, logprob = int(count), int(cells), float(logprob)
        secs = time.perf_counter() - t0
        launches = dict(dp.LAUNCHES)
        want_cells = int(np.sum(lx.astype(np.int64) * ly))
        rel = abs(logprob - nat_sum) / abs(nat_sum)
        if count != want or cells != want_cells or rel > 1e-5 or launches \
                != {"fwd": 1, "bwd": 1} or not np.isfinite(logprob):
            raise AssertionError(
                "pipeline step %s: count %d (host %d), cells %d (%d), "
                "logprob %r (native %r, %.3e relative), launches %s"
                % (label, count, want, cells, want_cells, logprob, nat_sum,
                   rel, launches))
        top = cl.cpu().numpy()
        if not np.all(np.diff(top) <= 0) or int(top[0]) != want_top:
            raise AssertionError("pipeline step %s: candidate lengths %s, "
                                 "the longest host MUM %d"
                                 % (label, top[:4], want_top))
        print("pipeline step %s (world of one, NCCL): %d candidate MUMs "
              "(host scans %d, %.6f s), top length %d; cells %d exact; "
              "logprob %.6f, native float64 %.6f (%.3e relative, limit "
              "1e-5); forward and backward DP launches %d and %d; the step "
              "%.6f s" % (label, count, want, t_host, int(top[0]), cells,
                          logprob, nat_sum, rel, launches["fwd"],
                          launches["bwd"], secs))
        dev_x = torch.from_numpy(np.ascontiguousarray(xb)).to(dev)
        dev_y = _columns4(torch.from_numpy(np.ascontiguousarray(yb)).to(dev))
        held[label] = hold_dp(dev_x, dev_y, torch.from_numpy(lx).to(dev),
                              torch.from_numpy(ly).to(dev), label)
    return {"launches": launches, "held": held["real"],
            "small": held["small"]}


def run_matches_backends(fastas, workdir, dev):
    """Phase 9 (e): ``cli matches`` (and ``--rc``) on phase 5's pair with
    ``--backend jax --device DEV`` against ``--backend native``: the same
    standard output and files."""
    import contextlib
    import io

    from reveal_tpu_torch import cli
    from reveal_tpu_torch.index import suffix

    for extra in ([], ["--rc"]):
        outs = {}
        for backend in ("native", "jax"):
            d = os.path.join(workdir, "matches_%s%s" % (backend,
                                                        "".join(extra)))
            os.makedirs(d)
            argv = ["matches", *fastas, "-m", "20", "--backend", backend,
                    "--device", str(dev), *extra]
            suffix.LAST_STATS.clear()
            buf = io.StringIO()
            cwd = os.getcwd()
            os.chdir(d)
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    cli.main(argv)
            finally:
                os.chdir(cwd)
            outs[backend] = (buf.getvalue(), sorted(os.listdir(d)),
                             time.perf_counter() - t0,
                             dict(suffix.LAST_STATS))
        nat, jx = outs["native"], outs["jax"]
        if jx[:2] != nat[:2] or not jx[3] or nat[3]:
            raise AssertionError("matches%s --backend jax --device %s: "
                                 "output differs from --backend native's "
                                 "(%d against %d bytes), device build %s"
                                 % (" ".join([""] + extra), dev, len(jx[0]),
                                    len(nat[0]), jx[3]))
        print("matches%s --backend jax --device %s on the 2 x 2 Mbp pair: "
              "stdout equal to --backend native's (%d lines); %.6f s against "
              "%.6f s; the device build ran %d rounds"
              % (" ".join([""] + extra), dev, jx[0].count("\n"), jx[2],
                 nat[2], jx[3]["rounds"]))


def run_dist(seed, length, fastas, workdir, dev, frontier):
    """Phase 9: (a) the distributed build in a world of one under NCCL,
    (b) ``rem --backend jax-dist`` against the default backend, (c) the
    pipeline step, (f) the mesh frontier and (g) the dry run in the world
    of one, (d) and (h) gloo worlds of 2 and 4 ranks on the CPU, (e)
    ``matches --backend jax`` on the card.  ``frontier``: phase 5d's
    cases.  Returns (b)'s launches and (c)'s numbers."""
    import torch.distributed as dist

    root = check_dist_esa(seed, dev)
    rem = run_rem_backends("2 x %d bp" % length, fastas, workdir, dev,
                           backend="jax-dist")
    step = run_pipeline_steps(root, seed, dev)
    run_mesh_frontier(frontier, dev)
    run_dryrun(dev)
    run_dist_worlds(seed, workdir, frontier)
    run_matches_backends(fastas, workdir, dev)
    dist.destroy_process_group()
    return rem, step


def run_mesh(seed, workdir, dev):
    """``--only mesh``: phase 5d (b)-(d), then phase 9 (f), (g) and the
    gloo worlds of (d) with (h)."""
    import torch.distributed as dist

    frontier = run_frontier(seed, workdir, labels=MESH_CASES)
    run_mesh_frontier(frontier, dev)
    run_dryrun(dev)
    run_dist_worlds(seed, workdir, frontier)
    dist.destroy_process_group()


def print_ptxas(report):
    """Registers, spills and shared memory of every kernel, from what
    ``ptxas -v`` said at the build."""
    name = None
    spill = ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.split("ptxas info    :")[-1].strip()
        elif "Used" in line and name:
            print("ptxas %s: %s; %s" % (
                name, line.split("ptxas info    :")[-1].strip(), spill))
            name = None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--length", type=int, default=2_000_000)
    ap.add_argument("--only", choices=["kernels", "profile", "multi",
                                       "chain", "frontier", "single",
                                       "align", "esa", "dist", "mesh"],
                    default=None,
                    help="'kernels': phases 1-4 only (the build and the "
                         "kernels against their plain versions); "
                         "'profile': phases 1-2 and 5b only; 'multi': "
                         "phases 1-2, window-resolve, 5c and 5f; "
                         "'chain': phases 1-2 and 5f; 'frontier': "
                         "phases 1-2 and 5d; 'single': phases 1-2 and 5e; "
                         "'align': phases 1-2 and 7; 'esa': phases 1-2 "
                         "and 8; 'dist': phases 1-2, 5d (b)-(d) and 9; "
                         "'mesh': phases 1-2, 5d (b)-(d), 9 (d) and "
                         "(f)-(h); each prints no result lines")
    ap.add_argument("--tree", default=None,
                    help="import reveal_tpu_torch from this checkout (a "
                         "parent's, to time it beside this one; the "
                         "profile phase needs its core/trace.py)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is False (torch %s)"
            % torch.__version__
        )
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else REPO)
    from reveal_tpu_torch.kernels import build
    from reveal_tpu_torch.native import get_lib

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi)
    print("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))

    # nvcc and g++ side by side
    t0 = time.perf_counter()
    native = {}

    def build_native():
        t = time.perf_counter()
        native["lib"] = get_lib()
        native["seconds"] = time.perf_counter() - t

    th = threading.Thread(target=build_native)
    th.start()
    so = build.build()
    build.load_library()
    print("kernels built: %s in %.3f s" % (os.path.relpath(so, REPO),
                                           time.perf_counter() - t0))
    th.join()
    if native.get("lib") is None:
        raise RuntimeError("the native host engine failed to build")
    print("native host engine built/loaded in %.3f s (beside nvcc)"
          % native["seconds"])
    print_ptxas(build.ptxas_report())

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".smoke_") as wd:
        if args.only == "align":
            run_align(args.seed, wd)
            print("chip_smoke --only align: phases 1-2 and 7 passed")
            return
        fastas, total_bp = write_genomes(args.seed, args.length, wd)
        if args.only == "profile":
            profile_forest(fastas, total_bp, wd,
                           "tree %s:" % (args.tree or "."))
            print("chip_smoke --only profile: phases 1-2 and 5b passed")
            return
        if args.only == "multi":
            check_window_resolve(dev)
            run_multi(args.seed, wd)
            run_chain_scores(args.seed, wd)
            print("chip_smoke --only multi: phases 1-2, window-resolve, 5c "
                  "and 5f passed")
            return
        if args.only == "chain":
            run_chain_scores(args.seed, wd)
            print("chip_smoke --only chain: phases 1-2 and 5f passed")
            return
        if args.only == "frontier":
            run_frontier(args.seed, wd)
            print("chip_smoke --only frontier: phases 1-2 and 5d passed")
            return
        if args.only == "single":
            run_single(args.seed, wd)
            print("chip_smoke --only single: phases 1-2 and 5e passed")
            return
        if args.only == "esa":
            run_esa(args.seed, args.length, fastas, wd, dev)
            print("chip_smoke --only esa: phases 1-2 and 8 passed")
            return
        if args.only == "dist":
            frontier = run_frontier(args.seed, wd, labels=MESH_CASES)
            run_dist(args.seed, args.length, fastas, wd, dev, frontier)
            print("chip_smoke --only dist: phases 1-2, 5d (b)-(d) and 9 "
                  "passed")
            return
        if args.only == "mesh":
            run_mesh(args.seed, wd, dev)
            print("chip_smoke --only mesh: phases 1-2, 5d (b)-(d), 9 (d) and "
                  "(f)-(h) passed")
            return
        def done(phase):
            print("chip_smoke: %s done, %.1f s since the start"
                  % (phase, time.perf_counter() - t0))

        rows = [check_window_resolve(dev)] + check_pairhmm(dev)
        rows.append(check_repair(fastas, wd))
        rows.append(check_mea_score(dev))
        check_against_native(dev, args.seed)
        done("phases 1-4")
        if args.only == "kernels":
            print("chip_smoke --only kernels: phases 1-4 passed")
            return
        rem_launches, _gfa, _t_rem = run_rem(fastas, total_bp, wd)
        profile_forest(fastas, total_bp, wd, "this checkout:")
        done("phase 5-5b")
        _case_a, multi = run_multi(args.seed, wd)
        done("phase 5c")
        rows.append(run_chain_scores(args.seed, wd))
        done("phase 5f")
        frontier = run_frontier(args.seed, wd)
        done("phase 5d")
        single = run_single(args.seed, wd)
        done("phase 5e")
        launches, two_phase_batches, scans = run_refine(args.seed, wd)
        run_refine_options(args.seed, wd)
        main_scans = [dict(time_mea(p, nrows, 10), launches=n)
                      for p, nrows, n in scans.values()]
        del scans
        relax = time_relaxation(dev)
        run_mixed(args.seed, wd)
        done("phase 6-6b")
        run_rem_then_refine(os.path.join(wd, "single_a.gfa"), wd)
        done("phase 6c")
        align_a, align_b = run_align(args.seed, wd)
        done("phase 7")
        esa = run_esa(args.seed, args.length, fastas, wd, dev)
        done("phase 8")
        dist_rem, step = run_dist(args.seed, args.length, fastas, wd, dev,
                                  frontier)
        done("phase 9")
    # window-resolve runs the multi loop's repair rounds (case a's
    # launches and times at its shapes); it is off the pairwise rem path,
    # whose repair passes run csrc/repair_pass.cu (run_rem checked 0
    # launches there).  The synthetic shapes' numbers stay beside them.
    rows[0]["synthetic"] = {k: rows[0][k] for k in ("ms", "plain_ms",
                                                    "bound_ms")}
    rows[0].update(multi)
    # the main path of this slice: refine on the chain (72 bubbles)
    rows[1]["launches"] = launches["fwd"]
    rows[2]["launches"] = launches["bwd"]
    rows[3]["launches"] = rem_launches
    # the repair passes of the single-root loop (phase 5e case a)
    rows[3]["single_root"] = single
    rows[4]["launches"] = launches["mea"]
    for key, row in (("fwd_ms", rows[1]), ("bwd_ms", rows[2])):
        # what the two-phase route launched: batch, plan and time a launch
        row["two_phase_batches"] = [
            {"batch": b["batch"], "launches": b["launches"],
             "plan": b["plan"], "ms": b[key]} for b in two_phase_batches]
    # the MEA scan on the chain's own posteriors, at the shape most of
    # its launches take
    main = max(main_scans, key=lambda t: t["launches"])
    rows[4].update({k: main[k] for k in ("shape", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "bound_latency_ms")})
    rows[4]["main_path_shapes"] = main_scans
    rows[4]["relaxation_products"] = relax
    # the main path of this slice: align --run (phase 7); each row keeps
    # the launches of every path it lies on, and its smallest and largest
    # launch of the align run held against plain
    la, lb = align_a["launches"], align_b["launches"]
    for row, key, earlier in (
            (rows[0], "window_resolve", {"rem, 6 x 100 kbp (5c a)":
                                         rows[0]["launches"]}),
            (rows[1], "fwd", {"refine, 72 bubbles (6)": launches["fwd"]}),
            (rows[2], "bwd", {"refine, 72 bubbles (6)": launches["bwd"]}),
            (rows[3], "repair_pass", {"rem, 2 x 2 Mbp (5)": rem_launches,
                                      "single-root loop (5e a)":
                                      single["launches"]}),
            (rows[4], "mea_score", {"refine, 72 bubbles (6)":
                                    launches["mea"]})):
        row["paths"] = dict(earlier, **{
            "align --run, %d x %d bp (7a)" % ALIGN_A: la[key],
            "align --run --order sequential, 4 x 50 kbp (7b)": lb[key]})
        if key in ("window_resolve", "repair_pass"):
            row["paths"].update({
                "rem --backend jax, 2 x %d bp (8b)" % args.length:
                esa["pair"][key],
                "rem --backend jax, 6 x 100 kbp (8b)": esa["six"][key],
                "rem --backend jax-dist, 2 x %d bp (9b)" % args.length:
                dist_rem[key]})
        if key in ("fwd", "bwd"):
            row["paths"]["build_pipeline_step, %d x %d x %d (9c)" % (
                STEP_PAIRS, STEP_SQUARE, STEP_SQUARE)] = step["launches"][key]
            row["pipeline_step_held"] = {
                which: dict(zip(("max_abs_err", "shape", "ms", "plain_ms",
                                 "bound_ms", "bound_by"), h[key]))
                for which, h in (("real", step["held"]),
                                 ("small", step["small"]))}
        row["launches"] = la[key] if key != "repair_pass" else lb[key]
        held = (align_a if key != "repair_pass" else align_b)["held"][key]
        row["align_held"] = {
            which: {"shape": shape, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by}
            for which, (err, shape, ms, plain_ms, bound_ms, bound_by)
            in held.items()}
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "reveal_tpu")]
    if loaded:
        raise AssertionError("imported: %s" % ", ".join(sorted(loaded)))
    print(smi)
    print(json.dumps({"kernels": rows}))
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
