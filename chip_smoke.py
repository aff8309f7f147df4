"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py [--seed 1] [--length 2000000]
                          [--only kernels|profile] [--tree DIR]

``--only kernels`` stops after phase 4 (about two minutes): the build and
the kernels against their plain versions, for work on a kernel.
``--only profile`` runs phases 1-2 and 5b only.  ``--tree DIR`` imports
``reveal_tpu_torch`` from the checkout at DIR instead of this one (with
``--only profile``: the parent's forest timed beside this one's, in
turns, on one card in one go).

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
   of 4 and 8 columns; at the two table shapes also the plan that ``refine``'s
   large batches of those shapes launch), and the two DP kernels alone at
   1,024 tiny pairs; the repair-pass kernel (``index/repair.py``) against
   its plain version (the batched rounds) on the card, at the inputs of
   every repair pass of the main path: two genomes from
   ``simulate_population(2, length, seed)`` go through ``cli rem
   --frontier --device cuda`` while each pass is run on copies plain,
   kernel, kernel, plain (SA, LCP, BWT and the counters exactly equal),
   with the times of both from CUDA events;
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
   host syncs, device time, the card's busy share, the kernels that take
   the most device time);
6. ``refine``: a six-path chain of bubbles (64 with alleles near 500 bp,
   8 near 1900 bp, 10-15% substitutions and indels up to 12 bp between
   alleles) written from ``--seed``, through ``cli refine --all
   --minsize 2 --maxsize 10000 --device cuda``; every path of the
   refined GFA must spell its input, every bubble must come back
   aligned, and the forward and backward kernels must each have been
   launched once per batch.  The same GFA then goes through the native
   float64 route for stage 1 and the number of bubbles whose refined
   subgraph differs is printed.  Stage 1 is then run again on the same
   pairs phase by phase (pack and copy in, classes and reversal, forward
   kernel, backward kernel, combine, cut with the MEA row scan, top-K and
   copy back), which gives the kernels' time at every batch ``refine``
   launched and their share of stage 1;
7. ``rem`` then ``refine`` end to end on the 2 x ``length`` GFA of
   phase 5.

Limits: M and G0 cells where kernel and plain are both above LOG_ZERO/2
agree within 1e-4 * max(L1p, L2p) (float32 at magnitudes that grow with
the length); posteriors within gate = max(2e-3, 4e-5 * max(lx, ly)).  The
card's MEA score equals the host MEA DP of the card's own dense posterior
within 1e-5 relative (the row scan, apart from float32 drift of the DP),
and the native float64 route's score within 1e-2 * min(lx, ly): a score
sums one posterior per aligned base, the float32 errors of a pair's cells
share their sign, and sound runs read about 4e-3 a base at 2048 bp.

The line before the last is a JSON object describing the kernels; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

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


def check_repair(fastas, workdir):
    """The repair-pass kernel against its plain version on the card, at
    the inputs of every repair pass of the main path.

    ``repair.repair_segments`` is wrapped for one ``rem`` run: each pass
    is first run on fresh copies of SA, LCP and BWT plain, kernel,
    kernel, plain (``devloop.repair_rounds_plain``, the batched rounds,
    against the kernel), each call between two CUDA events, the outputs
    and counters held exactly equal; then the pass goes on as the path
    runs it.  Returns the row of the kernels line."""
    import torch

    from reveal_tpu_torch import cli
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
        cli.main(["rem", *fastas, "--frontier", "--device", "cuda", "-o",
                  os.path.join(workdir, "repair_check.gfa")])
    finally:
        repair.repair_segments = segments
    if not passes:
        raise AssertionError("the rem run made no repair pass")
    k = len(passes)

    def total(key):
        return sum(p[key] for p in passes)

    ms, plain_ms = total("ms") / k, total("plain_ms") / k
    bound_ms = total("bound_bytes_ms") / k
    chain_ms = total("bound_chain_ms") / k
    print("repair_pass: kernel equal to plain (SA, LCP, BWT, counters; "
          "max_abs_err %d) on all %d repair passes of the main path; per "
          "pass from CUDA events on fresh copies (plain, kernel, kernel, "
          "plain): kernel %.6f ms (sum %.6f, max %.6f), plain %.6f ms (sum "
          "%.6f, max %.6f); candidates applied %d, longest run %d, moved "
          "slots %d (%d bytes); bound per pass %.6f ms by bytes at 3.35 "
          "TB/s, %.6f ms as the longest run's chain of dependent L2 round "
          "trips (260 clocks at 1.98 GHz each)"
          % (worst, k, ms, total("ms"), max(p["ms"] for p in passes),
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
        "name": "repair_pass",
        "route": "cuda",
        "source": "reveal_tpu_torch/csrc/repair_pass.cu",
        "replaces": "reveal_tpu/index/devloop.py:114",
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "bound_latency_ms": chain_ms,
        "library_ms": None,
        "passes": k,
        "ms_sum": total("ms"),
        "plain_ms_sum": total("plain_ms"),
        "longest_run": max(p["chain"] for p in passes),
        "moved_slots": total("moved"),
    }


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
                      _diverge(rng, x, 0.12, hi).decode()))
    return pairs


def _diverge(rng, seq, sub_rate, maxlen=None):
    """A copy of ``seq`` (uint8 array of ACGT) with ``sub_rate`` true
    substitutions and one indel of 1..12 bp per ~260 bp."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    code = np.searchsorted(bases, seq)
    hit = rng.random(len(seq)) < sub_rate
    code[hit] = (code[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    out = bytearray(bases[code].tobytes())
    for _ in range(len(seq) // 260 + 1):
        p = int(rng.integers(0, len(out)))
        ln = int(rng.integers(1, 13))
        if rng.random() < 0.5 and len(out) > 2 * ln:
            del out[p:p + ln]
        else:
            out[p:p] = bases[rng.integers(0, 4, ln)].tobytes()
    if maxlen is not None:
        del out[maxlen:]
    return bytes(out)


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

    def compare(name, pairs, time_iters=0, plain_again=True, force=()):
        """Kernels against plain under the plan ``launch_plan`` picks and
        then under every strip width of ``force``, on the same plain
        grids: both strip widths and every way of laying pairs over warps
        are checked on every run, the main path's among them."""
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
    return rows


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


# the forest's stage functions, in the order of a level
FOREST_STAGES = ("enumerate_candidates", "trim_dim", "chain_dense",
                 "log_anchors", "children", "split_level", "repair_pass")


def profile_forest(fastas, total_bp, workdir, label):
    """``rem`` three times more through the CLI, the forest watched: a
    warm-up run, a run with a synchronised host clock around every call
    of each of the forest's stage functions, and a run under
    ``torch.profiler`` over ``rem_device_forest``.  Only names that this
    checkout and its parent both have (the stage functions,
    ``rem_device_forest``, ``LAST_STATS``) are used, so that ``--tree``
    can run it on the parent."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from reveal_tpu_torch import cli
    from reveal_tpu_torch.index import devloop

    out = os.path.join(workdir, "profile.gfa")

    def rem():
        t0 = time.perf_counter()
        cli.main(["rem", *fastas, "--frontier", "--device", "cuda", "-o",
                  out])
        return time.perf_counter() - t0

    t_first = rem()
    originals = {name: getattr(devloop, name) for name in FOREST_STAGES}
    secs = dict.fromkeys(FOREST_STAGES, 0.0)
    calls = dict.fromkeys(FOREST_STAGES, 0)

    def clocked(name):
        fn = originals[name]

        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            calls[name] += 1
            return res
        return run

    for name in FOREST_STAGES:
        setattr(devloop, name, clocked(name))
    try:
        t_e2e = rem()
    finally:
        for name, fn in originals.items():
            setattr(devloop, name, fn)
    st = dict(devloop.LAST_STATS)
    rest = t_e2e - st["forest_seconds"] - st["host_prefix_seconds"]
    print("%s rem (first run in the process %.6f s end to end), then with "
          "a synchronised host clock around each call of the forest's "
          "stages: %s; forest %.6f s, host prefix %.6f s, the rest of rem "
          "(fasta read, host ESA, replay, GFA write) %.6f s, end to end "
          "%.6f s (%.6f Mbp/s)"
          % (label, t_first,
             ", ".join("%s %.6f s (%d calls)" % (n, secs[n], calls[n])
                       for n in FOREST_STAGES),
             st["forest_seconds"], st["host_prefix_seconds"], rest, t_e2e,
             total_bp / 1e6 / t_e2e))

    forest = devloop.rem_device_forest
    traced = {}

    def profiled(*args, **kw):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = forest(*args, **kw)
            torch.cuda.synchronize()
            traced["wall"] = time.perf_counter() - t0
        traced["prof"] = prof
        return res

    devloop.rem_device_forest = profiled
    try:
        rem()
    finally:
        devloop.rem_device_forest = forest
    counts = {}
    for evt in traced["prof"].key_averages():
        counts[evt.key] = counts.get(evt.key, 0) + evt.count
    # device time: the kernels and copies themselves (an operator's own
    # device time repeats its kernels'), by name
    by_name = {}
    for evt in traced["prof"].events():
        if evt.device_type == DeviceType.CUDA:
            us, n = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (us + evt.time_range.elapsed_us(), n + 1)
    device = [(us, n, name) for name, (us, n) in by_name.items()]
    device_us = sum(d[0] for d in device)
    launches = sum(v for k, v in counts.items()
                   if k in ("cudaLaunchKernel", "cuLaunchKernel",
                            "cuLaunchKernelEx", "cudaLaunchKernelExC"))
    syncs = counts.get("aten::_local_scalar_dense", 0)
    stream_syncs = counts.get("cudaStreamSynchronize", 0)
    busy = ("%.1f%%" % (100.0 * device_us / 1e6 / traced["wall"])
            if device_us > 0 else "not measured (no device time traced)")
    print("%s forest under torch.profiler: %d kernel launches, %d host syncs "
          "(aten::_local_scalar_dense: .item(), int(), bool() of a device "
          "value), %d cudaStreamSynchronize, device time %.6f s over a "
          "traced forest wall of %.6f s: card busy %s"
          % (label, launches, syncs, stream_syncs, device_us / 1e6,
             traced["wall"], busy))
    for us, count, key in sorted(device, reverse=True)[:8]:
        print("  device %.6f s in %d calls of %s" % (us / 1e6, count,
                                                    key[:90]))
    for us, count, key in device:
        if "repair_pass" in key or "window_resolve" in key:
            print("  the port's own kernel %s: device %.6f s in %d calls, "
                  "%.6f ms a call" % (key[:90], us / 1e6, count,
                                      us / 1e3 / count))


def write_bubble_chain(path, seed, n_small=64, small=500, n_big=8,
                       big=1900, npaths=6, flank=40, bubbles=None):
    """Write a GFA of a chain of bubbles between shared flank nodes,
    ``npaths`` paths, every bubble with one allele per path: each allele
    is its bubble's random ancestor with 5-7.5% substitutions (10-15%
    between two alleles) and indels of up to 12 bp.  Returns {path name:
    sequence}; a list given as ``bubbles`` receives the alleles of each
    bubble in path order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    sizes = [small] * n_small + [big] * n_big
    order = rng.permutation(len(sizes))
    segs = []           # (id, sequence)
    links = []
    walks = [[] for _ in range(npaths)]
    seqs = [[] for _ in range(npaths)]
    nid = 0

    def add(seq):
        nonlocal nid
        nid += 1
        segs.append((nid, seq))
        return nid

    prev = add(bases[rng.integers(0, 4, flank)].tobytes().decode())
    for k in range(npaths):
        walks[k].append(prev)
        seqs[k].append(segs[-1][1])
    for bi in order:
        n = int(sizes[bi] * (0.94 + 0.06 * rng.random()))
        anc = bases[rng.integers(0, 4, n)].copy()
        alleles = []
        for k in range(npaths):
            rate = 0.05 + 0.025 * rng.random()
            alleles.append(add(_diverge(rng, anc, rate).decode()))
        if bubbles is not None:
            bubbles.append([segs[a - 1][1] for a in alleles])
        sink_seq = bases[rng.integers(0, 4, flank)].tobytes().decode()
        sink = add(sink_seq)
        for k, a in enumerate(alleles):
            links.append((prev, a))
            links.append((a, sink))
            walks[k] += [a, sink]
            seqs[k] += [segs[a - 1][1], sink_seq]
        prev = sink
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        for i, s in segs:
            fh.write("S\t%d\t%s\n" % (i, s))
        for u, v in links:
            fh.write("L\t%d\t+\t%d\t+\t0M\n" % (u, v))
        for k in range(npaths):
            fh.write("P\tp%d\t%s\t%s\n" % (
                k, ",".join("%d+" % n for n in walks[k]),
                ",".join(["0M"] * (len(walks[k]) - 1))))
    return {"p%d" % k: "".join(seqs[k]) for k in range(npaths)}


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


def _expected_batches(pair_shapes):
    """Batches that pairs of these padded shapes make on the card."""
    from reveal_tpu_torch.hmm import pairhmm_dp as dp

    return sum(math.ceil(c / dp.batch_size(L1p, L2p, "cuda"))
               for (L1p, L2p), c in pair_shapes.items())


def _refine_on_card(gfa, out, label):
    """One ``cli refine`` run on the card with the launch counts read
    around it; returns (launches, stats, seconds)."""
    import torch

    from reveal_tpu_torch import cli
    from reveal_tpu_torch.hmm import pairhmm_dp as dp
    from reveal_tpu_torch.hmm import refine

    torch.cuda.reset_peak_memory_stats()
    dp.LAUNCHES["fwd"] = dp.LAUNCHES["bwd"] = 0
    t0 = time.perf_counter()
    cli.main(["refine", gfa, "--all", "--minsize", "2", "--maxsize",
              "10000", "--device", "cuda", "-o", out])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(dp.LAUNCHES)
    st = dict(refine.LAST_STATS)
    want = _expected_batches(st["pair_shapes"])
    if not (launches["fwd"] == launches["bwd"] == want and want > 0):
        raise AssertionError(
            "%s: %d forward and %d backward launches for %d batches"
            % (label, launches["fwd"], launches["bwd"], want))
    if st["refined"] != st["bubbles"] or not st["pairs"] > 0:
        raise AssertionError("%s: refine stats %r"
                             % (label, {k: v for k, v in st.items()
                                        if k != "digests"}))
    if st["aligned_bubbles"] != st["bubbles"]:
        raise AssertionError("%s: %d of %d refined bubbles are marked "
                             "aligned" % (label, st["aligned_bubbles"],
                                          st["bubbles"]))
    print("%s: %d bubbles, %d pairs, %d posterior cells, %d batches "
          "(forward = backward launches); extract %.6f s, stage 1 on the "
          "card %.6f s (%.6f Mcells/s), host MSA %.6f s, splice %.6f s, "
          "end to end (GFA -> GFA, CLI in-process) %.6f s; peak device "
          "memory %.6f GB"
          % (label, st["bubbles"], st["pairs"], st["cells"], want,
             st["extract_seconds"], st["stage1_seconds"],
             st["cells"] / 1e6 / max(st["stage1_seconds"], 1e-9),
             st["msa_seconds"], st["splice_seconds"], secs,
             torch.cuda.max_memory_allocated() / 1e9))
    return launches, st, secs


def run_refine(seed, workdir):
    """The refine path at a real size, then the native float64 route for
    stage 1 on the same GFA."""
    from reveal_tpu_torch.core.io_gfa import read_gfa
    from reveal_tpu_torch.hmm import refine

    gfa = os.path.join(workdir, "bubbles.gfa")
    bubbles = []
    want = write_bubble_chain(gfa, seed, bubbles=bubbles)
    out = os.path.join(workdir, "bubbles.refined.gfa")
    launches, st, _secs = _refine_on_card(gfa, out, "refine")
    if (st["bubbles"] != 72 or st["pairs"] != 72 * 15
            or st["cells"] < 200_000_000):
        raise AssertionError("refine: %d bubbles, %d pairs, %d cells"
                             % (st["bubbles"], st["pairs"], st["cells"]))
    _check_paths(out, want)
    print("refine: every path of the refined GFA spells its input")

    t0 = time.perf_counter()
    refine.refine_all(read_gfa(gfa), stage1="native", **REFINE_KW)
    nat = dict(refine.LAST_STATS)
    differ = sum(a != b for a, b in zip(st["digests"], nat["digests"]))
    if len(st["digests"]) != len(nat["digests"]):
        raise AssertionError("the two routes refined %d and %d bubbles"
                             % (len(st["digests"]), len(nat["digests"])))
    print("refine, stage 1 by the native float64 host pair-HMM instead: "
          "%d of %d bubbles' refined subgraphs differ from the card's; "
          "stage 1 %.6f s on the host, whole run %.6f s"
          % (differ, len(nat["digests"]), nat["stage1_seconds"],
             time.perf_counter() - t0))
    return launches, stage1_split(bubbles, st)


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


def run_rem_then_refine(rem_gfa, workdir, t_rem):
    """``refine --all --minsize 2`` on the GFA ``rem`` wrote."""
    from reveal_tpu_torch.core.io_gfa import read_gfa
    from reveal_tpu_torch.graph.extract import extract

    G = read_gfa(rem_gfa)
    want = {name: extract(G, name) for name in G.graph["paths"]}
    out = os.path.join(workdir, "port.refined.gfa")
    _l, _st, secs = _refine_on_card(rem_gfa, out, "rem then refine")
    _check_paths(out, want)
    print("rem then refine: paths round-trip; rem %.6f s + refine %.6f s"
          % (t_rem, secs))


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
    ap.add_argument("--only", choices=["kernels", "profile"], default=None,
                    help="'kernels': phases 1-4 only (the build and the "
                         "kernels against their plain versions); "
                         "'profile': phases 1-2 and 5b only; either prints "
                         "no result lines")
    ap.add_argument("--tree", default=None,
                    help="import reveal_tpu_torch from this checkout (a "
                         "parent's, to time it beside this one)")
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
        fastas, total_bp = write_genomes(args.seed, args.length, wd)
        if args.only == "profile":
            profile_forest(fastas, total_bp, wd,
                           "tree %s:" % (args.tree or "."))
            print("chip_smoke --only profile: phases 1-2 and 5b passed")
            return
        rows = [check_window_resolve(dev)] + check_pairhmm(dev)
        rows.append(check_repair(fastas, wd))
        check_against_native(dev, args.seed)
        if args.only == "kernels":
            print("chip_smoke --only kernels: phases 1-4 passed")
            return
        rem_launches, rem_gfa, t_rem = run_rem(fastas, total_bp, wd)
        profile_forest(fastas, total_bp, wd, "this checkout:")
        dp_launches, dp_batches = run_refine(args.seed, wd)
        run_rem_then_refine(rem_gfa, wd, t_rem)
    # window-resolve is off the rem path since the repair pass became one
    # kernel (run_rem checked that it launched 0 times there)
    rows[0]["launches"] = 0
    rows[0]["main_path"] = ("none: rem's repair passes run "
                            "csrc/repair_pass.cu, which searches itself")
    rows[1]["launches"] = dp_launches["fwd"]
    rows[2]["launches"] = dp_launches["bwd"]
    rows[3]["launches"] = rem_launches
    for key, row in (("fwd_ms", rows[1]), ("bwd_ms", rows[2])):
        # what the main path launched: batch, plan and time a launch
        row["main_path_batches"] = [
            {"batch": b["batch"], "launches": b["launches"],
             "plan": b["plan"], "ms": b[key]} for b in dp_batches]
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "reveal_tpu")]
    if loaded:
        raise AssertionError("imported: %s" % ", ".join(sorted(loaded)))
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
