"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py [--seed 1] [--length 2000000]

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card's name and power limit (nvidia-smi);
2. the build of every CUDA kernel of the port and of the native host
   engine (side by side), timed;
3. each kernel against its plain torch version on the card, at the main
   paths' shapes plus edge cases, with both times from CUDA events:
   window-resolve (exact int32 equality), the pair-HMM forward and
   backward DP (float32, limits stated below);
4. the card's posteriors against the native float64-exact host pair-HMM
   on a sample of pairs from each bucket;
5. ``rem``: two genomes from ``simulate_population(2, length, seed)``
   through ``python -m reveal_tpu_torch.cli rem --frontier --device
   cuda`` in-process, its GFA held byte for byte against the port's
   serial host engine (``align_genomes_host``), with the forest's
   counters and the kernel's launch count checked;
6. ``refine``: a six-path chain of bubbles (64 with alleles near 500 bp,
   8 near 1900 bp, 10-15% substitutions and indels up to 12 bp between
   alleles) written from ``--seed``, through ``cli refine --all
   --minsize 2 --maxsize 10000 --device cuda``; every path of the
   refined GFA must spell its input, every bubble must come back
   aligned, and the forward and backward kernels must each have been
   launched once per batch.  The same GFA then goes through the native
   float64 route for stage 1 and the number of bubbles whose refined
   subgraph differs is printed;
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

RBV = 1024   # repair candidates per round on the main path
WRV = 256    # window-resolve lookback

# NVIDIA H100 SXM, published peaks: HBM3 at 3.35 TB/s; float32 outside
# the tensor cores at 67 TFLOP/s; exp2/log2 at 16 results per clock per
# SM (CUDA programming guide, compute capability 9.0) on 132 SMs at the
# 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
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


def check_pairhmm(dev):
    """Forward and backward kernels vs their plain versions on the
    card, and the posterior after the combine; times at the two main
    shapes.  Returns the two rows of the kernels line."""
    import numpy as np
    import torch

    from reveal_tpu_torch.hmm import pairhmm_dp as dp
    from reveal_tpu_torch.hmm.pairhmm import default_params

    params = default_params(dev)
    rng = np.random.default_rng(7)
    worst = {"fwd": 0.0, "bwd": 0.0, "post": 0.0}
    times = {}

    def compare(name, pairs, time_iters=0, plain_again=True):
        (batch,) = list(dp.batches(pairs, dev))
        L1p, L2p, _idxs, x, y, lx, ly = batch
        B = len(pairs)
        lim = 1e-4 * max(L1p, L2p)
        xcls, ycls = dp._prep(x, y)
        xr, yr = dp._prep(dp._reverse_within(x, lx),
                          dp._reverse_within(y, ly))
        m_k, snap_k = dp.fwd_dp(xcls, ycls, lx, params)
        m_p, snap_p = dp.fwd_dp_plain(xcls, ycls, lx, params)
        b_k = dp.bwd_dp(xr, yr, lx, ly, params)
        b_p = dp.flip_within(dp.bwd_dp_plain(xr, yr, params), lx, ly)
        torch.cuda.synchronize()
        e_f = max(_grid_err(m_k, m_p, name + " M"),
                  _grid_err(snap_k, snap_p, name + " snapshot"))
        e_b = _grid_err(b_k, b_p, name + " G0")
        del m_k, b_k, snap_k
        p_k, t_k = dp.posterior_batch(x, y, lx, ly, params)
        # the plain posterior: the same combine on the plain grids
        p_p, t_p = dp.combine(m_p, snap_p, b_p, lx, ly, params)
        del m_p, b_p, snap_p
        torch.cuda.synchronize()
        if not bool(torch.isfinite(p_k).all()):
            raise AssertionError("%s: posterior not finite" % name)
        per_pair = (p_k - p_p).abs().amax(dim=(1, 2))
        gate = torch.clamp(4e-5 * torch.maximum(lx, ly).float(), min=2e-3)
        e_p = float(per_pair.max())
        e_t = float((t_k - t_p).abs().max())
        print("pairhmm %-22s B=%-4d L1p=%-5d L2p=%-5d max |M| err %.3e, "
              "|G0| err %.3e (limit %.3e), posterior err %.3e (limit "
              "%.3e), total err %.3e"
              % (name, B, L1p, L2p, e_f, e_b, lim, e_p, float(gate.min()),
                 e_t))
        if e_f > lim or e_b > lim:
            raise AssertionError("%s: DP grids differ by %g / %g, limit %g"
                                 % (name, e_f, e_b, lim))
        if bool((per_pair > gate).any()):
            raise AssertionError("%s: posteriors differ by %g" % (name, e_p))
        worst["fwd"] = max(worst["fwd"], e_f)
        worst["bwd"] = max(worst["bwd"], e_b)
        worst["post"] = max(worst["post"], e_p)
        del p_k, p_p
        if time_iters:
            def kf():
                dp.fwd_dp(xcls, ycls, lx, params)

            def kb():
                dp.bwd_dp(xr, yr, lx, ly, params)

            def pf():
                dp.fwd_dp_plain(xcls, ycls, lx, params)

            def pb():
                dp.bwd_dp_plain(xr, yr, params)

            kf(), kb()
            t = {}
            t["plain_fwd"] = _event_ms(pf, 1)
            t["plain_bwd"] = _event_ms(pb, 1)
            t["fwd"] = (_event_ms(kf, time_iters)
                        + _event_ms(kf, time_iters)) / 2
            t["bwd"] = (_event_ms(kb, time_iters)
                        + _event_ms(kb, time_iters)) / 2
            if plain_again:
                t["plain_fwd"] = (t["plain_fwd"] + _event_ms(pf, 1)) / 2
                t["plain_bwd"] = (t["plain_bwd"] + _event_ms(pb, 1)) / 2
            cells = B * L1p * L2p
            nbytes = (cells * 4 + B * 5 * L2p * 4 + B * (L1p + L2p)
                      + 8 * B + 408)
            t["bound"] = max(nbytes / HBM_BYTES_PER_S,
                             SFU_PER_CELL * cells / SFU_OPS_PER_S) * 1e3
            t["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                             >= SFU_PER_CELL * cells / SFU_OPS_PER_S
                             else "operations")
            t["cells"] = cells
            times[name] = t
            print("pairhmm %-22s per call from CUDA events (plain, kernel x%d"
                  ", kernel x%d%s): fwd %.6f ms (plain %.6f), bwd "
                  "%.6f ms (plain %.6f), bound %.6f ms by %s; %.6f Gcells/s "
                  "forward" % (name, time_iters, time_iters,
                               ", plain" if plain_again else "", t["fwd"],
                               t["plain_fwd"], t["bwd"], t["plain_bwd"],
                               t["bound"], t["bound_by"],
                               cells / t["fwd"] / 1e6))

    compare("B128_L512", _related_pairs(rng, 128, 300, 512), time_iters=10)
    # the plain version takes seconds a call here: timed once
    compare("B32_L2048", _related_pairs(rng, 32, 1100, 2048), time_iters=5,
            plain_again=False)
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
    compare("N_and_lowercase", nl)
    # rows wider than a block's shared memory holds: state in global
    wide = _related_pairs(rng, 2, 5000, 6000)
    compare("wider_than_shared", [(a[:48], b) for a, b in wide])
    # the widest bucket refine --maxsize 10000 can make (L2p = 16512)
    widest = _related_pairs(rng, 2, 9000, 10000)
    compare("widest_maxsize_10000", [(a[:48], b) for a, b in widest])

    rows = []
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
            "ms": main[key],
            "plain_ms": main["plain_" + key],
            "bound_ms": main["bound"],
            "bound_by": main["bound_by"],
            "library_ms": None,
            "ms_B32_L1p2049_L2p2176": big[key],
            "plain_ms_B32_L1p2049_L2p2176": big["plain_" + key],
            "bound_ms_B32_L1p2049_L2p2176": big["bound"],
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


def run_rem(seed, length, workdir):
    """Port CLI on the card vs the port's host engine; returns the
    window-resolve launches and the GFA path."""
    from reveal_tpu_torch import cli
    from reveal_tpu_torch.align.rem import align_genomes_host
    from reveal_tpu_torch.core.io_fasta import fasta_writer
    from reveal_tpu_torch.core.io_gfa import seq2node, write_gfa
    from reveal_tpu_torch.index import devloop
    from reveal_tpu_torch.index import window_resolve as wr
    from reveal_tpu_torch.utils.simulate import simulate_population

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
    G, idx = align_genomes_host(fastas)
    seq2node(G, idx.main.T)
    host_gfa = write_gfa(G, idx.main.T,
                         outputfile=os.path.join(workdir, "host.gfa"))
    t_host = time.perf_counter() - t0
    print("host engine (the port's serial native recursion): %.6f s"
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
    print("rem: GFA byte-identical to the host engine's (%d bytes)"
          % len(port_bytes))
    print(
        "forest: roots=%d slots=%d levels=%d repair_rounds=%d "
        "anchors=%d dispatches=%d chain_steps=%d trim_steps=%d"
        % (st["forest"], st["slots"], st["levels"], st["repair_steps"],
           st["anchors"], st["dispatches"], st["chain_steps"],
           st["trim_steps"])
    )
    print(
        "rem times: host_prefix %.6f s, forest %.6f s, end-to-end (fasta "
        "-> GFA, CLI in-process) %.6f s, %.6f Mbp/s (%d input bp)"
        % (st["host_prefix_seconds"], st["forest_seconds"], t_e2e,
           total_bp / 1e6 / t_e2e, total_bp)
    )
    return launches, port_gfa, t_e2e


def write_bubble_chain(path, seed, n_small=64, small=500, n_big=8,
                       big=1900, npaths=6, flank=40):
    """Write a GFA of a chain of bubbles between shared flank nodes,
    ``npaths`` paths, every bubble with one allele per path: each allele
    is its bubble's random ancestor with 5-7.5% substitutions (10-15%
    between two alleles) and indels of up to 12 bp.  Returns {path name:
    sequence}."""
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
    want = write_bubble_chain(gfa, seed)
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
    return launches


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

    rows = [check_window_resolve(dev)] + check_pairhmm(dev)
    check_against_native(dev, args.seed)
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".smoke_") as wd:
        rem_launches, rem_gfa, t_rem = run_rem(args.seed, args.length, wd)
        dp_launches = run_refine(args.seed, wd)
        run_rem_then_refine(rem_gfa, wd, t_rem)
    rows[0]["launches"] = rem_launches
    rows[1]["launches"] = dp_launches["fwd"]
    rows[2]["launches"] = dp_launches["bwd"]
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
