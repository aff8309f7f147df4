"""The port's stage spans and timed reads (``core/trace.py``) on the CPU.

A pairwise ``rem`` (host prefix and device forest) and a 6-genome
``rem`` (the multi loop) at small sizes, each run through the CLI with
tracing off and then on: every stage of the route is recorded, the
spans cover the loop and the command, the counted reads agree with the
loops' own counts, and tracing changes neither the GFA nor, off,
anything at all.
"""

import gzip
import os
import time

import pytest
import torch

from reveal_tpu_torch import cli
from reveal_tpu_torch.core import trace
from reveal_tpu_torch.index import devfrontier, devloop, devloop_multi
from reveal_tpu_torch.utils.simulate import simulate_population
import torch_support  # noqa: F401  (the thread budget)

REM = ("rem.read", "rem.esa", "rem.replay", "rem.finish", "rem.write")
ROUTES = {
    "pair": REM + ("rem.host_prefix", "rem.forest", "level.enumerate",
                   "level.trim", "level.chain", "level.split",
                   "level.repair"),
    "six": REM + ("rem.multi_root", "rem.multi_loop", "multi.enumerate",
                  "multi.trim", "multi.chain", "multi.split", "multi.repair"),
}
SIZES = {"pair": (2, 30_000), "six": (6, 6_000)}
MULTI = ("multi.enumerate", "multi.trim", "multi.chain", "multi.split",
         "multi.repair")
FRONTIER = ("frontier.enumerate", "frontier.pick", "frontier.apply",
            "frontier.repair", "frontier.order")


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off."""
    trace.enable(False)
    yield
    trace.enable(False)


def _fastas(d, n, length, seed=3):
    out = []
    for name, seq, _ids in simulate_population(n, length, seed=seed):
        fn = os.path.join(d, "%s.fa" % name)
        with open(fn, "w") as fh:
            fh.write(">%s\n%s\n" % (name, seq))
        out.append(fn)
    return out


def _rem(fastas, out, *extra):
    """One ``rem`` through the CLI: (its seconds, the GFA's text)."""
    t0 = time.perf_counter()
    assert cli.main(["rem", *fastas, "--device", "cpu", "-o", out,
                     *extra]) == 0
    wall = time.perf_counter() - t0
    with gzip.open(out, "rb") if out.endswith(".gz") else open(
            out, "rb") as fh:
        return wall, fh.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per input: the record and seconds of a traced command, the GFA
    with tracing off and on, and the loops' own counters."""
    out = {}
    for case, (n, length) in SIZES.items():
        d = str(tmp_path_factory.mktemp(case))
        fastas = _fastas(d, n, length)
        trace.enable(False)
        _wall, off = _rem(fastas, os.path.join(d, "off.gfa"))
        assert trace.LAST_STATS == {}
        trace.enable(True)
        try:
            wall, on = _rem(fastas, os.path.join(d, "on.gfa"))
        finally:
            trace.enable(False)
        out[case] = dict(fastas=fastas, rec=dict(trace.LAST_STATS),
                         wall=wall, off=off, on=on,
                         devloop=dict(devloop.LAST_STATS),
                         multi=dict(devloop_multi.LAST_STATS))
    return out


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_records_every_stage(runs, case):
    rec = runs[case]["rec"]
    for label in ROUTES[case]:
        assert label in trace.LABELS
        assert rec[label + ".calls"] >= 1, label
        assert 0 <= rec[label + ".self"] <= rec[label] + 1e-9, label
    assert not [k for k in rec if k.startswith("frontier.")]
    levels = runs[case]["multi" if case == "six" else "devloop"]["levels"]
    stage = "multi.chain" if case == "six" else "level.chain"
    assert rec[stage + ".calls"] == levels


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_rem_spans_cover_the_command(runs, case):
    rec = runs[case]["rec"]
    top = sum(rec[k] for k in trace.LABELS if k.startswith("rem.")
              and k in rec)
    assert 0.95 * runs[case]["wall"] <= top <= runs[case]["wall"]


def test_multi_spans_cover_the_loop(runs):
    rec, st = runs["six"]["rec"], runs["six"]["multi"]
    assert st["fallback"] is None
    stages = sum(rec[k] for k in MULTI)
    assert 0.9 * st["loop_seconds"] <= stages <= st["loop_seconds"]
    assert stages <= rec["rem.multi_loop"]


def test_counted_reads_match_the_loops_counts(runs):
    """The multi loop's reads (all of the job's timed reads) and the
    forest's (all but the CPU's batched repair rounds, which count
    apart) are the loops' always-on ``host_syncs``."""
    rec, st = runs["six"]["rec"], runs["six"]["multi"]
    assert rec["reads"] == st["host_syncs"] > 0
    assert rec["reads"] == sum(rec[k + ".reads"] for k in trace.LABELS
                               if k in rec)
    assert rec["wait"] >= sum(rec[k + ".wait"] for k in MULTI)
    pair, fst = runs["pair"]["rec"], runs["pair"]["devloop"]
    assert fst["fallback"] is None and "forest_seconds" in fst
    assert pair["reads"] - pair["level.repair.reads"] == fst["host_syncs"]
    assert fst["host_syncs"] >= fst["levels"]


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_tracing_leaves_the_gfa_as_it_is(runs, case):
    assert runs[case]["on"] == runs[case]["off"]
    assert len(runs[case]["on"]) > 1000


def test_a_command_starts_a_fresh_record(runs, tmp_path):
    trace.enable(True)
    _rem(runs["pair"]["fastas"], str(tmp_path / "a.gfa"))
    first = dict(trace.LAST_STATS)
    _rem(runs["six"]["fastas"], str(tmp_path / "b.gfa"))
    second = dict(trace.LAST_STATS)
    assert second["job"] == first["job"] + 1
    assert "level.chain" in first and "level.chain" not in second
    assert "multi.chain" in second
    trace.enable(False)
    _rem(runs["pair"]["fastas"], str(tmp_path / "c.gfa"))
    assert trace.LAST_STATS == {}


def _profiled_names(fastas, out):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _rem(fastas, out)
    return {evt.name() for evt in prof.profiler.kineto_results.events()}


def test_profiler_ranges_only_while_tracing(tmp_path):
    fastas = _fastas(str(tmp_path), 2, 8_000, seed=5)
    names = _profiled_names(fastas, str(tmp_path / "off.gfa"))
    assert not names & set(trace.LABELS)
    trace.enable(True)
    names = _profiled_names(fastas, str(tmp_path / "on.gfa"))
    assert set(ROUTES["pair"]) <= names


def test_frontier_stage_clocks_are_its_spans(tmp_path):
    """``--notrim`` takes the per-level frontier: its stage seconds in
    ``devfrontier.LAST_STATS`` are the clocks of its spans, with tracing
    on and off."""
    fastas = _fastas(str(tmp_path), 2, 6_000, seed=6)
    _rem(fastas, str(tmp_path / "off.gfa"), "--notrim")
    st = devfrontier.LAST_STATS
    keys = ("enumerate", "pick", "apply", "repair")
    assert all(st[k + "_seconds"] > 0 for k in keys[:3])
    trace.enable(True)
    _rem(fastas, str(tmp_path / "on.gfa"), "--notrim")
    rec = trace.LAST_STATS
    for k in keys:
        assert rec.get("frontier." + k, 0.0) == st[k + "_seconds"], k
    assert rec["frontier.enumerate.reads"] >= 1
    assert rec["rem.frontier"] >= sum(st[k + "_seconds"] for k in keys)


def test_declined_panel_spans_cover_the_frontier(tmp_path):
    """Six genomes whose root holds more than ``--maxmums`` candidates:
    the multi loop's root count (``rem.multi_root``) and its attempt are
    recorded before it declines, and the frontier's five stage spans, its
    snapshot and replay in the serial order (``frontier.order``) among
    them, cover 97-100.5% of ``rem.frontier``, each stage's clock also
    its ``devfrontier.LAST_STATS`` seconds."""
    fastas = _fastas(str(tmp_path), 6, 6_000, seed=4)
    trace.enable(True)
    _rem(fastas, str(tmp_path / "on.gfa"), "--maxmums", "30")
    rec, st = trace.LAST_STATS, devfrontier.LAST_STATS
    assert "ABORT_MAXMUMS" in st["fallback"]
    assert rec["rem.multi_root.calls"] == rec["rem.multi_loop.calls"] == 1
    assert rec["frontier.order.calls"] == 2
    assert st["order_seconds"] == rec["frontier.order"] > 0
    for label in FRONTIER:
        assert label in trace.LABELS
        assert rec[label] == st[label.split(".")[1] + "_seconds"], label
    stages = sum(rec[k] for k in FRONTIER)
    assert 0.97 * rec["rem.frontier"] <= stages
    assert stages <= 1.005 * rec["rem.frontier"]


def test_spans_nest_and_bill_reads_to_the_innermost():
    trace.enable(True)
    trace.begin()
    stats = {}
    with trace.span("rem.forest"):
        trace.read(lambda: time.sleep(0.002))
        with trace.span("level.chain", stats, "chain_seconds"):
            time.sleep(0.01)
            assert trace.read(torch.arange(3).tolist) == [0, 1, 2]
        with trace.span("level.chain"):
            pass
    rec = trace.LAST_STATS
    assert rec["level.chain.calls"] == 2 and rec["rem.forest.calls"] == 1
    assert rec["level.chain"] == pytest.approx(rec["level.chain.self"])
    assert rec["rem.forest.self"] == pytest.approx(
        rec["rem.forest"] - rec["level.chain"])
    assert stats["chain_seconds"] <= rec["level.chain"]
    assert rec["level.chain.reads"] == 1 and rec["rem.forest.reads"] == 1
    assert rec["reads"] == 2
    assert rec["rem.forest.wait"] >= 0.002
    assert rec["wait"] == pytest.approx(rec["rem.forest.wait"]
                                        + rec["level.chain.wait"])


def test_tracing_off_is_one_shared_no_op():
    trace.begin()
    assert trace.span("rem.esa") is trace.span("multi.chain")
    with trace.span("rem.esa"):
        trace.read(int, 3)
    stats = {}
    with trace.span("frontier.pick", stats, "pick_seconds"):
        time.sleep(0.001)
    assert stats["pick_seconds"] >= 0.001
    assert trace.LAST_STATS == {}
