"""The cell ``panel_1a1f_fixture.frontier``: its seven readers on a
synthetic run, the plain reference against the port's default route on
six genomes that the multi loop declines at the root, and the cell
loading by name."""

import gzip
import json
import os
import sys

import pytest

from conftest import ROOT

sys.path.insert(0, ROOT)

from benchmark import cells, genomes, harness  # noqa: E402
from benchmark.reference import engine  # noqa: E402

CELL = "panel_1a1f_fixture.frontier"
READERS = ("frontier_s", "frontier_enumerate_s", "frontier_pick_s",
           "frontier_apply_s", "frontier_order_s", "frontier_host_syncs",
           "multi_decline_s")
DECLINED = "frontier (declined: kernel abort code 7 (ABORT_MAXMUMS))"


def _job(route, trace=None, frontier=None):
    stats = {"devfrontier": frontier or {}}
    if trace is not None:
        stats["trace"] = trace
    return {"route": route, "stats": stats, "spans": {}}


def _frontier_job(k, order=True):
    rec = {"job": k, "reads": 0, "wait": 0.0, "rem.multi_root": 0.1 * k,
           "rem.multi_loop": 0.2 * k, "rem.frontier": 10.0 * k,
           "frontier.enumerate": 1.0 * k, "frontier.pick": 5.0 * k,
           "frontier.apply": 2.0 * k, "frontier.repair": 0.5 * k}
    if order:
        rec["frontier.order"] = 1.5 * k
    else:
        del rec["rem.multi_root"]
    return _job(DECLINED, rec, {"seconds": 10.0 * k, "host_syncs": 100 * k})


def test_readers_count_frontier_jobs_only():
    run = harness.Run("cpu")
    run.jobs = [
        _frontier_job(1), _frontier_job(3),
        # a multi-loop job and a forest job: not the frontier's
        _job("multi", {"job": 5, "rem.multi_root": 9.0,
                       "rem.multi_loop": 9.0, "frontier.pick": 9.0},
             {"seconds": 99.0, "host_syncs": 999}),
        _job("forest", {"job": 6}, {"seconds": 99.0}),
    ]
    want = {"frontier_s": 20.0, "frontier_enumerate_s": 2.0,
            "frontier_pick_s": 10.0, "frontier_apply_s": 5.0,
            "frontier_order_s": 3.0, "frontier_host_syncs": 200.0,
            "multi_decline_s": 0.6}
    assert set(want) == set(READERS)
    for name, value in want.items():
        assert cells.load_reader(name).read(run) == pytest.approx(value), name


def test_readers_on_a_program_without_the_new_spans():
    """A program from before the spans ``frontier.order`` and
    ``rem.multi_root``: those two readers give None, the others read."""
    run = harness.Run("cpu")
    run.jobs = [_frontier_job(1, order=False), _frontier_job(3, order=False)]
    for name in READERS:
        value = cells.load_reader(name).read(run)
        if name in ("frontier_order_s", "multi_decline_s"):
            assert value is None, name
        else:
            assert value is not None and value > 0, name


def test_readers_without_tracing_or_frontier_jobs():
    run = harness.Run("cpu")
    run.jobs = [_job(DECLINED, None, {"seconds": 4.0, "host_syncs": 7}),
                _job("multi", None, {"seconds": 9.0})]
    for name in READERS:
        value = cells.load_reader(name).read(run)
        if name == "frontier_s":
            assert value == 4.0
        elif name == "frontier_host_syncs":
            assert value == 7
        else:
            assert value is None, name
    run.jobs = [_job("multi", {"job": 1, "frontier.pick": 1.0})]
    for name in READERS:
        assert cells.load_reader(name).read(run) is None, name


def test_reference_writes_the_declined_panels_gfa(tmp_path):
    """Six genomes whose root holds more than ``--maxmums`` candidates
    (30 at this size, as 10,000 at 115 kbp): the port's default route is
    the per-level frontier, and its GFA is the reference's byte for
    byte."""
    from reveal_tpu_torch import cli
    from reveal_tpu_torch.index import devfrontier, devloop_multi

    config = {"genomes": 6, "genome_bp": 6_000, "subrate": 0.01,
              "indelrate": 0.001}
    fastas, _bases = genomes.write_inputs(
        config, {"contig_fractions": [1.0]}, 4800000303, str(tmp_path))
    prefix = str(tmp_path / "job")
    assert cli.main(["rem", "-o", prefix, "--maxmums", "30", "--device",
                     "cpu", *fastas]) == 0
    assert "ABORT_MAXMUMS" in devloop_multi.LAST_STATS["fallback"]
    assert devfrontier.LAST_STATS["levels"] > 1
    with gzip.open(prefix + ".gfa.gz", "rb") as fh:
        port = fh.read()
    want = engine.rem_gfa(fastas, str(tmp_path / "ref.gfa"), maxmums=30)
    assert port == want


def test_the_cell_loads_by_name():
    c = cells.Cell(CELL, ROOT)
    assert c.chips == 1 and c.entry["traffic"] == "whole"
    assert c.config["genomes"] == 6 and c.config["genome_bp"] == 115_000
    panel = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                        "panel_1a1f.json")))
    assert c.config["options"] == panel["options"]
    assert c.config["options"]["maxmums"] == 10_000
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    entry, = [x for x in bench["configs"] if x["name"] == c.entry["config"]]
    assert entry["reduced"] == []
    assert {m["name"] for m in c.per_layer} == set(READERS)
    assert {m["name"] for m in c.end_to_end} == {"mbp_per_s", "setup_s"}
    for name in READERS:
        assert callable(cells.load_reader(name).read)
