"""The harness on the CPU: cells, configurations and metrics found by
name, a new cell added as files only, the generator, the result's line,
and the refusals (no card, no program, JAX loaded)."""

import ast
import hashlib
import json
import os
import re
import subprocess
import sys

import pytest

from conftest import ROOT

sys.path.insert(0, ROOT)

from benchmark import cells, commands, genomes, harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "checks"}


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in BENCH[group]]
        assert len(seen) == len(set(seen))
        assert all(NAME.match(n) for n in seen)
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(CELLS)
    for cell in CELLS:
        c = cells.Cell(cell, ROOT)
        assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = cells.Cell(cell, ROOT)
    assert c.config["genomes"] in (2, 6)
    assert "contig_fractions" in c.traffic
    command = commands.load(c.traffic["command"])
    assert command.OUTPUT and callable(command.reference)
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.load_reader(m["name"]).read)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.Cell("no_such.cell", ROOT)


def _digest(folder):
    out = {}
    for dirpath, _dirs, files in os.walk(folder):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, folder)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_cell_is_only_new_files(bench_copy):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new entries are found; no file already there changes."""
    here = str(bench_copy / "benchmark")
    before = _digest(here)
    with open(os.path.join(here, "configs", "trio_x.json"), "w") as fh:
        json.dump({"genomes": 3, "genome_bp": 5000, "subrate": 0.01,
                   "indelrate": 0.001}, fh)
    with open(os.path.join(here, "traffic", "halves.json"), "w") as fh:
        json.dump({"command": "rem", "contig_fractions": [0.5, 0.5],
                   "args": []}, fh)
    with open(os.path.join(here, "metrics", "jobs_done.py"), "w") as fh:
        fh.write("def read(run):\n    return len(run.jobs) or None\n")
    bench = json.load(open(bench_copy / "BENCHMARK.json"))
    bench["configs"].append({"name": "trio_x", "source": "a test",
                             "file": "benchmark/configs/trio_x.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "trio_x.halves", "config": "trio_x",
                               "traffic": "halves", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "jobs_done", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "cli", "moves": "mbp_per_s",
                               "workloads": ["trio_x.halves"]})
    json.dump(bench, open(bench_copy / "BENCHMARK.json", "w"))
    c = cells.Cell("trio_x.halves", str(bench_copy), here=here)
    assert c.config["genomes"] == 3
    assert c.traffic["contig_fractions"] == [0.5, 0.5]
    assert [m["name"] for m in c.per_layer] == ["jobs_done"]
    reader = cells.load_reader("jobs_done", here)

    class Fake:
        jobs = [{}, {}]
    assert reader.read(Fake()) == 2
    after = _digest(here)
    assert {k: v for k, v in after.items() if k in before} == before


def test_generator_deterministic(tmp_path):
    cfg = {"genomes": 3, "genome_bp": 4000, "subrate": 0.01,
           "indelrate": 0.001}
    traffic = {"contig_fractions": [0.95, 0.04, 0.01]}
    files = {}
    for tag, seed in (("a", 2**33 + 5), ("b", 2**33 + 5), ("c", 7)):
        d = tmp_path / tag
        d.mkdir()
        paths, bases = genomes.write_inputs(cfg, traffic, seed, str(d))
        files[tag] = ([open(p).read() for p in paths], bases)
    assert files["a"] == files["b"]
    assert files["a"][0] != files["c"][0]
    text = files["a"][0][0]
    assert text.count(">") == 3 and ">anc_1\n" in text
    assert abs(files["a"][1] - 3 * 4000) < 400


def test_pool_inputs_differ_in_bases_not_sizes(tmp_path):
    cfg = {"genomes": 2, "genome_bp": 3000, "subrate": 0.01,
           "indelrate": 0.001}
    seqs, sizes = [], set()
    for i in range(4):
        d = tmp_path / str(i)
        d.mkdir()
        paths, bases = genomes.write_inputs(cfg, {}, 11, str(d), index=i)
        seqs.append(open(paths[1]).read())
        sizes.add(bases)
    assert len(set(seqs)) == 4 and len(sizes) == 1  # same sizes, new bases


@pytest.mark.parametrize("cell", CELLS)
def test_the_configuration_defines_the_run(cell):
    """Both sides get the configuration's options: the CLI as its flags,
    the reference as keywords; an option rem does not have is refused."""
    c = cells.Cell(cell, ROOT)
    command = commands.load(c.traffic["command"])
    options = c.config["options"]
    argv = command.argv(["a.fa", "b.fa"], "p", options)
    assert argv[:3] == ["rem", "-o", "p"] and argv[-2:] == ["a.fa", "b.fa"]
    assert argv[argv.index("--maxmums") + 1] == str(options["maxmums"])
    assert "--notrim" not in argv and options["trim"] is True
    assert "--notrim" in command.argv([], "p", dict(options, trim=False))
    from benchmark.reference.picker import PickerConfig

    PickerConfig(**options)  # every option is one of the reference's
    with pytest.raises(KeyError):
        command.argv([], "p", dict(options, no_such_option=1))


def test_contig_bounds():
    assert genomes.contig_bounds(1000, [0.95, 0.04, 0.01]) == [0, 950, 990,
                                                                1000]
    assert genomes.contig_bounds(7, [1.0]) == [0, 7]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(tiny_root, trace):
    cell = cells.Cell("pair_2a2b.forest", tiny_root)
    res = harness.run_cell(cell, 3, 0.5, trace, device="cpu",
                           log=lambda *_: None)
    want = RESULT_KEYS | ({"breakdown"} if trace else set())
    assert set(res) == want
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 2
    names = {m["name"] for m in cell.metrics(trace)}
    assert set(res["metrics"]) <= names
    if trace:
        assert {"io_s", "esa_s", "forest_s", "host_prefix_s",
                "device.idle_pct"} <= set(res["metrics"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    else:
        assert set(res["metrics"]) == {"mbp_per_s", "setup_s"}
    assert all(v["value"] > 0 for k, v in res["metrics"].items()
               if k != "device.idle_pct")


def test_no_card_gives_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would run")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "pair_2a2b.forest", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "no result" in out.stderr


def test_without_the_program_gives_no_result(bench_copy):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "pair_2a2b.forest", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=str(bench_copy), capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "reveal_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "reveal_tpu.cli", sys)
    assert harness.forbidden_modules() == ["jax.numpy", "reveal_tpu.cli"]


def test_no_module_imports_jax_or_the_jax_package():
    """Every module under benchmark/ by its import statements, top-level
    names compared whole; the reference imports nothing of the program."""
    here = os.path.join(ROOT, "benchmark")
    for dirpath, _dirs, files in os.walk(here):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read())
            tops = set()
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops |= {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    tops.add(node.module.split(".")[0])
            assert not tops & set(harness.FORBIDDEN), path
            if os.sep + "reference" + os.sep in path:
                assert tops <= {"__future__", "bisect", "collections",
                                "dataclasses",
                                "gzip", "logging", "math", "numpy", "os",
                                "random", "sortedcontainers", "typing",
                                "uuid"}, (path, tops)


@pytest.mark.cuda
def test_one_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "panel_1a1f.multi", "--seed", "12", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["kind"] == card


def test_window_resolve_bytes_count_live_rows_once():
    """Padding rows (at the queue's pad slot npad - 1) and the overlap of
    two windows are not counted."""
    reader = cells.load_reader("window_resolve_roofline")
    npad, wrv = 1 << 12, 256
    q = [1000, 1100, 3000] + [npad - 1] * 1021
    words = 256 + 100 + 256
    assert reader.launch_bytes(q, wrv, npad) == 4 * words + 12 * 3
    assert reader.launch_bytes([10, npad - 1], wrv, npad) == 4 * 10 + 12


def test_repair_bytes_count_distinct_moved_slots():
    """A slot that two movers of one pass move counts once; a candidate's
    own words count 16 bytes."""
    import torch

    reader = cells.load_reader("repair_pass_roofline")
    SA = torch.arange(12, dtype=torch.int32)
    notes = {}
    after = reader._note((SA,), {}, notes)
    # two movers: slots [2, 5] rotated right, then [4, 7] (4 and 5 twice)
    SA[2:6] = SA[2:6].roll(1)
    SA[4:8] = SA[4:8].roll(1)
    after((SA, None, None, 1))
    assert int(notes["repair_moved"][0]) == 6

    class FakeRun:
        device_kind = "NVIDIA H100 80GB HBM3"
        trace = {"kernels": {"repair_pass_kernel": (1e-6, 1)},
                 "notes": notes,
                 "job": {"stats": {"devloop": {"repair_applied": 2}}}}
    want = 100.0 * (24 * 6 + 16 * 2) / 3.35e12 / 1e-6
    assert reader.read(FakeRun()) == pytest.approx(want)


def test_idle_time_by_span():
    """Busy time is the union of the device's intervals; idle time goes to
    the innermost span that held it."""
    import numpy as np

    from benchmark import devtrace

    us, ue = devtrace.union_intervals(np.array([10, 15, 40]),
                                      np.array([20, 18, 50]))
    assert us.tolist() == [10, 40] and ue.tolist() == [20, 50]
    spans = [(0, 30, "io"), (30, 100, "forest"), (35, 60, "esa")]
    idle = devtrace.idle_by_span(spans, us, ue, 0, 100)
    assert {k: round(v * 1e9) for k, v in idle.items()} == {
        "io": 20, "forest": 45, "esa": 15}
