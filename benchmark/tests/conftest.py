"""Shared fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests``).  ``tiny_root`` is a copy of ``BENCHMARK.json`` whose
configurations are cut to a size a CPU run holds in seconds; the tests
that need a card carry the ``cuda`` marker and skip without one."""

import json
import os
import shutil

import pytest

# the port's torch ops on the CPU, one thread a test process: the tests
# run side by side, and oversubscribed worker threads spin
os.environ.setdefault("OMP_NUM_THREADS", "1")

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_BP = {2: 30_000, 6: 6_000}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips on a machine "
        "without one)")


@pytest.fixture
def tiny_root(tmp_path):
    """A root holding BENCHMARK.json with every configuration cut to a
    tiny genome (the configuration files copied beside it)."""
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        cfg["genome_bp"] = TINY_BP[cfg["genomes"]]
        c["file"] = "tiny_%s.json" % c["name"]
        json.dump(cfg, open(tmp_path / c["file"], "w"))
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    return str(tmp_path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.cuda.get_device_name(0)


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's folder, nothing else."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path
