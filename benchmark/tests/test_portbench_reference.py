"""The plain reference against the port on the CPU: the GFA bytes that
``rem`` writes with ``--device cpu`` at small sizes of each route (the
forest, the per-level frontier on contigs, the multi loop), and the
reference's independence from the program."""

import gzip
import os
import subprocess
import sys

import pytest

from conftest import ROOT

sys.path.insert(0, ROOT)

from benchmark import genomes  # noqa: E402
from benchmark.reference import engine  # noqa: E402

CASES = {
    "pair_200k": ({"genomes": 2, "genome_bp": 200_000}, [1.0]),
    "pair_200k_contigs": ({"genomes": 2, "genome_bp": 200_000},
                          [0.95, 0.04, 0.01]),
    "panel_6x30k": ({"genomes": 6, "genome_bp": 30_000}, [1.0]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_writes_the_ports_gfa(case, tmp_path):
    from reveal_tpu_torch import cli
    from reveal_tpu_torch.index import devfrontier, devloop, devloop_multi

    size, fractions = CASES[case]
    config = dict(size, subrate=0.01, indelrate=0.001)
    fastas, _bases = genomes.write_inputs(
        config, {"contig_fractions": fractions}, 7, str(tmp_path))
    prefix = str(tmp_path / "job")
    assert cli.main(["rem", "-o", prefix, "--device", "cpu", *fastas]) == 0
    with gzip.open(prefix + ".gfa.gz", "rb") as fh:
        port = fh.read()
    # the route the case stands for
    if size["genomes"] > 2:
        assert devloop_multi.LAST_STATS.get("fallback") is None
    elif len(fractions) > 1:
        assert devfrontier.LAST_STATS.get("levels", 0) > 0
    else:
        assert devloop.LAST_STATS.get("fallback") is None
        assert "forest_seconds" in devloop.LAST_STATS
    want = engine.rem_gfa(fastas, str(tmp_path / "ref.gfa"))
    assert port == want


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.engine; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('reveal_tpu_torch', 'reveal_tpu', 'jax', 'torch')]; "
            "print(bad); sys.exit(1 if bad else 0)" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_reference_gfa_spells_the_inputs(tmp_path):
    config = {"genomes": 3, "genome_bp": 5_000, "subrate": 0.01,
              "indelrate": 0.001}
    fastas, _ = genomes.write_inputs(config, {"contig_fractions": [0.6, 0.4]},
                                     3, str(tmp_path))
    gfa = engine.rem_gfa(fastas, str(tmp_path / "ref.gfa")).decode()
    seqs = {}
    paths = {}
    for line in gfa.splitlines():
        f = line.split("\t")
        if f[0] == "S":
            seqs[f[1]] = f[2]
        elif f[0] == "P":
            paths[f[1]] = "".join(seqs[n[:-1]] for n in f[2].split(","))
    want = {}
    for path in fastas:
        name = None
        for line in open(path):
            if line.startswith(">"):
                name = line[1:].strip()
                want[name] = ""
            else:
                want[name] += line.strip()
    assert {k: v.upper() for k, v in paths.items()} == want
    assert os.path.exists(tmp_path / "ref.gfa")
