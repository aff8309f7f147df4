"""The torch port's ``refine`` slice end to end on the CPU.

The same graphs go through ``reveal_tpu.hmm.refine.refine_all`` and the
port's on ``device="cpu"`` (the DP's plain versions), each followed by the
steps of its package's ``refine_cmd`` (prune, contract, write).  The JAX
package is pinned to the route the port implements, its two-phase route
with stage 1 through ``batch_posteriors_cut``: the native host pair-HMM
and the native whole-MSA batch are switched off.  The written GFAs must
be byte-identical.
"""

import os

import pytest
import torch

from reveal_tpu_torch import cli as port_cli
from reveal_tpu_torch.core.io_gfa import read_gfa as port_read_gfa
from reveal_tpu_torch.graph.extract import extract as port_extract
from reveal_tpu_torch.hmm import refine as port_refine
from torch_support import (cli_args, jax_refined, pin_jax_two_phase,
                           refine_graphs)


@pytest.fixture
def jax_two_phase(monkeypatch):
    pin_jax_two_phase(monkeypatch)


@pytest.mark.parametrize("name",
                         ["region", "no_bubble", "region_nproc", "chain"])
def test_refined_gfa_matches_jax_package(tmp_path, jax_two_phase, name):
    gfa, kw, want = refine_graphs(tmp_path)[name]
    # the CLI's defaults where refine_all's differ (consgap)
    kw = dict(kw, consgap=False)
    ref = jax_refined(str(gfa), str(tmp_path / "jax.gfa"), **kw)
    out = str(tmp_path / "port.gfa")
    cli_kw = {k: v for k, v in kw.items() if k != "consgap"}
    port_cli.main(["refine", str(gfa), "--all", "--device", "cpu",
                   "-o", out, *cli_args(cli_kw)])
    with open(out, "rb") as fh:
        got = fh.read()
    assert got == ref
    if want is not None:
        st = port_refine.LAST_STATS
        assert st["bubbles"] == 4 and st["pairs"] == 60
        assert st["refined"] == st["aligned_bubbles"] == 4
        G = port_read_gfa(out)
        for path, seq in want.items():
            assert port_extract(G, path).upper() == seq


def test_refine_all_default_consgap_matches(tmp_path, jax_two_phase):
    """refine_all's own defaults (consgap on), called as a library."""
    gfa, kw, _ = refine_graphs(tmp_path)["chain"]
    ref = jax_refined(str(gfa), str(tmp_path / "jax.gfa"), **kw)
    G = port_refine.refine_all(port_read_gfa(str(gfa)), device="cpu", **kw)
    # the port's copies of prune/contract/write
    from reveal_tpu_torch.align.graphops import prune_nodes
    from reveal_tpu_torch.core.io_gfa import write_gfa
    from reveal_tpu_torch.graph.simplify import contract

    prune_nodes(G)
    contract(G, [n for n in G.topological_sort() if not isinstance(n, str)])
    out = write_gfa(G, None, outputfile=str(tmp_path / "port.gfa"))
    with open(out, "rb") as fh:
        assert fh.read() == ref


def test_native_stage1_route_refines_the_same_bubbles(tmp_path):
    """The native float64 stage-1 route (the reference chip_smoke.py
    holds the card against) runs the same bubbles and keeps every path."""
    gfa, kw, want = refine_graphs(tmp_path)["chain"]
    G = port_refine.refine_all(port_read_gfa(str(gfa)), device="cpu", **kw)
    dev = dict(port_refine.LAST_STATS)
    G = port_refine.refine_all(port_read_gfa(str(gfa)), stage1="native",
                               **kw)
    nat = dict(port_refine.LAST_STATS)
    assert nat["stage1"] == "native" and dev["stage1"] == "device"
    assert len(nat["digests"]) == len(dev["digests"]) == 4
    assert nat["cells"] == dev["cells"]
    for path, seq in want.items():
        assert port_extract(G, path).upper() == seq
    with pytest.raises(ValueError):
        port_refine.refine_all(port_read_gfa(str(gfa)), stage1="other",
                               **kw)


def test_uncovered_refine_options_raise(tmp_path, monkeypatch):
    """The options that raised before the port covered them now run on
    the CPU and give the JAX package's bytes (the name is from when they
    raised): ``--method muscle`` with a muscle on ``$PATH`` that fails
    (the bubble stays as it was), ``--method reveal_rem`` and
    ``--logadd-compat``; a refine without --all, --simple or --complex
    still exits."""
    import reveal_tpu.hmm.msa as jax_msa
    from reveal_tpu_torch.hmm import msa as port_msa

    gfa, kw, _ = refine_graphs(tmp_path)["region"]
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "muscle").write_text("#!/bin/sh\nexit 1\n")
    (bindir / "muscle").chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep + os.environ["PATH"])
    monkeypatch.chdir(tmp_path)
    for extra in (dict(method="muscle"), dict(method="reveal_rem"),
                  dict(logadd_compat=True)):
        compat = extra.pop("logadd_compat", False)
        jax_msa.set_logadd_compat(compat)
        try:
            ref = jax_refined(str(gfa), str(tmp_path / "jax.gfa"),
                              **dict(kw, consgap=False, **extra))
            out = str(tmp_path / "port.gfa")
            port_cli.main(["refine", str(gfa), "--all", "--device", "cpu",
                           "-o", out, *cli_args(kw), *cli_args(extra)]
                          + (["--logadd-compat"] if compat else []))
        finally:
            jax_msa.set_logadd_compat(False)
            port_msa.set_logadd_compat(False)
        with open(out, "rb") as fh:
            assert fh.read() == ref, extra
        st = port_refine.LAST_STATS
        assert st["method"] == extra.get("method", "reveal_probcons")
        assert st["compat"] == compat
        assert st["refined"] == (0 if extra.get("method") == "muscle" else 1)
    with pytest.raises(SystemExit):
        port_cli.main(["refine", str(gfa), "--device", "cpu"])


def test_refine_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """The default device is the card; without one the run raises
    instead of using the CPU."""
    gfa, kw, _ = refine_graphs(tmp_path)["region"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_refine.refine_all(port_read_gfa(str(gfa)), **kw)
