"""The torch port's ``refine`` slice end to end on the CPU.

The same graphs go through ``reveal_tpu.hmm.refine.refine_all`` and the
port's on ``device="cpu"`` (the DP's plain versions), each followed by the
steps of its package's ``refine_cmd`` (prune, contract, write).  The JAX
package is pinned to the route the port implements, its two-phase route
with stage 1 through ``batch_posteriors_cut``: the native host pair-HMM
and the native whole-MSA batch are switched off.  The written GFAs must
be byte-identical.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import reveal_tpu.hmm.msa as jax_msa
from reveal_tpu.align.graphops import prune_nodes as jax_prune_nodes
from reveal_tpu.core.io_gfa import read_gfa as jax_read_gfa
from reveal_tpu.core.io_gfa import write_gfa as jax_write_gfa
from reveal_tpu.graph.simplify import contract as jax_contract
from reveal_tpu.hmm.refine import refine_all as jax_refine_all
from reveal_tpu_torch import cli as port_cli
from reveal_tpu_torch.core.io_gfa import read_gfa as port_read_gfa
from reveal_tpu_torch.graph.extract import extract as port_extract
from reveal_tpu_torch.hmm import refine as port_refine

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]

GFA_REGION = """H\tVN:Z:1.0
S\t1\tAAAACC
S\t2\tGGTACGTAGGA
S\t3\tGGTACCTAGG
S\t4\tTTTTGG
L\t1\t+\t2\t+\t0M
L\t1\t+\t3\t+\t0M
L\t2\t+\t4\t+\t0M
L\t3\t+\t4\t+\t0M
P\tx\t1+,2+,4+\t0M
P\ty\t1+,3+,4+\t0M
"""

GFA_NO_BUBBLE = """H\tVN:Z:1.0
S\t1\tAAAA
S\t2\tCCCC
L\t1\t+\t2\t+\t0M
P\tx\t1+,2+\t0M
P\ty\t1+,2+\t0M
"""


def _smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_two_phase(monkeypatch):
    """Pin the JAX package to stage 1 through batch_posteriors_cut."""
    monkeypatch.setattr(jax_msa, "NATIVE_POST_MAX_CELLS", 0)
    monkeypatch.setenv("REVEAL_TPU_NATIVE_MSA", "0")


def _jax_refined(gfa, out, **kw):
    G = jax_refine_all(jax_read_gfa(gfa), **kw)
    jax_prune_nodes(G)
    order = [n for n in G.topological_sort() if not isinstance(n, str)]
    jax_contract(G, order)
    jax_write_gfa(G, None, outputfile=out)
    with open(out, "rb") as fh:
        return fh.read()


def _cli_args(kw):
    args = []
    for k, v in kw.items():
        flag = {"minlength": "-m"}.get(k, "--" + k)
        if v is True:
            args.append(flag)
        elif v is not False:
            args += [flag, str(v)]
    return args


def _graphs(tmp_path):
    """The three graphs of tests/test_refine.py (region bubble, no
    bubble, the region bubble through --nproc) and a numpy-seeded
    six-path bubble chain."""
    region = tmp_path / "region.gfa"
    region.write_text(GFA_REGION)
    nobub = tmp_path / "nobubble.gfa"
    nobub.write_text(GFA_NO_BUBBLE)
    chain = tmp_path / "chain.gfa"
    want = _smoke_module().write_bubble_chain(
        str(chain), seed=4, n_small=3, small=45, n_big=1, big=110)
    return {
        "region": (region, dict(minlength=1, minsize=1, nrefinements=5),
                   None),
        "no_bubble": (nobub, dict(minlength=1), None),
        "region_nproc": (region, dict(minlength=1, minsize=1,
                                      nrefinements=5, nproc=4), None),
        "chain": (chain, dict(minsize=2, maxsize=10000, nrefinements=20),
                  want),
    }


@pytest.mark.parametrize("name",
                         ["region", "no_bubble", "region_nproc", "chain"])
def test_refined_gfa_matches_jax_package(tmp_path, jax_two_phase, name):
    gfa, kw, want = _graphs(tmp_path)[name]
    # the CLI's defaults where refine_all's differ (consgap)
    kw = dict(kw, consgap=False)
    ref = _jax_refined(str(gfa), str(tmp_path / "jax.gfa"), **kw)
    out = str(tmp_path / "port.gfa")
    cli_kw = {k: v for k, v in kw.items() if k != "consgap"}
    port_cli.main(["refine", str(gfa), "--all", "--device", "cpu",
                   "-o", out, *_cli_args(cli_kw)])
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
    gfa, kw, _ = _graphs(tmp_path)["chain"]
    ref = _jax_refined(str(gfa), str(tmp_path / "jax.gfa"), **kw)
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
    gfa, kw, want = _graphs(tmp_path)["chain"]
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


def test_refine_cli_subprocess_matches_jax_package(tmp_path, jax_two_phase):
    gfa, kw, _ = _graphs(tmp_path)["chain"]
    kw = dict(kw, consgap=False)
    ref = _jax_refined(str(gfa), str(tmp_path / "jax.gfa"), **kw)
    out = str(tmp_path / "port.gfa")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    cli_kw = {k: v for k, v in kw.items() if k != "consgap"}
    proc = subprocess.run(
        [sys.executable, "-m", "reveal_tpu_torch.cli", "realign", str(gfa),
         "--all", "--device", "cpu", "-o", out, *_cli_args(cli_kw)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as fh:
        assert fh.read() == ref


def test_uncovered_refine_options_raise(tmp_path, monkeypatch):
    """The options that raised before the port covered them now run on
    the CPU and give the JAX package's bytes (the name is from when they
    raised): ``--method muscle`` with a muscle on ``$PATH`` that fails
    (the bubble stays as it was), ``--method reveal_rem`` and
    ``--logadd-compat``; a refine without --all, --simple or --complex
    still exits."""
    import reveal_tpu.hmm.msa as jax_msa
    from reveal_tpu_torch.hmm import msa as port_msa

    gfa, kw, _ = _graphs(tmp_path)["region"]
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
            ref = _jax_refined(str(gfa), str(tmp_path / "jax.gfa"),
                               **dict(kw, consgap=False, **extra))
            out = str(tmp_path / "port.gfa")
            port_cli.main(["refine", str(gfa), "--all", "--device", "cpu",
                           "-o", out, *_cli_args(kw), *_cli_args(extra)]
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
    gfa, kw, _ = _graphs(tmp_path)["region"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_refine.refine_all(port_read_gfa(str(gfa)), **kw)
