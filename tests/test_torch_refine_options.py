"""The port's ``refine`` options beyond the built-in MSA on the device.

``--logadd-compat`` (every posterior from the LOG_ADD table twin on the
host, never the chain), ``--method`` muscle, probcons, msaprobs and pecan
(an external aligner from ``$PATH``, here a stub script the test writes),
``--method reveal_rem`` (the serial host anchor aligner on each bubble's
alleles), ``--nproc`` (the per-bubble MSA in forked processes) and the
posterior self-check.  Each refined GFA is held byte for byte to the JAX
package's ``refine_all`` with the same options, or to the port's serial
run.
"""

import os
import stat
import sys

import pytest
import torch

import reveal_tpu.hmm.msa as jax_msa
from reveal_tpu_torch import cli as port_cli
from reveal_tpu_torch.hmm import msa as port_msa
from reveal_tpu_torch.hmm import refine as port_refine
from reveal_tpu_torch.hmm.selfcheck import check_posterior_oracle
from torch_support import cli_args, jax_refined, run_port, write_bubble_chain


def _bubbles(tmp_path, small, seed=3):
    """Three bubbles of three paths, alleles near ``small`` bp."""
    gfa = str(tmp_path / ("bubbles%d.gfa" % small))
    want = write_bubble_chain(
        gfa, seed=seed, n_small=3, small=small, n_big=0, npaths=3, flank=20)
    return gfa, want


def _both(tmp_path, gfa, kw):
    """(the JAX package's refined GFA, the port CLI's) with ``kw``."""
    ref = jax_refined(gfa, str(tmp_path / "jax.gfa"),
                      **dict(kw, consgap=False))
    out = str(tmp_path / "port.gfa")
    port_cli.main(["refine", gfa, "--all", "--device", "cpu", "-o", out,
                   *cli_args(kw)])
    with open(out, "rb") as fh:
        return ref, fh.read()


def _switched_off():
    jax_msa.set_logadd_compat(False)
    port_msa.set_logadd_compat(False)


def test_logadd_compat_matches_jax(tmp_path, monkeypatch):
    """``refine --logadd-compat`` on three small bubbles: the JAX
    package's bytes (its compat switch set alike), every bubble on the
    two-phase route with the table twin's posteriors."""
    gfa, _want = _bubbles(tmp_path, 25)
    jax_msa.set_logadd_compat(True)
    try:
        ref = jax_refined(gfa, str(tmp_path / "jax.gfa"), minsize=2,
                          nrefinements=5, consgap=False)
        out = str(tmp_path / "port.gfa")
        port_cli.main(["refine", gfa, "--all", "--device", "cpu", "-o", out,
                       "--minsize", "2", "--nrefinements", "5",
                       "--logadd-compat"])
    finally:
        _switched_off()
    st = port_refine.LAST_STATS
    assert st["compat"] and st["route"] == "two-phase"
    assert st["chain_bubbles"] == 0 and st["refined"] == 3
    with open(out, "rb") as fh:
        assert fh.read() == ref


def test_compat_never_takes_the_chain(tmp_path, monkeypatch):
    """On a CUDA device compat mode still takes the host route for every
    bubble (the card is stood in for and no tensor reaches it): the same
    bytes as on the CPU; naming the chain raises."""
    from reveal_tpu_torch.core.io_gfa import read_gfa, write_gfa

    gfa, _want = _bubbles(tmp_path, 25)
    kw = dict(minsize=2, nrefinements=5)
    port_msa.set_logadd_compat(True)
    try:
        got = {}
        for dev in ("cpu", "cuda"):
            if dev == "cuda":
                monkeypatch.setattr(port_msa, "resolve_device",
                                    lambda _d: torch.device("cuda"))
            G = port_refine.refine_all(read_gfa(gfa), device=dev, **kw)
            assert port_refine.LAST_STATS["route"] == "two-phase"
            write_gfa(G, None, outputfile=str(tmp_path / (dev + ".gfa")))
            with open(tmp_path / (dev + ".gfa"), "rb") as fh:
                got[dev] = fh.read()
        with pytest.raises(ValueError, match="compat"):
            port_refine.refine_all(read_gfa(gfa), device="cpu",
                                   route="chain", **kw)
    finally:
        _switched_off()
    assert got["cuda"] == got["cpu"]


# a stand-in aligner: pads every sequence with gaps to the longest, and
# writes a confidence a column (low every third column)
_STUB = r'''#!{python}
import os
import sys

tool = os.path.basename(sys.argv[0])
args = sys.argv[1:]


def read(fn):
    recs = []
    for line in open(fn):
        line = line.strip()
        if line.startswith(">"):
            recs.append([line[1:], ""])
        elif line:
            recs[-1][1] += line
    return recs


conf = None
if tool == "muscle":
    recs = read(args[args.index("-in") + 1])
elif tool == "pecan":
    out = args[args.index("-G") + 1]
    recs = [r for fn in args[args.index("-F") + 1: args.index("-l")]
            for r in read(fn)]
    conf = args[args.index("-p") + 1]
else:
    recs = read(args[0])
    conf = args[args.index("-annot") + 1]
width = max(len(s) for _n, s in recs)
text = "".join(">%s\n%s\n" % (n, s + "-" * (width - len(s)))
               for n, s in recs)
if tool == "pecan":
    with open(out, "w") as fh:
        fh.write(text)
else:
    sys.stdout.write(text)
if conf:
    lo, hi = (40, 95) if tool == "pecan" else (0.4, 0.95)
    with open(conf, "w") as fh:
        for c in range(width):
            fh.write("%s\n" % (lo if c % 3 == 0 else hi))
'''


@pytest.mark.parametrize("tool", ["muscle", "probcons", "msaprobs", "pecan"])
def test_external_method_matches_jax(tmp_path, monkeypatch, tool):
    """``--method TOOL`` runs TOOL from ``$PATH`` (a stub) on each bubble's
    alleles in the working directory: the JAX package's bytes with the
    same stub, the low-confidence columns split at ``--minconf 50``."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / tool
    stub.write_text(_STUB.replace("{python}", sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep + os.environ["PATH"])
    monkeypatch.chdir(tmp_path)
    gfa, _want = _bubbles(tmp_path, 60)
    ref, got = _both(tmp_path, gfa, dict(minsize=2, minconf=50,
                                         method=tool))
    assert got == ref
    st = port_refine.LAST_STATS
    assert st["method"] == tool and st["refined"] == 3
    assert st["pairs"] == 9 and st["chain_bubbles"] == 0
    assert not any(f.endswith(".fasta") or f.endswith(".conf")
                   for f in os.listdir(tmp_path))


def test_reveal_rem_method_matches_jax(tmp_path):
    """``--method reveal_rem``: each bubble realigned by the serial host
    anchor aligner (``align.rem.align_seqs_host``), the JAX package's
    bytes."""
    gfa, _want = _bubbles(tmp_path, 60, seed=5)
    ref, got = _both(tmp_path, gfa, dict(minsize=2, minlength=8,
                                         method="reveal_rem"))
    assert got == ref
    st = port_refine.LAST_STATS
    assert st["method"] == "reveal_rem" and st["refined"] == 3


# the CLI in a fresh process: the pool forks a process that holds torch
# and the port only (the test process also holds JAX's threads)
_CLI_POOL = """
import sys
from reveal_tpu_torch import cli
from reveal_tpu_torch.hmm import refine
cli.main(sys.argv[1:])
print("pool_processes", refine.LAST_STATS["pool_processes"])
"""


def test_nproc_matches_the_serial_run(tmp_path):
    """``refine --nproc 2 --device cpu``: the per-bubble MSA in two forked
    processes gives the serial run's bytes."""
    gfa, _want = _bubbles(tmp_path, 60, seed=7)
    args = ["refine", gfa, "--all", "--device", "cpu", "--minsize", "2",
            "--nrefinements", "10"]
    serial = str(tmp_path / "serial.gfa")
    port_cli.main(args + ["-o", serial])
    assert port_refine.LAST_STATS["pool_processes"] == 0
    pooled = str(tmp_path / "pooled.gfa")
    proc = run_port(["-c", _CLI_POOL, *args, "-o", pooled, "--nproc", "2"],
                    timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "pool_processes 2" in proc.stdout
    with open(serial, "rb") as a, open(pooled, "rb") as b:
        assert a.read() == b.read()


def test_posterior_self_check_on_the_cpu():
    err, terr, name = check_posterior_oracle(lengths=(23, 57, 180),
                                             device="cpu")
    assert name == "cpu"
    assert 0 < err <= 2e-3 and terr <= 5e-2
