"""The port's ``align`` pipeline against ``python -m reveal_tpu.cli align``.

``align`` prints the pipeline rem -> unzip -> refine -> variants as a
shell script, or with ``--run`` runs it in one process.  The port's
script is the reference's with the prefix ``python -m reveal_tpu_torch.cli``
and ``--device`` at the end of every ``rem`` and ``refine`` line (before
a trailing `` &``), and nothing else changed (the chunk files' uuid names
are ranked before the comparison).  ``align --run --device cpu`` gives
the reference's ``align --run`` files byte for byte with ``--order
simultaneous`` (the port's multi loop gives the host engine's bytes).
With ``--order sequential`` a level's ``.gfa`` inputs take the port's
per-level frontier, whose node numbering differs from the host engine's:
there the reference runs its emitted script with ``--frontier`` added to
the ``rem`` lines that read a ``.gfa`` (its ``DeviceFrontier``, reached
with ``REVEAL_TPU_DISABLE_DEVLOOP`` set), and the fasta pairs of level 0
as emitted (the host engine, whose bytes the port's forest gives).
Also here: ``--checkpoints`` resuming, the card refused on a CPU-only
torch, and ``align_genomes``' host drivers (``frontier=False``) against
the reference's.
"""

import logging
import os
import re

import pytest
import torch

import reveal_tpu.align.rem as ref_rem
import reveal_tpu.cli as ref_cli
from reveal_tpu.core.io_fasta import fasta_writer
from reveal_tpu.core.io_gfa import seq2node, write_gfa
from reveal_tpu.utils.simulate import simulate_population
from reveal_tpu_torch import cli as port_cli
from reveal_tpu_torch.align import rem as port_rem
from reveal_tpu_torch.core.io_gfa import seq2node as port_seq2node
from reveal_tpu_torch.core.io_gfa import write_gfa as port_write_gfa
from reveal_tpu_torch.hmm import refine as port_refine
from reveal_tpu_torch.index import devfrontier, devloop_multi
import torch_support  # noqa: F401  (the thread budget)

REF_PROG = "python -m reveal_tpu.cli"
PORT_PROG = "python -m reveal_tpu_torch.cli"
_UUID = re.compile(r"(?<![0-9a-f])[0-9a-f]{32}(?![0-9a-f])")


def _genomes(d, n, length, seed):
    names = []
    for name, seq, _ids in simulate_population(n, length, seed=seed):
        fasta_writer(str(d / (name + ".fa")), [(name, seq)])
        names.append(name + ".fa")
    return names


def _ranked(text):
    names = {}
    return _UUID.sub(lambda m: "uuid%d" % names.setdefault(m.group(0),
                                                            len(names)),
                     text)


def _port_script(ref_script, device):
    """The reference's script as the port must emit it."""
    lines = []
    for ln in ref_script.splitlines():
        ln = ln.replace(REF_PROG, PORT_PROG)
        if ln.startswith((PORT_PROG + " rem ", PORT_PROG + " refine ")):
            amp = ln.endswith(" &")
            ln = (ln[:-2] if amp else ln) + " --device " + device + (
                " &" if amp else "")
        lines.append(ln)
    return "\n".join(lines) + "\n"


def _emit(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) in (0, None)
    return capsys.readouterr().out


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.is_file()}


def _in(d, fn, *a):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        return fn(*a)
    finally:
        os.chdir(cwd)


# option sets of tests/test_cli2.py's align scenarios, and the rest of
# align's options
EMIT_CASES = [
    ("sequential", 3, ["--order", "sequential", "--chunksize", "2"]),
    ("sequential-plain4", 4, ["--order", "sequential", "--chunksize", "2",
                              "--norefine", "--nounzip", "--novariants"]),
    ("sequential-parallel4", 4, ["--order", "sequential", "--chunksize",
                                 "2", "--norefine", "--nounzip",
                                 "--novariants", "--parallel"]),
    ("sequential-checkpoints", 3, ["--order", "sequential", "--chunksize",
                                   "2", "--norefine", "--nounzip",
                                   "--novariants", "--checkpoints"]),
    ("simultaneous-norefine", 2, ["--order", "simultaneous", "--norefine",
                                  "--nounzip"]),
    ("simultaneous-all", 3, ["-m", "25", "--minconf", "30"]),
    ("simultaneous-checkpoints", 3, ["--checkpoints"]),
    ("sequential-chunk3-parallel-checkpoints", 7,
     ["--order", "sequential", "--chunksize", "3", "--parallel",
      "--checkpoints"]),
    ("transform", 2, ["-r", "REF", "--transform"]),
    ("reference-no-transform", 2, ["-r", "REF", "--novariants"]),
]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name,n,opts", EMIT_CASES,
                         ids=[c[0] for c in EMIT_CASES])
def test_align_emits_the_reference_script(name, n, opts, device, tmp_path,
                                          capsys):
    fastas = [str(tmp_path / ("g%d.fa" % i)) for i in range(n)]
    opts = [str(tmp_path / "ref.fa") if o == "REF" else o for o in opts]
    argv = ["align", *fastas, *opts, "-o", "prg"]
    ref = _emit(ref_cli.main, argv, capsys)
    port = _emit(port_cli.main, argv + ["--device", device], capsys)
    assert _ranked(port) == _ranked(_port_script(ref, device))
    assert " rem " in port and port.count("--device %s" % device) == sum(
        1 for ln in port.splitlines()
        if ln.startswith((PORT_PROG + " rem ", PORT_PROG + " refine ")))


@pytest.mark.parametrize("n,length,seed", [(3, 4000, 5), (6, 2500, 6)],
                         ids=["3-genomes", "6-genomes"])
def test_align_run_simultaneous_equals_reference(n, length, seed, tmp_path,
                                                 capsys):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    names = _genomes(tmp_path, n, length, seed)
    argv = ["align", *[str(tmp_path / f) for f in names], "--run", "-o",
            "prg"]
    _in(tmp_path / "ref", ref_cli.main, argv)
    devloop_multi.LAST_STATS.clear()
    _in(tmp_path / "port", port_cli.main, argv + ["--device", "cpu"])
    assert capsys.readouterr().out == ""
    # rem took the multi loop whole; refine realigned bubbles
    st = devloop_multi.LAST_STATS
    assert st["abort"] == 0 and st["fallback"] is None and st["levels"] > 1
    assert port_refine.LAST_STATS["refined"] > 0
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port) == sorted(ref) == sorted(
        ["prg.gfa", "prg.unzipped.gfa", "prg.unzipped.realigned.gfa",
         "prg.anchored.vcf", "prg.unzipped.vcf", "prg.refined.vcf"])
    for fn in ref:
        assert port[fn] == ref[fn], fn


def test_align_run_sequential_equals_reference_frontier(tmp_path, capsys,
                                                        monkeypatch):
    """``--order sequential --chunksize 2`` on four genomes: two fasta
    pairs (the port's forest), then their two ``.gfa`` graphs (the port's
    per-level frontier), unzip, refine, variants."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    names = _genomes(tmp_path, 4, 3000, 7)
    argv = ["align", *[str(tmp_path / f) for f in names], "--order",
            "sequential", "--chunksize", "2", "-o", "prg"]
    script = _emit(ref_cli.main, argv, capsys)
    lines = []
    for ln in script.splitlines():
        toks = ln.split()
        if ln.startswith(REF_PROG + " rem ") and any(
                t.endswith(".gfa") for t in toks[4:toks.index("-o")]):
            ln += " --frontier"
        lines.append(ln)
    assert sum("--frontier" in ln for ln in lines) == 1
    monkeypatch.setenv("REVEAL_TPU_DISABLE_DEVLOOP", "1")
    _in(tmp_path / "ref", ref_cli._run_pipeline_script, "\n".join(lines))
    monkeypatch.delenv("REVEAL_TPU_DISABLE_DEVLOOP")
    devfrontier.LAST_STATS.clear()
    _in(tmp_path / "port", port_cli.main, argv + ["--run", "--device",
                                                  "cpu"])
    assert devfrontier.LAST_STATS["levels"] > 1
    assert port_refine.LAST_STATS["refined"] > 0
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port) == sorted(ref)
    assert len(ref) == 6
    for fn in ref:
        assert port[fn] == ref[fn], fn


def test_align_checkpoints_resume(tmp_path, capsys, monkeypatch, caplog):
    """``--run --checkpoints``: a run cut in its variants stage leaves the
    rem and refine checkpoints; the second ``--run`` resumes both stages
    from them, and every file equals a run without checkpoints and the
    reference's ``align --run --checkpoints``."""
    for sub in ("cut", "plain", "ref"):
        (tmp_path / sub).mkdir()
    names = _genomes(tmp_path, 3, 3000, 8)
    argv = ["align", *[str(tmp_path / f) for f in names], "--run", "-o",
            "prg", "--checkpoints"]

    def cut(args):
        raise RuntimeError("cut")

    with monkeypatch.context() as m:
        m.setattr(port_cli, "variants_cmd", cut)
        with pytest.raises(RuntimeError, match="cut"):
            _in(tmp_path / "cut", port_cli.main, argv + ["--device", "cpu"])
    left = _files(tmp_path / "cut")
    assert {"prg.anchors", "prg.bubbles", "prg.gfa",
            "prg.unzipped.realigned.gfa"} <= set(left)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        _in(tmp_path / "cut", port_cli.main, argv + ["--device", "cpu"])
    text = caplog.text
    m_rem = re.search(r"resuming with (\d+) logged anchor decisions", text)
    m_ref = re.search(r"resuming with (\d+) bubbles already refined", text)
    assert m_rem and int(m_rem.group(1)) > 0, text[-2000:]
    assert m_ref and int(m_ref.group(1)) > 0, text[-2000:]
    _in(tmp_path / "plain", port_cli.main, argv[:-1] + ["--device", "cpu"])
    _in(tmp_path / "ref", ref_cli.main, argv)
    got = _files(tmp_path / "cut")
    assert sorted(got) == sorted(_files(tmp_path / "plain")) == sorted(
        _files(tmp_path / "ref"))
    assert "prg.anchors" not in got and "prg.bubbles" not in got
    for fn, data in got.items():
        assert data == _files(tmp_path / "plain")[fn], fn
        assert data == _files(tmp_path / "ref")[fn], fn


def test_align_run_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """``--device cuda`` on a CPU-only torch (stood in for): the first
    ``rem`` stage raises before it writes anything; nothing runs on the
    CPU instead."""
    names = _genomes(tmp_path, 3, 2000, 9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        _in(tmp_path, port_cli.main,
            ["align", *names, "--run", "--device", "cuda", "-o", "prg"])
    assert not any(p.name.startswith("prg") for p in tmp_path.iterdir())


def _gfa_bytes(G, idx, fn, s2n, wg):
    s2n(G, idx.main.T)
    wg(G, idx.main.T, outputfile=fn)
    with open(fn, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("kw", [dict(threads=2), dict(threads=0),
                                dict(threads=3, minlength=15)],
                         ids=["levels-2", "lifo", "levels-3-m15"])
def test_align_genomes_host_drivers_equal_reference(kw, tmp_path):
    """``align_genomes(frontier=False, threads=N)``: the level-synchronous
    host loop (``threads > 0``) or the serial LIFO loop, as the
    reference's ``align_genomes`` runs them."""
    names = [str(tmp_path / f) for f in _genomes(tmp_path, 3, 5000, 10)]
    G, idx = ref_rem.align_genomes(names, backend="auto", **kw)
    ref = _gfa_bytes(G, idx, str(tmp_path / "ref.gfa"), seq2node,
                     write_gfa)
    G, idx = port_rem.align_genomes(names, device="cpu", frontier=False,
                                    **kw)
    got = _gfa_bytes(G, idx, str(tmp_path / "port.gfa"), port_seq2node,
                     port_write_gfa)
    assert got == ref


def test_align_genomes_checkpoint_api(tmp_path):
    """``align_genomes(checkpoint=FILE)``: refused with the frontier or
    threads (the reference's error); the LIFO loop's log replayed whole
    on a second call gives the same GFA as the reference."""
    names = [str(tmp_path / f) for f in _genomes(tmp_path, 2, 5000, 11)]
    ck = str(tmp_path / "a.anchors")
    for kw in (dict(frontier=True), dict(frontier=False, threads=2)):
        with pytest.raises(ValueError, match="serial LIFO driver"):
            port_rem.align_genomes(names, device="cpu", checkpoint=ck, **kw)
    G, idx = ref_rem.align_genomes(names, backend="auto")
    ref = _gfa_bytes(G, idx, str(tmp_path / "ref.gfa"), seq2node,
                     write_gfa)
    for turn in range(2):
        G, idx = port_rem.align_genomes(names, device="cpu", frontier=False,
                                        checkpoint=ck)
        got = _gfa_bytes(G, idx, str(tmp_path / ("p%d.gfa" % turn)),
                         port_seq2node, port_write_gfa)
        assert got == ref, turn
