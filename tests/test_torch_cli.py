"""The port's command line against ``python -m reveal_tpu.cli``.

Every scenario of the reference's CLI suites (``tests/test_cli.py``,
``test_cli2.py``, ``test_cli3.py``, ``test_cli4.py`` and the annotate and
unzip cases of ``test_annotate_unzip.py``), on their own numpy-seeded
fixtures, goes through ``reveal_tpu.cli.main`` and through
``reveal_tpu_torch.cli.main`` (with ``--device cpu`` where the subcommand
takes it), each in a directory of its own holding copies of the same
inputs.  Standard output and every file left in the directory are
compared byte for byte.  The ``align`` scenarios of ``test_cli2.py`` are
in ``tests/test_torch_align.py``.

Differences, each with its reason:

* a ``.gz`` file is compared after decompression: gzip stamps the time
  of writing into its header;
* the start and end nodes of a graph are named by ``uuid4`` (in both
  packages): in file names and in ``.gml`` and ``.fasta`` files each
  such name is replaced by its rank of first appearance;
* ``rem`` of a ``.gfa`` input or of multi-contig fastas runs the port's
  per-level device frontier, whose node numbering differs from the host
  engine's (as in ``reveal_tpu``): the reference runs ``rem --frontier``
  there, with ``REVEAL_TPU_DISABLE_DEVLOOP`` set so that it goes straight
  to its ``DeviceFrontier``;
* ``--profile`` writes a ``torch.profiler`` trace, not JAX's xplane
  files: the trace directory is left out of the comparison and checked
  on its own.
"""

import gzip
import io
import os
import pathlib
import re
import shutil
import sys

import numpy as np
import pytest
import torch

import reveal_tpu.cli as ref_cli
from reveal_tpu.core.encoding import rc_str
from reveal_tpu.core.io_fasta import fasta_writer
from reveal_tpu_torch import cli as port_cli
import torch_support  # noqa: F401  (the thread budget)

# subcommands that take --device in the port
DEVICE_CMDS = ("rem", "refine", "realign", "align", "matches", "plot",
               "chain", "transform", "finish")


def _mutator(rng):
    def mutate(seq, nsubs, nindel):
        s = list(seq)
        for _ in range(nsubs):
            i = int(rng.integers(0, len(s)))
            s[i] = "ACGT"[int(rng.integers(0, 4))]
        for _ in range(nindel):
            i = int(rng.integers(0, len(s)))
            if rng.random() < 0.5:
                s.insert(i, "ACGT"[int(rng.integers(0, 4))])
            else:
                del s[i]
        return "".join(s)
    return mutate


def _population(d, seed, size, names, nsubs, nindel):
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), size=size))
    mutate = _mutator(rng)
    seqs = {}
    for name in names:
        seqs[name] = mutate(base, nsubs, nindel)
        fasta_writer(str(d / ("%s.fa" % name)), [(name, seqs[name])])
    return seqs


def _ref(d, argv):
    """The reference CLI run in ``d`` (its outputs are later inputs)."""
    cwd = os.getcwd()
    os.chdir(d)
    try:
        rc = ref_cli.main([str(a) for a in argv])
    finally:
        os.chdir(cwd)
    assert rc in (0, None)


_SNP_GFA = (
    "H\tVN:Z:1.0\n"
    "S\t1\tAAATTT\n"
    "S\t2\tC\n"
    "S\t3\tG\n"
    "S\t4\tGGGCCC\n"
    "L\t1\t+\t2\t+\t0M\n"
    "L\t1\t+\t3\t+\t0M\n"
    "L\t2\t+\t4\t+\t0M\n"
    "L\t3\t+\t4\t+\t0M\n"
    "P\ts1\t1+,2+,4+\t*\n"
    "P\ts2\t1+,3+,4+\t*\n"
)

_VCF3 = (
    "##fileformat=VCFv4.1\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
    "chr1\t100\t.\tA\tAACACAC\t.\t.\t.\n"
    "chr1\t200\t.\tATTTTTT\tA\t.\t.\t.\n"
    "chr1\t300\t.\tA\tC\t.\t.\t.\n"
)

_VCF_MAXDIFF = (
    "##fileformat=VCFv4.1\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
    "chr1\t100\t.\tA\tAACACACACA\t.\t.\t.\n"
)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference suites' fixtures, one directory each, with the
    graphs their later scenarios read made by the reference CLI."""
    root = tmp_path_factory.mktemp("torch_cli")
    dirs = {k: root / k for k in ("cli", "cli2", "cli3", "cli4", "unit")}
    for d in dirs.values():
        d.mkdir()

    # tests/test_cli.py
    d = dirs["cli"]
    _population(d, 123, 5000, ("ga", "gb", "gc"), 40, 12)
    _ref(d, ["rem", "ga.fa", "gb.fa", "-o", "ab.gfa", "--backend", "np"])
    _ref(d, ["rem", "ga.fa", "gb.fa", "gc.fa", "-o", "abc.gfa",
             "--backend", "np"])
    _ref(d, ["unzip", "abc.gfa", "-u10"])
    _ref(d, ["refine", "abc.unzipped.gfa", "--all", "--nrefinements", "3",
             "-o", "abc.realigned.gfa"])

    # tests/test_cli2.py
    d = dirs["cli2"]
    seqs = _population(d, 321, 4000, ("ga", "gb", "gc", "gd"), 30, 8)
    fasta_writer(str(d / "gb_rc.fa"), [("gb_rc", rc_str(seqs["gb"]))])
    _ref(d, ["rem", "ga.fa", "gb.fa", "-o", "ab.gfa", "--backend", "np"])
    _ref(d, ["rem", "gc.fa", "gd.fa", "-o", "cd.gfa", "--backend", "np"])
    _ref(d, ["comp", "ab.gfa", "-o", "rc1.gfa"])
    _ref(d, ["convert", "ab.gfa", "--type", "maf"])
    buf = io.StringIO()
    sys_stdout, sys.stdout = sys.stdout, buf
    try:
        _ref(d, ["variants", "ab.gfa", "--vcf"])
    finally:
        sys.stdout = sys_stdout
    (d / "ab.vcf").write_text(buf.getvalue())
    # an aligned fasta (an MSA) for convert --aligned
    a, b = seqs["ga"][:300], seqs["gb"][:300]
    fasta_writer(str(d / "msa.fa"),
                 [("m1", a[:100] + "--" + a[100:298]),
                  ("m2", b[:150] + "-" + b[150:299])])

    # tests/test_cli3.py
    d = dirs["cli3"]
    seqs = _population(d, 777, 4000, ("ga", "gb"), 30, 8)
    with gzip.open(str(d / "ga.fa.gz"), "wt") as f:
        f.write(">ga_z\n%s\n" % seqs["ga"])
    rng = np.random.default_rng(9)
    c1 = seqs["ga"][:2000]
    c2 = "".join(rng.choice(list("ACGT"), size=1500))
    fasta_writer(str(d / "mc1.fa"), [("m1c1", c1), ("m1c2", c2)])
    fasta_writer(str(d / "mc2.fa"), [("m2c1", c1), ("m2c2", c2)])
    _ref(d, ["rem", "ga.fa", "gb.fa", "-o", "ab.gfa", "--backend", "np"])
    _ref(d, ["rem", "ga.fa", "gb.fa", "-o", "c1.gfa", "--cache",
             "--backend", "np"])
    np.arange(10, dtype=np.int64).tofile(str(d / "bad.sa"))
    np.arange(10, dtype=np.int64).tofile(str(d / "bad.lcp"))
    (d / "x.vcf").write_text(_VCF_MAXDIFF)

    # tests/test_cli4.py
    d = dirs["cli4"]
    rng = np.random.default_rng(11)
    A = "".join(rng.choice(list("ACGT"), size=4000))
    B = "".join(rng.choice(list("ACGT"), size=4000))
    C = "".join(rng.choice(list("ACGT"), size=4000))
    fasta_writer(str(d / "ref.fa"), [("chr1", A + B + C)])
    fasta_writer(str(d / "qry.fa"), [("ctg1", B + A + rc_str(C))])
    fasta_writer(str(d / "draft.fa"),
                 [("c1", rc_str(B[:3500])), ("c2", A[:3500])])
    _ref(d, ["transform", "ref.fa", "qry.fa", "-m", "30", "-c", "100",
             "--mincluster", "30", "--minchainsum", "30", "--backend", "np",
             "-o", "rout"])

    # tests/test_annotate_unzip.py
    d = dirs["unit"]
    (d / "snp.gfa").write_text(_SNP_GFA)
    (d / "three.vcf").write_text(_VCF3)
    return dirs


def _first_nodes(d, k):
    return [ln.split("\t")[1] for ln in open(d / "ab.gfa")
            if ln.startswith("S")][:k]


def _walk(d):
    nid = _first_nodes(d, 1)[0]
    return "%s+,%s-" % (nid, nid)


# (id, fixture directory, argv; options).  Options: "frontier" (the
# reference runs rem --frontier on its DeviceFrontier), "raises" (both
# raise this exception type with the same message), "skip" (paths left
# out of the comparison).  An argv item may be a function of the run
# directory.
SCENARIOS = [
    # tests/test_cli.py
    ("rem-pair", "cli", ["rem", "ga.fa", "gb.fa", "-o", "ab.gfa",
                         "--backend", "np"], {}),
    ("rem-threeway", "cli", ["rem", "ga.fa", "gb.fa", "gc.fa", "-o",
                             "abc.gfa", "--backend", "np"], {}),
    ("extract", "cli", ["extract", "abc.gfa", "ga"], {}),
    ("bubbles", "cli", ["bubbles", "abc.gfa"], {}),
    ("variants-vcf", "cli", ["variants", "abc.gfa", "--vcf"], {}),
    ("unzip", "cli", ["unzip", "abc.gfa", "-u10"], {}),
    ("refine", "cli", ["refine", "abc.unzipped.gfa", "--all",
                       "--nrefinements", "3", "-o", "abc.realigned.gfa"],
     {}),
    ("extract-refined", "cli", ["extract", "abc.realigned.gfa", "--all"],
     {}),
    ("stats", "cli", ["stats", "abc.gfa"], {}),
    ("rem-graph-x-graph", "cli", ["rem", "ab.gfa", "gc.fa", "-o",
                                  "merged.gfa", "--backend", "np"],
     {"frontier": True}),
    ("split", "cli", ["split", "abc.gfa"], {}),
    ("chop", "cli", ["chop", "abc.gfa", "-k", "21", "--check"], {}),
    # tests/test_cli2.py
    ("merge", "cli2", ["merge", "ab.gfa", "cd.gfa", "-o", "merged.gfa"], {}),
    ("comp", "cli2", ["comp", "ab.gfa", "-o", "rc1.gfa"], {}),
    ("comp-twice", "cli2", ["comp", "rc1.gfa", "-o", "rc2.gfa"], {}),
    ("subgraph", "cli2", ["subgraph", "ab.gfa",
                          lambda d: _first_nodes(d, 3), "-o", "sg.gfa"], {}),
    ("matches", "cli2", ["matches", "ga.fa", "gb.fa", "-m", "20",
                         "--backend", "np"], {}),
    ("matches-rc", "cli2", ["matches", "ga.fa", "gb_rc.fa", "-m", "100",
                            "--rc", "--backend", "np"], {}),
    ("chain", "cli2", ["chain", "ga.fa", "gb.fa", "-m", "20", "-o",
                       "chained", "--backend", "np"], {}),
    ("variants-ab", "cli2", ["variants", "ab.gfa", "--vcf"], {}),
    ("annotate", "cli2", ["annotate", "ab.vcf"], {}),
    ("rearrangements", "cli2", ["rearrangements", "ab.gfa"], {}),
    ("convert-gml", "cli2", ["convert", "ab.gfa", "--type", "gml"], {}),
    ("convert-maf", "cli2", ["convert", "ab.gfa", "--type", "maf"], {}),
    ("convert-maf-to-gfa", "cli2", ["convert", "ab.maf"], {}),
    ("convert-fasta", "cli2", ["convert", "ga.fa"], {}),
    ("convert-aligned-fasta", "cli2", ["convert", "msa.fa", "--aligned"],
     {}),
    ("extract-all", "cli2", ["extract", "ab.gfa", "--all"], {}),
    ("extract-walk", "cli2", ["extract", "ab.gfa", "-t", "path", _walk], {}),
    # tests/test_cli3.py
    ("rem-gzip", "cli3", ["rem", "ga.fa.gz", "gb.fa", "-o", "zb.gfa",
                          "--backend", "np"], {}),
    ("rem-multicontig", "cli3", ["rem", "mc1.fa", "mc2.fa", "-o", "mc.gfa",
                                 "--backend", "np"], {"frontier": True}),
    ("rem-nocontigs", "cli3", ["rem", "mc1.fa", "mc2.fa", "--nocontigs",
                               "-o", "nc.gfa", "--backend", "np"],
     {"frontier": True}),
    ("rem-cache", "cli3", ["rem", "ga.fa", "gb.fa", "-o", "c1.gfa",
                           "--cache", "--backend", "np"], {}),
    ("rem-sa-lcp", "cli3", ["rem", "ga.fa", "gb.fa", "-o", "c2.gfa",
                            "--sa", ".reveal.sa", "--lcp", ".reveal.lcp",
                            "--backend", "np"], {}),
    ("rem-sa-mismatch", "cli3", ["rem", "ga.fa", "gb.fa", "-o", "x.gfa",
                                 "--sa", "bad.sa", "--lcp", "bad.lcp",
                                 "--backend", "np"], {"raises": ValueError}),
    ("rem-gml", "cli3", ["rem", "ga.fa", "gb.fa", "-o", "g.gfa", "--gml",
                         "--backend", "np"], {}),
    ("rem-default-name", "cli3", ["rem", "ga.fa", "gb.fa"], {}),
    ("variants-bed", "cli3", ["variants", "ab.gfa", "--bed"], {}),
    ("variants-fasta", "cli3", ["variants", "ab.gfa", "--fastaout"], {}),
    ("variants-snp", "cli3", ["variants", "ab.gfa", "--vcf", "--type",
                              "snp"], {}),
    ("variants-indel", "cli3", ["variants", "ab.gfa", "--vcf", "--type",
                                "indel"], {}),
    ("refine-simple", "cli3", ["refine", "ab.gfa", "--simple", "-o",
                               "rsimple.gfa", "--backend", "np"], {}),
    ("refine-complex", "cli3", ["refine", "ab.gfa", "--complex", "-o",
                                "rcomplex.gfa", "--backend", "np"], {}),
    ("plot", "cli3", ["plot", "ga.fa", "gb.fa", "-m", "20", "-o", "dot.png",
                      "--backend", "np"], {}),
    ("gplot", "cli3", ["gplot", "ab.gfa", "-x", "ga", "-y", "gb", "-o",
                       "gdot.png"], {}),
    ("variants-split", "cli3", ["variants", "ab.gfa", "--fastaout",
                                "--split"], {}),
    ("bubbles-export", "cli3", ["bubbles", "ab.gfa", "-e"], {}),
    ("annotate-maxdiff", "cli3", ["annotate", "x.vcf", "--maxdiff", "5"],
     {}),
    ("refine-reveal-rem", "cli3", ["refine", "ab.gfa", "--all", "--method",
                                   "reveal_rem", "-o", "rrem.gfa",
                                   "--backend", "np"], {}),
    ("refine-missing-tool", "cli3", ["refine", "ab.gfa", "--all",
                                     "--method", "muscle", "-o", "rmu.gfa",
                                     "--backend", "np"], {}),
    ("plot-region", "cli3", ["plot", "ga.fa", "gb.fa", "-m", "20", "-r",
                             "100-600", "--yr", "100-600", "--flanksize",
                             "50", "--backend", "np"], {}),
    ("gplot-region", "cli3", ["gplot", "ab.gfa", "-x", "ga", "-y", "gb",
                              "-r", "500:1500", "-o", "gr.png"], {}),
    # tests/test_cli4.py
    ("transform", "cli4", ["transform", "ref.fa", "qry.fa", "-m", "30",
                           "-c", "100", "--mincluster", "30",
                           "--minchainsum", "30", "--backend", "np", "-o",
                           "tout"], {}),
    ("rearrangements-breakpoints", "cli4", ["rearrangements",
                                            "rout.gfa.gz"], {}),
    ("finish", "cli4", ["finish", "ref.fa", "draft.fa", "-m", "30",
                        "--mincluster", "30", "--minchainsum", "30",
                        "--backend", "np", "-o", "fin"], {}),
    ("finish-split", "cli4", ["finish", "ref.fa", "draft.fa", "-m", "30",
                              "--mincluster", "30", "--minchainsum", "30",
                              "--split", "--backend", "np", "-o", "fs"], {}),
    ("finish-graph", "cli4", ["finish", "ref.fa", "draft.fa", "-m", "30",
                              "--mincluster", "30", "--minchainsum", "30",
                              "--graph", "--backend", "np", "-o", "fg"], {}),
    ("plot-bed", "cli4", ["plot", "rout.bed"], {}),
    ("rem-profile", "cli4", ["rem", "ref.fa", "qry.fa", "-m", "30",
                             "--backend", "np", "--profile", "prof", "-o",
                             "pp.gfa"], {"skip": ("prof",)}),
    # tests/test_annotate_unzip.py
    ("annotate-stream", "unit", ["annotate", "three.vcf"], {}),
    ("unzip-snp", "unit", ["unzip", "snp.gfa", "-u", "0", "-o",
                           "snp.unzipped"], {}),
    ("bubbles-snp", "unit", ["bubbles", "snp.gfa"], {}),
]


def _argv(argv, d):
    out = []
    for a in argv:
        a = a(d) if callable(a) else a
        out += a if isinstance(a, list) else [a]
    return out


def _port_argv(argv):
    if argv[0] in DEVICE_CMDS:
        return [argv[0], "--device", "cpu", *argv[1:]]
    return list(argv)


_UUID = re.compile(r"(?<![0-9a-f])[0-9a-f]{32}(?![0-9a-f])")


def _files(d, skip=()):
    """{relative path: bytes} of every file under ``d``, ``.gz`` files
    decompressed, uuid names ranked."""
    names = {}

    def rank(m):
        return "uuid%d" % names.setdefault(m.group(0), len(names))

    got = {}
    for p in sorted(pathlib.Path(d).rglob("*"),
                    key=lambda p: _UUID.sub("", p.as_posix())):
        rel = p.relative_to(d).as_posix()
        if not p.is_file() or rel.split("/")[0] in skip:
            continue
        data = p.read_bytes()
        if rel.endswith(".gz"):
            data = gzip.decompress(data)
        if rel.endswith((".gml", ".fasta")):
            data = _UUID.sub(rank, data.decode()).encode()
        got[_UUID.sub(rank, rel)] = data
    return got


def _run(main, argv, d, capsys, raises):
    cwd = os.getcwd()
    os.chdir(d)
    capsys.readouterr()
    try:
        if raises:
            with pytest.raises(raises) as e:
                main(argv)
            return capsys.readouterr().out, str(e.value)
        rc = main(argv)
        assert rc == 0
        return capsys.readouterr().out, None
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("name,where,argv,opts", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_subcommand_equals_reference(name, where, argv, opts, inputs,
                                     tmp_path, capsys, monkeypatch):
    runs = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        shutil.copytree(inputs[where], d)
        args = _argv(argv, d)
        if side == "port":
            main, args = port_cli.main, _port_argv(args)
        else:
            main = ref_cli.main
            if opts.get("frontier"):
                monkeypatch.setenv("REVEAL_TPU_DISABLE_DEVLOOP", "1")
                args = args + ["--frontier"]
        out, err = _run(main, args, d, capsys, opts.get("raises"))
        monkeypatch.delenv("REVEAL_TPU_DISABLE_DEVLOOP", raising=False)
        runs[side] = (out, err, _files(d, opts.get("skip", ())))
    (ref_out, ref_err, ref_files), (out, err, files) = (runs["ref"],
                                                        runs["port"])
    assert err == ref_err
    assert out == ref_out
    assert sorted(files) == sorted(ref_files)
    for rel in ref_files:
        assert files[rel] == ref_files[rel], rel
    if "prof" in opts.get("skip", ()):
        traces = list((tmp_path / "port" / "prof").rglob("*.pt.trace.json"))
        assert traces, "no torch.profiler trace written by --profile"


def test_classify_allele_equals_reference():
    """``graph/annotate.classify_allele`` on the alleles of
    ``tests/test_annotate_unzip.py``."""
    from reveal_tpu.graph.annotate import classify_allele as ref
    from reveal_tpu_torch.graph.annotate import classify_allele as port

    alleles = ["AAAAAA", "ACACACAC", "ACGTGA" * 3, "ACGTGAC" * 3,
               "ACGT" * 30, ("ACGTTGCA" * 13 + "TTT")[:101], "ACGTTGCA",
               "", "A"]
    assert [port(a) for a in alleles] == [ref(a) for a in alleles]


@pytest.mark.parametrize("backend", ["jax", "jax-dist"])
@pytest.mark.parametrize("cmd", ["rem", "stats"])
def test_device_esa_backends_are_not_covered(backend, cmd, inputs,
                                             tmp_path, capsys):
    """Both device builds are covered now (the name is the one this test
    had while ``--backend jax-dist`` raised): ``--backend jax`` (the
    device doubling build) and ``--backend jax-dist`` (the distributed
    build, here a gloo world of one; the reference's on its 8-device
    mesh), ``rem`` on ``--device cpu``: standard output and every file
    equal the reference CLI's with the same backend."""
    argv = {"rem": ["rem", "ga.fa", "gb.fa", "-o", "out.gfa"],
            "stats": ["stats", "ab.gfa"]}[cmd] + ["--backend", backend]
    runs = {}
    for side, main, args in (("ref", ref_cli.main, argv),
                             ("port", port_cli.main, _port_argv(argv))):
        d = tmp_path / side
        shutil.copytree(inputs["cli"], d)
        out, _err = _run(main, args, d, capsys, None)
        runs[side] = (out, _files(d))
    assert runs["port"] == runs["ref"]


# the host subcommands that build an index through ESAIndex.construct
# with no device of their own: with --backend jax or jax-dist the build
# runs on the port's --device (index/suffix.build_device)
DEVICE_ESA_SCENARIOS = [(name, backend) for name, backend in (
    ("matches", "jax"), ("matches-rc", "jax"), ("chain", "jax"),
    ("plot", "jax"), ("transform", "jax"), ("finish", "jax"),
    ("matches", "jax-dist"))]


@pytest.mark.parametrize("name,backend", DEVICE_ESA_SCENARIOS,
                         ids=["%s-%s" % s for s in DEVICE_ESA_SCENARIOS])
def test_host_subcommands_build_on_the_device_given(name, backend, inputs,
                                                    tmp_path, capsys,
                                                    monkeypatch):
    """``matches``, ``chain``, ``plot``, ``transform`` and ``finish`` with
    a device build: on ``--device cpu`` their standard output and files
    are the reference CLI's with the same backend (JAX's default device
    is the CPU here); without ``--device`` the build goes to the card,
    and without one it raises before writing anything."""
    _, where, argv, _opts = next(s for s in SCENARIOS if s[0] == name)
    i = argv.index("--backend")
    argv = argv[:i + 1] + [backend] + argv[i + 2:]
    runs = {}
    for side, main, args in (("ref", ref_cli.main, argv),
                             ("port", port_cli.main, _port_argv(argv))):
        d = tmp_path / side
        shutil.copytree(inputs[where], d)
        out, _err = _run(main, args, d, capsys, None)
        runs[side] = (out, _files(d))
    assert _port_argv(argv)[1:3] == ["--device", "cpu"]
    assert runs["port"] == runs["ref"]
    d = tmp_path / "card"
    shutil.copytree(inputs[where], d)
    before = _files(d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = _run(port_cli.main, argv, d, capsys, RuntimeError)
    assert "is_available" in err
    assert _files(d) == before


def test_64_is_accepted(inputs, capsys):
    d = inputs["cli"]
    port_cli.main(["stats", str(d / "abc.gfa"), "--64"])
    out = capsys.readouterr().out
    ref_cli.main(["stats", str(d / "abc.gfa"), "--64"])
    assert out == capsys.readouterr().out


def test_no_subcommand_prints_help(capsys):
    assert port_cli.main([]) == 1
    assert "usage:" in capsys.readouterr().out


def test_dformat_equals_reference(tmp_path, capsys):
    from reveal_tpu.utils.dformat import main as ref_main
    from reveal_tpu_torch.utils.dformat import main as port_main

    fasta_writer(str(tmp_path / "reads.v1.fa"),
                 [("r1", "ACGT" * 60), ("r2", "TTTT" * 10)])
    ref_main([str(tmp_path / "reads.v1.fa")])
    ref = capsys.readouterr().out
    port_main([str(tmp_path / "reads.v1.fa")])
    assert capsys.readouterr().out == ref


@pytest.mark.parametrize("align", [False, True], ids=["unaligned",
                                                       "aligned"])
def test_falcon2gfa_equals_reference(align, tmp_path, monkeypatch):
    """``utils/falcon2gfa.py`` of ``tests/test_utils_tools.py``; with
    ``--align`` the port's aligner runs on ``--device cpu``."""
    from reveal_tpu.utils.falcon2gfa import main as ref_main
    from reveal_tpu_torch.utils.falcon2gfa import main as port_main

    rng = np.random.default_rng(9 if align else 8)
    n, lo, hi = (900, 300, 600) if align else (800, 200, 500)
    p = "".join(rng.choice(list("ACGT"), size=n))
    alt = list(p[lo:hi])
    for _ in range(8 if align else 10):
        alt[int(rng.integers(0, len(alt)))] = "ACGT"[int(rng.integers(0, 4))]
    monkeypatch.chdir(tmp_path)
    fasta_writer("p_ctg.fa", [("000000F", p)])
    fasta_writer("a_ctg_base.fa", [("000000F-01", p[lo:hi])])
    fasta_writer("a_ctg_all.fa", [("000000F-01", p[lo:hi]),
                                  ("000000F-01-02", "".join(alt))])
    args = ["p_ctg.fa", "a_ctg_base.fa", "a_ctg_all.fa"] + (
        ["--align"] if align else [])
    ref_main(args + ["-o", "ref.gfa"])
    port_main(args + (["--device", "cpu"] if align else []) + ["-o",
                                                                "port.gfa"])
    assert (tmp_path / "port.gfa").read_bytes() == (
        tmp_path / "ref.gfa").read_bytes()
