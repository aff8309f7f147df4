"""The port stands alone, and its copies of host code do not drift.

``reveal_tpu_torch`` imports neither ``jax`` nor anything of
``reveal_tpu``; it keeps its own copy of the host code it needs.  While
``reveal_tpu`` is the reference, these tests hold every copy to its
original: whole files byte for byte, single functions by their source,
and the few functions the port had to change by the lines they keep.
The only rewrites allowed everywhere: the absolute prefix of the
upstream source tree in comments is dropped (the copies cite its files by
their path inside that tree), and what is listed here.
"""

import ast
import importlib
import inspect
import pathlib

import pytest

import reveal_tpu.align.rem as jax_rem
from reveal_tpu.utils.simulate import simulate_population
from reveal_tpu_torch.align import rem as port_rem
from torch_support import (REPO, cli_args, jax_gfa, jax_refined,
                           pin_jax_two_phase, refine_graphs,
                           run_port, write_population)

PKG = REPO / "reveal_tpu_torch"
ORIG = REPO / "reveal_tpu"


# the absolute prefix under which the originals' comments cite the
# upstream sources
_UPSTREAM_PREFIX = "/".join(["", "root", "reference", ""])


def _norm(text):
    return text.replace(_UPSTREAM_PREFIX, "")


# --------------------------------------------------------------------------
# (a) no import of jax or reveal_tpu anywhere in the port
# --------------------------------------------------------------------------

def test_no_module_of_the_port_imports_jax_or_reveal_tpu():
    banned = ("jax", "jaxlib", "reveal_tpu")
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    # chip_smoke.py imports the tests' support module, whose functions
    # that compare with the JAX package import it when they run
    support = REPO / "tests" / "torch_support.py"
    for path in files + [support]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in (tree.body if path == support else ast.walk(tree)):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", getattr(node.func, "attr",
                                                       "")) in
                  ("import_module", "__import__")
                  and node.args and isinstance(node.args[0], ast.Constant)):
                mods = [str(node.args[0].value)]
            for mod in mods:
                assert not any(mod == b or mod.startswith(b + ".")
                               for b in banned), (path, mod)


# --------------------------------------------------------------------------
# (b) the CLI with both packages blocked
# --------------------------------------------------------------------------

def _rem_case(tmp_path, fastas, flags, **cfg):
    """``rem`` of ``fastas`` with ``flags``, and the JAX package's host
    engine's GFA of the same input (``cfg``) to hold it to."""
    G, idx = jax_rem.align_genomes(fastas, backend="auto", **cfg)
    want = jax_gfa(G, idx, str(tmp_path / "host.gfa"))
    return ["rem", *fastas, *flags, "--device", "cpu", "-o",
            str(tmp_path / "port.gfa")], want


@pytest.mark.parametrize("case", ["rem-pair", "rem-three",
                                  "rem-notrim-pair", "realign-chain",
                                  "align-run"])
def test_cli_runs_with_jax_and_reveal_tpu_blocked(tmp_path, monkeypatch,
                                                 case):
    """The port's CLI in a process that cannot import jax or reveal_tpu,
    on each of its routes, held to the JAX package where it can be:

    - ``rem-pair``: a 20 kbp pair through the host prefix and forest
      (``--frontier``), the host engine's GFA bytes;
    - ``rem-three``: three genomes of 3 kbp through the multi loop, the
      host engine's GFA bytes;
    - ``rem-notrim-pair``: a 5 kbp pair with ``--notrim`` through the
      per-level frontier, the bytes of the host engine with ``trim=False``;
    - ``realign-chain``: a bubble chain through ``realign`` (the alias of
      ``refine``), the bytes of the JAX package's two-phase refine;
    - ``align-run``: the whole pipeline (rem, unzip, refine, three
      variants calls) on three genomes of 3 kbp, its six files written.
    """
    if case == "rem-pair":
        argv, want = _rem_case(tmp_path, write_population(
            tmp_path, 2, 20_000, 3), ["--frontier"])
    elif case == "rem-three":
        argv, want = _rem_case(tmp_path, write_population(
            tmp_path, 3, 3_000, 9), [])
    elif case == "rem-notrim-pair":
        argv, want = _rem_case(tmp_path, write_population(
            tmp_path, 2, 5_000, 5), ["--notrim"], trim=False)
    elif case == "realign-chain":
        pin_jax_two_phase(monkeypatch)
        gfa, kw, _ = refine_graphs(tmp_path)["chain"]
        want = jax_refined(str(gfa), str(tmp_path / "jax.gfa"),
                           consgap=False, **kw)
        argv = ["realign", str(gfa), "--all", "--device", "cpu", "-o",
                str(tmp_path / "port.gfa"), *cli_args(kw)]
    else:
        argv = ["align", *write_population(tmp_path, 3, 3_000, 4), "--run",
                "--device", "cpu", "-o", "prg"]
    proc = run_port(["-m", "reveal_tpu_torch.cli", *argv], blocked=True,
                    cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "declined" not in proc.stderr, proc.stderr[-3000:]
    if case == "align-run":
        for ext in ("gfa", "unzipped.gfa", "unzipped.realigned.gfa",
                    "anchored.vcf", "unzipped.vcf", "refined.vcf"):
            assert (tmp_path / ("prg." + ext)).stat().st_size > 0, ext
    else:
        assert (tmp_path / "port.gfa").read_bytes() == want


# --------------------------------------------------------------------------
# (c) the copies equal their originals
# --------------------------------------------------------------------------

WHOLE_FILES = [
    "core/encoding.py", "core/textstore.py", "core/io_fasta.py",
    "core/io_gfa.py", "graph/pangraph.py", "native/esa.cpp",
    "native/__init__.py", "align/graphops.py", "align/chaining.py",
    "align/picker.py", "graph/bubbles.py", "graph/extract.py",
    "graph/simplify.py", "hmm/refinelog.py", "index/esa_index.py",
    "hmm/compat.py", "graph/unzip.py", "graph/varcall.py",
    "graph/annotate.py", "graph/chop.py", "align/anchorlog.py",
    "align/kdchain.py", "transform/__init__.py", "transform/blocks.py",
    "transform/driver.py", "transform/finish.py", "core/io_maf.py",
    "core/maf2graph.py", "utils/dformat.py", "utils/falcon2gfa.py",
    "viz.py",
]

# lines of a whole-file copy that differ: (only in the original, only in
# the port).  The port's native library builds into its own directory.
WHOLE_FILE_CHANGES = {
    # a .gz written in text mode is deflated at level 9 on the host's
    # cores while the text is built (core/gzwrite.py); the text is the same
    "core/io_gfa.py": (
        [],
        ["from .gzwrite import GzipTextWriter",
         '        if mode == "wt":  # level 9, deflated on the host\'s cores',
         "            return GzipTextWriter(fn)"],
    ),
    "native/esa.cpp": (  # a section heading reworded
        ["// ---- parallel " + "driv" + "er " + "-" * 51],
        ["// ---- parallel dispatch " + "-" * 49],
    ),
    "native/__init__.py": (
        [
            "    d = os.environ.get(",
            '        "REVEAL_TPU_NATIVE_CACHE",',
            '        os.path.expanduser("~/.cache/reveal_tpu_native"),',
            "    )",
        ],
        ['    d = os.path.join(os.path.dirname(_HERE), "build")'],
    ),
    "utils/dformat.py": (  # the module's own run line
        ["Run: python -m reveal_tpu.utils.dformat reads.fa > formatted.fa"],
        ["Run: python -m reveal_tpu_torch.utils.dformat reads.fa > "
         "formatted.fa"],
    ),
    # the device the 'jax' backend builds on
    "index/esa_index.py": (
        ["            SA, LCP, SAi = build_esa(T, backend=backend)"],
        ["        device=None,",
         "            SA, LCP, SAi = build_esa(T, backend=backend, "
         "device=device)"],
    ),
    # the module's own run line; --align runs the port's aligner on the
    # device given (the card unless --device cpu)
    "utils/falcon2gfa.py": (
        ["Run: python -m reveal_tpu.utils.falcon2gfa p_ctg.fa a_ctg_base.fa "
         "a_ctg_all.fa",
         "        G, idx = align_seqs(aobjs, minlength=args.minlength)"],
        ["Run: python -m reveal_tpu_torch.utils.falcon2gfa p_ctg.fa "
         "a_ctg_base.fa a_ctg_all.fa",
         '    parser.add_argument("--device", default="cuda",',
         '                        help="Torch device of --align: cuda or '
         'cpu.")',
         "        G, idx = align_seqs(aobjs, minlength=args.minlength,",
         "                            device=args.device)"],
    ),
}


@pytest.mark.parametrize("rel", WHOLE_FILES)
def test_whole_file_copy_equals_original(rel):
    import difflib

    orig = _norm((ORIG / rel).read_text()).splitlines()
    port = (PKG / rel).read_text().splitlines()
    minus = [ln[2:] for ln in difflib.ndiff(orig, port) if ln[:2] == "- "]
    plus = [ln[2:] for ln in difflib.ndiff(orig, port) if ln[:2] == "+ "]
    want_minus, want_plus = WHOLE_FILE_CHANGES.get(rel, ([], []))
    assert minus == want_minus
    assert plus == want_plus


COPIED = {
    "index.suffix": [
        "suffix_array_np", "_rank_levels_np", "_stop_distance_np",
        "lcp_from_sa_np", "_lcp_from_levels_np", "sufcheck", "_num_levels"],
    "index.frontier": ["pack_segments"],
    "parallel.dsa": ["_partners", "_network_layers"],
    "index.mums": [
        "_leftmax_vec", "pairwise_mums", "_psv_nsv", "lcp_intervals",
        "tuples_from_arrays", "multimums", "multimems",
        "multimums_oracle"],
    "index.devloop": ["_next_pow2", "forest_pop_order", "pop_order"],
    "index.devfrontier": ["_next_pow2"],
    "align.rem": [
        "graphalign", "_enum_pick", "_pairwise_fast_eligible",
        "_rem2_native_loop", "_rem2_replay_native", "_rem2_replay",
        "_align_loop", "_align_loop_levels", "read_fasta_into",
        "_multi_fast_eligible", "_rem_multi_replay"],
    # "port module:original module" where the port moved a function
    "index.devloop_multi:index.devloop": ["forest_pop_order_multi"],
    "utils.simulate": ["mutate", "simulate_population"],
    "hmm.pairhmm": [
        "_emission_tables", "_log_params", "_pad_with_dummy", "_bucket",
        "forward_np", "backward_np", "posterior_oracle"],
    "hmm.msa": [
        "SparsePost", "_sparsify", "_bucket_len", "_mea_dp", "_mea_dp_fast",
        "_Aln",
        "_build_posterior", "_align_alignments", "_add_gaps",
        "_compute_tree", "_consistency_round_sparse", "probcons_align",
        "_project", "_refine_once", "_refine_stage", "_annotation",
        "set_logadd_compat"],
    "hmm.refine": [
        "_mp_run_job", "_external_msa", "build_column_graph", "prepare_bubble_alleles",
        "replace_bubble", "select_realign_bubbles",
        "collect_bubble_aobjs"],
    # the subcommands that run host code only
    "cli": [
        "bubbles_cmd", "variants_cmd", "unzip_cmd", "extract_cmd",
        "split_cmd", "merge_cmd", "comp_cmd", "subgraph_cmd", "stats_cmd",
        "chop_cmd", "transform_cmd", "finish_cmd", "convert_cmd",
        "rearrangements_cmd", "chain_cmd", "annotate_cmd", "plot_cmd",
        "gplot_cmd", "matches_cmd"],
}


@pytest.mark.parametrize(
    "mod,name",
    [(m, n) for m, names in COPIED.items() for n in names],
    ids=lambda v: v,
)
def test_copied_function_equals_original(mod, name):
    port_mod, _, orig_mod = mod.partition(":")
    orig = getattr(importlib.import_module("reveal_tpu." + (orig_mod or
                                                            port_mod)), name)
    port = getattr(importlib.import_module("reveal_tpu_torch." + port_mod),
                   name)
    assert inspect.getsource(port) == _norm(inspect.getsource(orig))


# Functions the port had to change.  Every line of the original outside
# the regions it leaves out must still be there, in order; what the port
# adds is its own.  A region is (first line, last line) of the original,
# matched after stripping; single lines stand for themselves, and
# "x|y" is a line x followed by a line y.  A name "port:original" holds a
# port function to an original of another name.
CHANGED = {
    # the native, numpy and device doubling routes and the distributed
    # build, the device ones on a device given or build_device's
    # (build_esa_device; make_mesh(device=...)), and 'auto' is native
    # with no numpy fallback
    ("index.suffix", "build_esa"): [
        ('def build_esa(T_np: np.ndarray, backend: str = "auto"):',) * 2,
        ('"""(SA, LCP, SAi) with backend in '
         "{'auto','jax','jax-dist','np'}.",
         "np' = pure-numpy"),
        ("oracle.  'auto' prefers native, then numpy.",) * 2,
        ("T_np, make_mesh(), lcp_ckpt_stride=stride",) * 2,
        ("try:|from ..native import build_esa_native",
         'return build_esa(T_np, backend="np")'),
        ("try:|return build_esa_jax(T_np)",
         'return build_esa(T_np, backend="np")'),
    ],
    # the whole-MSA native result is not ported
    ("hmm.refine", "msa_to_graph"): [
        ("precomputed_msa=None,",) * 2,
        ("elif precomputed_msa is not None:",
         'seqs[ng.graph["path2id"][name]] = seq'),
    ],
    # reveal_rem runs the port's host engine on (name, seq) tuples
    # (align_seqs_host); the whole-MSA native result is not ported
    ("hmm.refine", "refine_bubble"): [
        ("precomputed_msa=None,",) * 2,
        ('"""refine.py:149-273: reveal_probcons / external MSA methods, '
         "or", 'refine.py:219-231)."""'),
        ("from ..align.rem import align_seqs",) * 2,
        ("ng, idx = align_seqs(",) * 2,
        ("precomputed_msa=precomputed_msa,",) * 2,
    ],
    # the chain on a CUDA device, the two-phase route for the bubbles over
    # the cap (reveal_tpu/hmm/refine.py:699-892); left out: the backend
    # probe, the native crossovers, the full two-phase recompute and the
    # device consistency of the two-phase route, the excepts that
    # reroute a failure, the whole-MSA native result
    ("hmm.refine", "refine_all"): [
        ('"""refine.py:377-525 (sequential path; device batching inside '
         "MSA).",) * 2,
        ("batch_consistency,",) * 2,
        ("use_dev = False", "pass"),
        ("# phase 1 (device path): fused posterior -> distance -> "
         "consistency", "# runs the exact float64 consistency loop on "
         "host."),
        ("msa_for = [None] * len(work)",) * 2,
        ('if all_pairs and method == "reveal_probcons":',
         '"native MSA batch failed (%s); host path", e'),
        ("rem_idx = [", "]"),
        ("if use_dev and rem_idx and not done:", "e,"),
        ("if not done:", '"device consistency failed (%s); host '
         'fallback", e'),
        ("jobs = list(zip(work, pair_slices, mats_for, dist_for, "
         "msa_for))",) * 2,
        ("(bubble, sg, offsets, paths, aobjs), (s, e), pmats, pdist, "
         "pmsa = job",) * 2,
        ("precomputed_msa=pmsa,",) * 2,
        ("for i, (_w, _se, pm, _pd, pmsa) in enumerate(jobs)",
         "if pm is not None or pmsa is not None or posteriors"),
    ],
    # the device option
    ("cli", "refine_cmd"): [],
    # the device option; the device route unless --checkpoint asks for
    # the host LIFO loop
    ("cli", "rem_cmd"): [
        ("frontier=args.frontier,",) * 2,
    ],
    # the port's prefix; --device at the end of every rem and refine line
    ("cli", "align_cmd"): [
        ('"""Emit the meta-pipeline shell script',
         'in-process instead of printing it."""'),
        ('prog = "python -m reveal_tpu.cli"',) * 2,
        ('"%s rem %s -o %s.gfa%s%s\\n"',
         '% (prog, " ".join(chunk), args.output, ck, amp)'),
        ('"%s rem %s -o %s.gfa%s%s\\n"',
         '% (prog, " ".join(chunk), tmp, ck, amp)'),
        ('"%s rem %s -m%d -o %s.gfa%s\\n"',
         '% (prog, " ".join(graphs), args.minlength, args.output, ck)'),
        ('"--mindiff=0 --minconf=%d%s -o %s.unzipped.realigned.gfa\\n"',
         "% (prog, args.output, args.minconf, ck, args.output)"),
    ],
    # the port's prefix, and its main
    ("cli", "_run_pipeline_script"): [
        ('"""Execute an emitted align pipeline in ONE process',
         'jobs run serially in-process)."""'),
        ('assert toks[:3] == ["python", "-m", "reveal_tpu.cli"], (',) * 2,
    ],
    # the loop runs on a device given; no environment switch; the root's
    # multiMUM count is computed, not guessed when it fails
    ("align.rem", "_rem_device_multi_loop"): [
        ("G: PanGraph, t: IntervalIndex, root: ESAIndex, cfg: "
         "PickerConfig",) * 2,
        ('"""Whole-recursion multi device fast path',
         'or None when ineligible/aborted (caller falls back)."""'),
        ('if os.environ.get("REVEAL_TPU_DISABLE_DEVLOOP"):', "return None"),
        ("from ..index.devloop import rem_device_multi",) * 2,
        ("try:", "nroot = 256"),
        ("res = rem_device_multi(",) * 2,
    ],
    # the per-level frontier on a device given: no mesh, no fast-loop
    # prelude (the port's routing picks the loops before it), stage
    # seconds kept; the repair comment cites a TPU measurement
    ("align.rem", "_align_loop_frontier"): [
        ("mesh=None,",) * 2,
        ('"""Device-resident level-synchronous recursion (the BASELINE.json',
         "— byte-identical to the serial engine's GFA.\"\"\""),
        ("if mesh is None:", "return steps"),
        ("steps = _rem_device_multi_loop(G, t, root, cfg)", "return steps"),
        ("mesh=mesh,", "nsep=main.nsep,"),
        ("# ---- boundary repair on affected leading children (batched:",
         "# to the batched transfer on this part) "
         "--------------------------"),
    ],
    # the shim's comment reworded
    ("index.devfrontier", "SegDesc"): [
        ("# the MumPicker reads idx.main.nsamples via ESAIndex; here the",
         "so keep a compatible shim"),
    ],
    # the numpy walk alone, as the reference the native walk is tested
    # against (the port's _repair_host raises without the native library)
    ("index.devfrontier", "_repair_host_plain:_repair_host"): [
        ("def _repair_host(SA: np.ndarray", "pass"),
    ],
    # the device route only (frontier=True's, on a device given): no
    # frontier or threads switch, no mesh, the serial host engine and the
    # level-parallel host loop are not entry points here (align_seqs_host
    # runs the host engine); the input graph is built by _seqs_graph
    ("align.rem", "align_seqs"): [
        ("threads: int = 0,", "mesh=None,"),
        ("ts = TextStore()", "idx.nodes = root_nodes"),
        ("if frontier or mesh is not None:", "_align_loop(G, t, idx, cfg)"),
    ],
    # the device the 'jax' backend builds on
    ("align.rem", "_seqs_graph:align_seqs"): [
        ("def align_seqs(", '"""'),
        ("idx = ESAIndex.construct(ts, backend=backend)",) * 2,
        ("cfg = PickerConfig(", "return G, idx"),
    ],
    # the loop runs on a device given; no environment switch to disable
    # it or to skip the host prefix and forest; a --notrim input is not
    # taken (the port's frontier honours it)
    ("align.rem", "_rem_device_loop"): [
        ("G: PanGraph, t: IntervalIndex, root: ESAIndex, cfg: "
         "PickerConfig",) * 2,
        ('"""Whole-recursion DEVICE fast path',
         'kernel aborted (caller falls back)."""'),
        ('if os.environ.get("REVEAL_TPU_DISABLE_DEVLOOP"):', "return None"),
        ("mode = os.environ.get(", '"hybrid")'),
        ('if mode == "hybrid":',) * 2,
        ("steps = _rem_device_hybrid(G, t, root, cfg)",) * 2,
        ("from ..index.devloop import rem_device_loop",) * 2,
        ("res = rem_device_loop(",) * 2,
    ],
}


def _kept_lines(orig_src, regions):
    lines = [ln.strip() for ln in _norm(orig_src).splitlines()]
    lines = [ln for ln in lines if ln]
    pos = 0
    for first, last in regions:
        heads = first.split("|")  # "x|y": a line x followed by a line y
        a = next(i for i in range(pos, len(lines) - len(heads) + 1)
                 if all(lines[i + k].startswith(h)
                        for k, h in enumerate(heads)))
        b = next(i for i in range(a, len(lines))
                 if lines[i].endswith(last))
        del lines[a: b + 1]
        pos = a
    return lines


@pytest.mark.parametrize("mod,name", sorted(CHANGED), ids=lambda v: v)
def test_changed_function_keeps_the_rest_of_its_original(mod, name):
    port_name, _, orig_name = name.partition(":")
    orig = getattr(importlib.import_module("reveal_tpu." + mod),
                   orig_name or port_name)
    port = getattr(importlib.import_module("reveal_tpu_torch." + mod),
                   port_name)
    kept = _kept_lines(inspect.getsource(orig), CHANGED[(mod, name)])
    have = iter(ln.strip() for ln in inspect.getsource(port).splitlines())
    for ln in kept:
        assert any(h == ln for h in have), "missing or moved: %r" % ln
    assert len(kept) > 10  # the regions left most of the function


def test_constants_equal_the_originals():
    import reveal_tpu.hmm.msa as jm
    import reveal_tpu.index.devloop as jd
    import reveal_tpu_torch.hmm.msa as pm
    import reveal_tpu_torch.index.devloop as pd

    for k in ("_LMAX", "_RMAX", "_WREP", "_WRV", "_RETRYABLE") + tuple(
            n for n in dir(jd) if n.startswith("ABORT_")):
        assert getattr(pd, k) == getattr(jd, k), k
    for k in ("POSTERIOR_CUTOFF", "OP_B", "OP_Y", "OP_X",
              "_SPARSE_CONS_MIN_ELEMS", "CHAIN_BYTES_CAP"):
        assert getattr(pm, k) == getattr(jm, k), k
    import reveal_tpu.hmm.pairhmm as jp

    assert pm.SPARSE_TRANSFER_MIN_WIDTH == jp.SPARSE_TRANSFER_MIN_WIDTH
    assert port_rem.DEFER_MAX == 16


def test_native_library_builds_into_the_port():
    import reveal_tpu_torch.native as port_native

    assert port_native.get_lib() is not None
    built = sorted((PKG / "build").glob("esa_*.so"))
    assert built, "no esa_*.so under reveal_tpu_torch/build"
    assert pathlib.Path(port_native._build_dir()) == PKG / "build"


# --------------------------------------------------------------------------
# (d) the port's host engine equals reveal_tpu's
# --------------------------------------------------------------------------

def test_host_engine_writes_the_same_gfa(tmp_path):
    fastas = write_population(tmp_path, 2, 200_000, 1)
    G, idx = jax_rem.align_genomes(fastas, backend="auto")
    ref = jax_gfa(G, idx, str(tmp_path / "jax.gfa"))
    G, idx = port_rem.align_genomes_host(fastas)
    got = port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa"))
    assert got == ref


def test_host_engine_writes_the_same_gfa_gz(tmp_path):
    """The same graph written to ``.gfa.gz``: the port deflates on several
    threads, the original through ``gzip.open``; the text is the same."""
    import gzip

    from reveal_tpu_torch.core import gzwrite

    fastas = write_population(tmp_path, 2, 200_000, 1)
    G, idx = jax_rem.align_genomes(fastas, backend="auto")
    ref = gzip.decompress(jax_gfa(G, idx, str(tmp_path / "jax.gfa.gz")))
    G, idx = port_rem.align_genomes_host(fastas)
    got = port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa.gz"))
    assert gzwrite.LAST_STATS["gz_bytes"] == len(got)
    assert gzwrite.LAST_STATS["chunks"] > 1
    assert gzip.decompress(got) == ref


def test_simulate_population_equals_original():
    from reveal_tpu_torch.utils.simulate import (
        simulate_population as port_sim,
    )

    a = simulate_population(3, 5_000, seed=9)
    b = port_sim(3, 5_000, seed=9)
    assert [(n, s) for n, s, _ in a] == [(n, s) for n, s, _ in b]
