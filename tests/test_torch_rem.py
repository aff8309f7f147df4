"""The torch port's pairwise ``rem --frontier`` slice end to end on the CPU.

The port (reveal_tpu_torch, forest on the CPU through the plain torch
path) must write the same GFA bytes as the JAX package's device hybrid
and as the serial host engine; it must never import jax or reveal_tpu;
inputs it does not cover must raise, and no route may reach the serial
host engine.
"""

import ast

import numpy as np
import pytest
import torch

import reveal_tpu.align.rem as jax_rem
import reveal_tpu.index.devloop as jax_devloop
from reveal_tpu.core.io_fasta import fasta_writer
from reveal_tpu_torch.align import rem as port_rem
from reveal_tpu_torch.core.torchconfig import resolve_device
from reveal_tpu_torch.index import devfrontier, devloop
from reveal_tpu_torch.index import window_resolve as wr
from torch_support import REPO, jax_gfa, write_population

PKG = REPO / "reveal_tpu_torch"


def test_slice_matches_jax_hybrid_and_host_engine(tmp_path):
    """simulate_population(2, 200_000, seed=1): 182 deferred roots, 11
    levels, 78 repair rounds."""
    fastas = write_population(tmp_path, 2, 200_000, 1)
    G, idx = jax_rem.align_genomes(fastas, backend="auto")
    host = jax_gfa(G, idx, str(tmp_path / "host.gfa"))

    G, idx = jax_rem.align_genomes(fastas, backend="auto", frontier=True)
    jax_stats = dict(jax_devloop.LAST_STATS)
    jax_hybrid = jax_gfa(G, idx, str(tmp_path / "jax.gfa"))

    before = wr.LAUNCHES
    G, idx = port_rem.align_genomes(fastas, device="cpu")
    st = dict(devloop.LAST_STATS)
    port = port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa"))

    assert jax_stats["abort"] == 0 and jax_stats["forest"] > 0
    assert st["abort"] == 0 and st["fallback"] is None
    for k in ("forest", "slots", "levels", "anchors", "repair_steps",
              "chain_steps", "trim_steps"):
        assert st[k] == jax_stats[k], k
    assert st["repair_steps"] > 0
    assert wr.LAUNCHES == before  # CPU tensors take the plain path
    assert port == jax_hybrid
    assert port == host


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, [a.name]
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", [a.name for a in node.names]


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_port_source_never_imports_jax(path):
    banned_mods = ("jax", "jaxlib", "reveal_tpu")
    for mod, _names in _imports(path):
        assert not any(
            mod == b or mod.startswith(b + ".") for b in banned_mods
        ), (path, mod)


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        port_rem.align_genomes(["a.fa", "b.fa"], device="cuda")


def _three_fastas(tmp_path):
    rng = np.random.default_rng(17)
    c1 = "".join(rng.choice(list("ACGT"), size=900))
    c2 = "".join(rng.choice(list("ACGT"), size=700))
    fa = [str(tmp_path / ("g%d.fa" % i)) for i in range(3)]
    fasta_writer(fa[0], [("x1", c1)])
    fasta_writer(fa[1], [("y1", c1[:800] + c2[:50])])
    fasta_writer(fa[2], [("z1", c1), ("z2", c2)])
    return fa


def test_uncovered_inputs_raise(tmp_path):
    """Nothing is left uncovered here (the name is from when something
    was): the distributed suffix-array build (``--backend jax-dist``,
    once item 9) builds the root over a world of one on the route's
    device and writes the JAX package's ``backend="jax-dist"`` bytes,
    as the device doubling build (``--backend jax``, once item 4) writes
    its ``backend="jax"`` bytes.  The serial host engine
    (no ``--frontier``, once item 10) runs as in the reference
    (tests/test_torch_align.py), and graph inputs, multi-contig pairs and
    ``--notrim`` take the per-level frontier
    (tests/test_torch_frontier_routes.py)."""
    fa = _three_fastas(tmp_path)
    G, idx = jax_rem.align_genomes(fa[:2], backend="jax-dist")
    want = jax_gfa(G, idx, str(tmp_path / "jax_dist.gfa"))
    G, idx = port_rem.align_genomes(fa[:2], device="cpu", backend="jax-dist")
    got = port_rem.write_rem_gfa(G, idx, str(tmp_path / "port_dist.gfa"))
    assert got == want
    G, idx = jax_rem.align_genomes(fa[:2], backend="jax")
    want = jax_gfa(G, idx, str(tmp_path / "jax.gfa"))
    G, idx = port_rem.align_genomes(fa[:2], device="cpu", backend="jax")
    assert port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa")) == want
    with pytest.raises(ValueError):
        port_rem.align_genomes(fa[:1], device="cpu")


def test_three_fastas_match_the_host_engine(tmp_path):
    """Three samples, one of two contigs (once uncovered, item 6): the
    multi-genome loop on the CPU writes the host engine's GFA."""
    from reveal_tpu_torch.index import devloop_multi

    fa = _three_fastas(tmp_path)
    G, idx = jax_rem.align_genomes(fa, backend="auto")
    host = jax_gfa(G, idx, str(tmp_path / "host.gfa"))
    G, idx = port_rem.align_genomes(fa, device="cpu")
    st = dict(devloop_multi.LAST_STATS)
    assert st["abort"] == 0 and st["fallback"] is None and st["paths"] == 4
    assert port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa")) == host


def test_cli_flags_match_the_reveal_tpu_cli(tmp_path):
    """Non-default -m, -n, --maxmums, --wscore, --wpen and --pcutoff
    reach the pairwise route: the port's GFA equals ``python -m
    reveal_tpu.cli rem --frontier``'s with the same flags, and differs
    from the default one.  --seedsize, --gcmodel, --maxsize, --notrim and
    --multi reach the per-level frontier: the port's GFA equals the
    reference CLI's serial host engine's (``rem`` without ``--frontier``)
    with the same flags."""
    import reveal_tpu.cli as jax_cli
    from reveal_tpu_torch import cli as port_cli
    from reveal_tpu_torch.index import devfrontier

    fastas = write_population(tmp_path, 2, 30_000, 11)
    flags = ["-m", "16", "-n", "2", "--maxmums", "10", "--wscore", "2",
             "--wpen", "3", "--pcutoff", "1e-6"]
    frontier_flags = ["--seedsize", "30", "--gcmodel", "star-avg",
                      "--maxsize", "5000", "--maxbubblesize", "4000",
                      "--notrim", "--multi"]
    out = {}
    for name, argv, main in (
            ("ref", ["--frontier", *flags], jax_cli.main),
            ("port", ["--frontier", "--device", "cpu", *flags],
             port_cli.main),
            ("default", ["--device", "cpu"], port_cli.main),
            ("port_frontier", ["--device", "cpu", *frontier_flags],
             port_cli.main),
            ("ref_frontier", frontier_flags, jax_cli.main)):
        if name == "port_frontier":
            assert devloop.LAST_STATS["abort"] == 0
            devfrontier.LAST_STATS.clear()
        if name == "ref_frontier":
            assert devfrontier.LAST_STATS["levels"] > 1
        fn = str(tmp_path / (name + ".gfa"))
        main(["rem", *fastas, *argv, "-o", fn])
        with open(fn, "rb") as fh:
            out[name] = fh.read()
    assert out["port"] == out["ref"]
    assert out["port"] != out["default"]
    assert out["port_frontier"] == out["ref_frontier"]
    assert out["port_frontier"] != out["default"]


def test_kernel_abort_falls_back_to_host_engine(tmp_path, monkeypatch):
    """On the CPU device a non-retryable abort code (here
    ABORT_LEVEL_OVERFLOW, forced by a one-level cap) makes the forest and
    then the single-root loop decline, and the per-level frontier
    finishes the pair with the host engine's node state and text, both
    codes recorded and the serial host engine never called (the name is
    from when it finished on the host engine)."""
    fastas = write_population(tmp_path, 2, 20_000, 5)
    G, idx = jax_rem.align_genomes(fastas, backend="auto")
    want_state, want_T = port_rem.node_state(G), idx.main.T.copy()
    monkeypatch.setattr(devloop, "_LMAX", 1)
    monkeypatch.setattr(port_rem, "_align_loop", _refused)
    G, idx = port_rem.align_genomes(fastas, device="cpu")
    st = dict(devloop.LAST_STATS)
    assert st["abort"] == jax_devloop.ABORT_LEVEL_OVERFLOW, st
    code = "kernel abort code 5 (ABORT_LEVEL_OVERFLOW)"
    assert st["fallback"] == "forest: %s; single-root loop: %s" % (code,
                                                                   code)
    assert devfrontier.LAST_STATS["fallback"] == st["fallback"]
    assert port_rem.node_state(G) == want_state
    np.testing.assert_array_equal(idx.main.T, want_T)


def _refused(*_a, **_k):
    raise AssertionError("the serial host engine ran")


def _forest_aborts(*_a, **_k):
    devloop.LAST_STATS.clear()
    devloop.LAST_STATS["abort"] = jax_devloop.ABORT_DUP_REF
    return None


@pytest.mark.parametrize("stage", ["forest", "prefix"])
def test_declined_input_raises_on_cuda(tmp_path, monkeypatch, stage):
    """On a CUDA device a forest abort code or a host prefix that cannot
    defer sends the pair to the single-root loop on the same device,
    which finishes it with the host engine's GFA: no error, the decline
    named in ``LAST_STATS["fallback"]``, the serial host engine never
    called (the name is from when such inputs raised).  The card is
    stood in for: the forest (or the prefix) declines before any tensor
    moves, and the loop, which records the device it was given, runs on
    the CPU."""
    import reveal_tpu_torch.native as native

    fastas = write_population(tmp_path, 2, 20_000, 5)
    G, idx = jax_rem.align_genomes(fastas, backend="auto")
    host = jax_gfa(G, idx, str(tmp_path / "host.gfa"))
    monkeypatch.setattr(port_rem, "resolve_device",
                        lambda _d: torch.device("cuda"))
    routes = []
    if stage == "forest":
        def forest(*a, **k):
            routes.append(("forest", k["device"].type))
            return _forest_aborts()

        monkeypatch.setattr(devloop, "rem_device_forest", forest)
        why = "forest: kernel abort code 4 (ABORT_DUP_REF)"
    else:
        monkeypatch.setattr(native, "rem2_defer_native",
                            lambda *_a, **_k: routes.append(("prefix",)))
        why = "forest: host prefix pick deferred"
    loop = devloop.rem_device_loop

    def on_the_cpu(*a, device):
        routes.append(("loop", device.type))
        return loop(*a, device=torch.device("cpu"))

    monkeypatch.setattr(devloop, "rem_device_loop", on_the_cpu)
    monkeypatch.setattr(port_rem, "_align_loop", _refused)
    G, idx = port_rem.align_genomes(fastas, device="cuda")
    assert routes == [("forest", "cuda") if stage == "forest" else
                      ("prefix",), ("loop", "cuda")]
    assert devloop.LAST_STATS["fallback"] == why
    assert devloop.LAST_STATS["abort"] == 0
    assert port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa")) == host
