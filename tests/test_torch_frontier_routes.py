"""The inputs that take the torch port's per-level frontier, end to end.

Each case runs three ways on the same numpy-seeded input: the JAX
package's serial host engine (``align_genomes(..., frontier=False)``, the
serial LIFO recursion whose GFA is the port's target), the port's
``align_genomes(device="cpu")`` by its own routing, and the port's
frontier forced (``_align_loop_frontier``).  Both port runs build the host
engine's node state (intervals, offsets, aligned flags) and text and
write its GFA byte for byte: the frontier replays its graph surgery in
the serial pop order, so its node numbering is the serial engine's.  (The
JAX package's ``DeviceFrontier`` numbers the nodes in its own level
order, so it is no oracle for the bytes.)
"""

import numpy as np
import pytest
import torch

import reveal_tpu.align.rem as jax_rem
from reveal_tpu.core.io_fasta import fasta_writer
from reveal_tpu_torch.align import rem as port_rem
from reveal_tpu_torch.align.rem import node_state
from reveal_tpu_torch.index import devfrontier, devloop, devloop_multi
from torch_support import (four_genomes, jax_gfa, multicontig_pair,
                           repetitive_pair, write_bubble_chain,
                           write_population)

CPU = torch.device("cpu")


def _forced(files, multi=False, **cfg):
    ts, t, G, root_nodes = port_rem._read_inputs(files, multi)
    idx = port_rem.ESAIndex.construct(ts, backend="native")
    idx.nodes = root_nodes
    port_rem._align_loop_frontier(G, t, idx, port_rem.PickerConfig(**cfg),
                                  CPU)
    return G, idx


def hold(files, tmp_path, multi=False, **cfg):
    """The three runs of the module docstring; returns the frontier's
    ``LAST_STATS`` after the port's own route (empty when the route was
    not the frontier)."""
    G, idx = jax_rem.align_genomes(files, backend="auto", multi=multi,
                                   **cfg)
    host_state, host_T = node_state(G), idx.main.T.copy()
    want = jax_gfa(G, idx, str(tmp_path / "host.gfa"))

    devfrontier.LAST_STATS.clear()
    G, idx = port_rem.align_genomes(files, device="cpu", multi=multi, **cfg)
    stats = dict(devfrontier.LAST_STATS)
    assert node_state(G) == host_state
    np.testing.assert_array_equal(idx.main.T, host_T)
    port = port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa"))
    if stats:
        assert stats["levels"] > 1
        assert stats["order_seconds"] > 0
    assert port == want

    G, idx = _forced(files, multi, **cfg)
    np.testing.assert_array_equal(idx.main.T, host_T)
    assert port_rem.write_rem_gfa(G, idx, str(tmp_path / "forced.gfa")) == want
    return stats


def test_frontier_pair(tmp_path):
    """tests/test_frontier.py's pair: one sequence a sample, so the
    port's route is the host prefix and forest; the forced frontier
    writes the serial engine's GFA too."""
    rng = np.random.default_rng(2)
    base = "".join(rng.choice(list("ACGT"), size=4000))
    mut = list(base)
    for _ in range(40):
        i = int(rng.integers(0, len(mut)))
        if rng.random() < 0.5:
            mut[i] = "ACGT"[int(rng.integers(0, 4))]
        else:
            del mut[i]
    fa = [str(tmp_path / "a.fa"), str(tmp_path / "b.fa")]
    fasta_writer(fa[0], [("a", base)])
    fasta_writer(fa[1], [("b", "".join(mut))])
    assert not hold(fa, tmp_path)


def six_genomes(tmp_path):
    """Six genomes of 6 kbp: at ``maxmums=30`` the root holds more
    candidates than that, as the six-genome panel's root does past about
    100 kbp at the default 10,000, and the frontier's level order differs
    from the serial pop order."""
    return write_population(tmp_path, 6, 6_000, 4)


@pytest.mark.parametrize("make,cfg,route", [
    (multicontig_pair, {}, True),
    (repetitive_pair, {"minlength": 15}, False),
    (four_genomes, {}, False),
    (four_genomes, {"maxmums": 30}, True),
    (six_genomes, {"maxmums": 30}, True),
], ids=["multicontig-pair", "repetitive-pair-m15", "four-genomes",
        "four-genomes-maxmums30", "six-genomes-maxmums30"])
def test_frontier_inputs(make, cfg, route, tmp_path):
    """tests/test_frontier.py's inputs and six genomes; at ``maxmums=30``
    the multi loop declines at the root (ABORT_MAXMUMS) and the frontier
    finishes the input with the serial engine's GFA."""
    stats = hold(make(tmp_path), tmp_path, **cfg)
    assert bool(stats) == route
    if cfg.get("maxmums"):
        assert "ABORT_MAXMUMS" in devloop_multi.LAST_STATS["fallback"]
        assert stats["fallback"] == devloop_multi.LAST_STATS["fallback"]


def test_nine_paths(tmp_path):
    """Eight genomes, one of two contigs: nine paths, past the multi
    loop's eight, take the frontier."""
    fastas = write_population(tmp_path, 8, 3000, 10, split=3)
    assert "not eligible" in hold(fastas, tmp_path)["fallback"]


@pytest.mark.parametrize("cfg", [
    {"seedsize": 40}, {"gcmodel": "star-avg"}, {"maxsize": 200},
], ids=["seedsize40", "gcmodel-star-avg", "maxsize200"])
def test_picking_options_take_the_frontier(cfg, tmp_path):
    """Seeding, a gap-cost model and a size gate: not forest inputs."""
    stats = hold(write_population(tmp_path, 2, 20_000, 5), tmp_path, **cfg)
    assert stats and stats["fallback"] is None


def test_notrim_is_honoured(tmp_path):
    """``--notrim`` on a plain pair takes the frontier and keeps the
    untrimmed result: the JAX host engine's node state and GFA with
    ``trim=False``.  (The JAX ``frontier=True`` route gives the trimmed
    result there: its single-root loop always trims.)"""
    fastas = write_population(tmp_path, 2, 20_000, 5)
    assert hold(fastas, tmp_path, trim=False)
    G, _idx = jax_rem.align_genomes(fastas, backend="auto")
    trimmed = node_state(G)
    G, _idx = port_rem.align_genomes(fastas, device="cpu", trim=False)
    assert node_state(G) != trimmed


@pytest.mark.parametrize("multi", [False, True], ids=["digraph", "multi"])
def test_gfa_and_fasta_inputs(tmp_path, multi):
    """A three-path bubble chain as ``.gfa`` beside a fasta of one of its
    paths, mutated: graph inputs take the frontier, in either graph mode
    (``--multi``: the parallel-edge graph)."""
    gfa = str(tmp_path / "chain.gfa")
    want = write_bubble_chain(gfa, seed=4, n_small=3, small=80,
                              n_big=1, big=150, npaths=3)
    rng = np.random.default_rng(3)
    seq = list(want[sorted(want)[0]])
    for _ in range(5):
        seq[int(rng.integers(0, len(seq)))] = "ACGT"[int(rng.integers(0, 4))]
    fa = str(tmp_path / "x.fa")
    fasta_writer(fa, [("x", "".join(seq))])
    assert hold([gfa, fa], tmp_path, multi=multi)


def test_forest_declines_keep_their_route(tmp_path, monkeypatch):
    """A pairwise forest decline takes the reference's route on the
    device given: the forest, then the single-root loop, then (when the
    loop declines too) the per-level frontier, which finishes with the
    host engine's node state and text; no route raises or reaches the
    serial host engine.  The card is stood in for: the forest and the
    loop decline before any tensor moves, and the frontier, which checks
    the device it was given, runs on the CPU."""
    fastas = write_population(tmp_path, 2, 20_000, 5)
    G, idx = jax_rem.align_genomes(fastas, backend="auto")
    want_state, want_T = node_state(G), idx.main.T.copy()
    monkeypatch.setattr(port_rem, "resolve_device",
                        lambda _d: torch.device("cuda"))
    routes = []

    def declines(route, code):
        def run(*_a, device, **_k):
            routes.append((route, device.type))
            devloop.LAST_STATS.clear()
            devloop.LAST_STATS["abort"] = code
        return run

    monkeypatch.setattr(devloop, "rem_device_forest",
                        declines("forest", devloop.ABORT_DUP_REF))
    monkeypatch.setattr(devloop, "rem_device_loop",
                        declines("loop", devloop.ABORT_CHAIN_ROUNDS))

    class OnTheCPU(devfrontier.DeviceFrontier):
        def __init__(self, T, SA, LCP, SO, nsep0, nsamples, device,
                     stats=None):
            routes.append(("frontier", torch.device(device).type))
            super().__init__(T, SA, LCP, SO, nsep0, nsamples, CPU, stats)

    def refused(*_a, **_k):
        raise AssertionError("the serial host engine ran")

    monkeypatch.setattr(devfrontier, "DeviceFrontier", OnTheCPU)
    monkeypatch.setattr(port_rem, "_align_loop", refused)
    devfrontier.LAST_STATS.clear()
    G, idx = port_rem.align_genomes(fastas, device="cuda")
    assert routes == [("forest", "cuda"), ("loop", "cuda"),
                      ("frontier", "cuda")]
    why = ("forest: kernel abort code 4 (ABORT_DUP_REF); single-root loop: "
           "kernel abort code 8 (ABORT_CHAIN_ROUNDS)")
    assert devloop.LAST_STATS["fallback"] == why
    assert devfrontier.LAST_STATS["fallback"] == why
    assert node_state(G) == want_state
    np.testing.assert_array_equal(idx.main.T, want_T)
