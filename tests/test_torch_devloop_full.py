"""The port's single-root device loop on the CPU, and the routes to it.

``rem_device_loop`` (reveal_tpu_torch/index/devloop.py) runs the whole
pairwise recursion from the root through the same level loop as the
forest, with the flat chain ``chain_flat``.  The same text, SA and LCP go
through the JAX package's ``rem_device_loop`` (JAX on the CPU) and the
port's (torch on the CPU): anchors in pop order, lowercased text, level
count and the JAX loop's counters must be equal exactly.  ``chain_flat``
is held against the host chain DP and ``largest`` pick, ``seg_max_scan``
and ``pop_order`` against the JAX package's.  The routes: the forest's
declines reach the single-root loop, the loop's declines the per-level
frontier, as in ``reveal_tpu``; no route reaches the serial host
engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reveal_tpu.align.rem as jax_rem
import reveal_tpu.index.devloop as jax_devloop
from reveal_tpu.align.chaining import chain as host_chain
from reveal_tpu.core.textstore import TextStore
from reveal_tpu.index.esa_index import ESAIndex
from reveal_tpu.utils.simulate import simulate_population
from reveal_tpu_torch.align import rem as port_rem
from reveal_tpu_torch.align.rem import node_state
from reveal_tpu_torch.index import devfrontier, devloop
from torch_support import devloop_case, jax_gfa, write_population

CPU = torch.device("cpu")
# the JAX loop's LAST_STATS keys
STAT_KEYS = ("levels", "dispatches", "anchors", "abort", "trim_steps",
             "chain_steps", "repair_steps")


def _esa(seqa, seqb):
    ts = TextStore()
    for name, seq in (("a", seqa), ("b", seqb)):
        ts.add_sample(name)
        ts.add_sequence(seq)
    idx = ESAIndex.construct(ts, backend="native")
    return idx.main.T.copy(), idx.SA, idx.LCP, int(idx.main.nsep[0])


def _inputs(name):
    if name == "population-20000":
        pop = simulate_population(2, 20_000, seed=1)
        return pop[0][1], pop[1][1], 20
    return devloop_case(name)


def _both(name, maxmums=10000):
    seqa, seqb, minl = _inputs(name)
    T, SA, LCP, nsep0 = _esa(seqa, seqb)
    ref = jax_devloop.rem_device_loop(T.copy(), SA, LCP, nsep0, minl,
                                      maxmums, 1, 1)
    ref_stats = dict(jax_devloop.LAST_STATS)
    got = devloop.rem_device_loop(T.copy(), SA, LCP, nsep0, minl, maxmums,
                                  1, 1, device=CPU)
    return ref, ref_stats, got, dict(devloop.LAST_STATS)


@pytest.mark.parametrize("name", [
    "fuzz-3-2000-25", "fuzz-7-5000-60", "identical", "no_matches",
    "population-20000", "repetitive-19",
])
def test_single_root_loop_matches_jax(name):
    ref, ref_stats, got, stats = _both(name)
    assert ref is not None and got is not None
    (ranch, rT, rlev), (ganch, gT, glev) = ref, got
    assert glev == rlev
    np.testing.assert_array_equal(gT, rT)
    np.testing.assert_array_equal(ganch, ranch)
    assert {k: stats[k] for k in STAT_KEYS} == ref_stats
    assert stats["abort"] == 0 and stats["repair_launches"] == 0
    if name == "population-20000":
        assert (stats["levels"], stats["anchors"], stats["chain_steps"],
                stats["repair_steps"]) == (15, 176, 52, 65)
    if name == "repetitive-19":
        # capacity retries ran; every dispatch's repair rounds count
        assert stats["dispatches"] > 1
        assert stats["repair_rounds_total"] > stats["repair_steps"]


def test_round_cap_aborts_like_jax(monkeypatch):
    """With the wavefront's round cap forced to 3, the root's chain does
    not finish: both loops abort with ABORT_CHAIN_ROUNDS at level 0 with
    equal counters."""
    monkeypatch.setattr(jax_devloop, "_RMAX", 3)
    monkeypatch.setattr(jax_devloop, "_kern_cache", {})
    monkeypatch.setattr(devloop, "_RMAX", 3)
    ref, ref_stats, got, stats = _both("fuzz-7-5000-60")
    assert ref is None and got is None
    assert ref_stats["abort"] == devloop.ABORT_CHAIN_ROUNDS
    assert ref_stats["levels"] == 1
    assert {k: stats[k] for k in STAT_KEYS} == ref_stats


def test_maxmums_abort_matches_jax():
    """176 root candidates against --maxmums 50: ABORT_MAXMUMS at level
    0 in both loops, with equal counters."""
    ref, ref_stats, got, stats = _both("population-20000", maxmums=50)
    assert ref is None and got is None
    assert ref_stats["abort"] == devloop.ABORT_MAXMUMS
    assert {k: stats[k] for k in STAT_KEYS} == ref_stats


# ----------------------------------------------------------------------
# the stages against the host chain and the JAX package's functions
# ----------------------------------------------------------------------
def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _segments(rng, nseg, K, SMAX):
    """Random live segments and their candidates (seg, l, a, b) as the
    chain sees them after trim: distinct a per segment, ties in l and in
    scores; one segment with one candidate and one with none."""
    seg_tab = np.zeros((SMAX, 8), np.int32)
    rows = []
    a0 = 1
    for s in range(nseg):
        wa = int(rng.integers(200, 3000))
        b0 = a0 + 50_000
        seg_tab[s, :4] = (a0, a0 + wa, b0, b0 + wa + int(rng.integers(-40, 40)))
        m = {0: 0, 1: 1}.get(s, min(int(rng.integers(2, 700)), wa // 2))
        aa = np.sort(rng.choice(np.arange(a0, a0 + wa - 30), size=m,
                                replace=False))
        for a in aa:
            l = int(rng.choice([5, 8, 12, 20])) if rng.random() < 0.7 else \
                int(rng.integers(1, 30))
            b = b0 + (a - a0) + int(rng.integers(-6, 7))
            b = min(max(b, seg_tab[s, 2]), seg_tab[s, 3] - l)
            if a + l <= seg_tab[s, 1] and b >= seg_tab[s, 2]:
                rows.append((s, l, int(a), int(b)))
        a0 += wa + 100
    rows = [rows[i] for i in rng.permutation(len(rows))]
    cand = np.zeros((4, K), np.int32)
    cand[0] = devloop.BIG
    for i, r in enumerate(rows):
        cand[:, i] = r
    return cand, seg_tab, rows


def _host_pick(rows, seg_tab, s, ws, wp):
    mums = [(l, 2, {0: a, 1: b}) for ss, l, a, b in rows if ss == s]
    if not mums:
        return None
    if len(mums) == 1:
        pick = mums[0]
    else:
        left = (0, 0, {0: int(seg_tab[s, 0]) - 1, 1: int(seg_tab[s, 2]) - 1})
        right = (0, 0, {0: int(seg_tab[s, 1]), 1: int(seg_tab[s, 3])})
        chained = host_chain(mums, left, right, wscore=ws, wpen=wp)[::-1]
        if not chained:
            return None
        pick = sorted(chained, key=lambda m: m[0][0])[-1][0]
    return pick[0], pick[2][0], pick[2][1]


@pytest.mark.parametrize("seed,ws,wp", [(0, 1, 1), (1, 1, 1), (2, 3, 2)])
def test_chain_flat_matches_the_host_picker(seed, ws, wp):
    """Every segment's pick equals the host chain DP's ``largest`` pick
    (schemes.py:20-104, 298-301), over rows that span two chunks of the
    candidate x candidate passes; the dense chain agrees."""
    rng = np.random.default_rng(seed)
    K, SMAX, nseg = 4096, 16, 9
    cand, seg_tab, rows = _segments(rng, nseg, K, SMAX)
    assert len(rows) > 1024  # the live rows fill more than a chunk
    seg_live = torch.arange(SMAX) < nseg
    abort = torch.zeros((), dtype=torch.int32)
    args = (*(_t(c) for c in cand), _t(seg_tab), seg_live, abort, ws, wp)
    picked, s_l, s_ma, s_mb, ab, rounds = devloop.chain_flat(*args)
    assert int(ab) == 0 and rounds > 1
    for s in range(nseg):
        want = _host_pick(rows, seg_tab, s, ws, wp)
        got = ((int(s_l[s]), int(s_ma[s]), int(s_mb[s]))
               if bool(picked[s]) else None)
        assert got == want, s
    assert not picked[nseg:].any()
    dense = devloop.chain_dense(*args, 1024)
    for x, y in zip((picked, s_l, s_ma, s_mb), dense[:4]):
        assert torch.equal(x, y)


def test_chain_flat_aborts_on_a_duplicate_ref_start():
    rng = np.random.default_rng(5)
    cand, seg_tab, rows = _segments(rng, 3, 4096, 16)
    i = next(k for k, r in enumerate(rows) if r[0] == 2)
    j = next(k for k, r in enumerate(rows) if r[0] == 2 and k != i)
    cand[2, j] = cand[2, i]
    seg_live = torch.arange(16) < 3
    out = devloop.chain_flat(*(_t(c) for c in cand), _t(seg_tab), seg_live,
                             torch.zeros((), dtype=torch.int32), 1, 1)
    assert int(out[4]) == devloop.ABORT_DUP_REF


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_seg_max_scan_matches_jax(n):
    """The JAX kernel's ``seg_max_scan`` (devloop.py:251) over the same
    values and resets."""
    rng = np.random.default_rng(n)
    v = rng.integers(-(2**31) + 1, 2**31 - 1, size=n).astype(np.int32)
    f = rng.random(n) < 0.2

    def combine(x, y):
        m1, f1 = x
        m2, f2 = y
        return jnp.where(f2, m2, jnp.maximum(m1, m2)), f1 | f2

    want, _ = jax.lax.associative_scan(combine, (jnp.asarray(v),
                                                 jnp.asarray(f)))
    got = devloop.seg_max_scan(_t(v), _t(f))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_pop_order_matches_jax(seed):
    rng = np.random.default_rng(seed)
    A = int(rng.integers(1, 200))
    parents = np.full(A, -1, np.int64)
    cls = np.zeros(A, np.int64)
    free = [(0, 1), (0, 2)]
    for i in range(1, A):
        p, c = free.pop(int(rng.integers(0, len(free))))
        parents[i], cls[i] = p, c
        free += [(i, 1), (i, 2)]
    perm = rng.permutation(A)
    inv = np.argsort(perm)
    parents = np.where(parents[perm] >= 0, inv[parents[perm]], -1)
    cls = cls[perm]
    np.testing.assert_array_equal(devloop.pop_order(parents, cls),
                                  jax_devloop.pop_order(parents, cls))


# ----------------------------------------------------------------------
# the routes
# ----------------------------------------------------------------------
def _no_forest(monkeypatch):
    """Both packages' host prefix and forest decline before they run (a
    stand-in: no input property is known to make them decline), so the
    single-root loop takes the pair."""
    def declines(*_a, **_k):
        devloop.LAST_STATS["fallback"] = "stood in"

    monkeypatch.setattr(jax_rem, "_rem_device_hybrid", lambda *_a: None)
    monkeypatch.setattr(port_rem, "_rem_device_hybrid", declines)


def test_mode_full_matches_the_jax_route(tmp_path, monkeypatch):
    """The host prefix and forest stood in to decline: the single-root
    loop takes the 20 kbp pair whole, and the GFA is the JAX
    ``frontier=True`` route's with the same stand-in (the name is from
    when an environment switch skipped the forest)."""
    fastas = write_population(tmp_path, 2, 20_000, 1)
    _no_forest(monkeypatch)
    G, idx = jax_rem.align_genomes(fastas, backend="auto", frontier=True)
    want = jax_gfa(G, idx, str(tmp_path / "jax.gfa"))
    G, idx = port_rem.align_genomes(fastas, device="cpu")
    st = dict(devloop.LAST_STATS)
    assert st["abort"] == 0 and st["fallback"] == "forest: stood in"
    assert "forest" not in st and st["levels"] == 15
    assert port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa")) == want


def test_loop_abort_takes_the_frontier(tmp_path, monkeypatch):
    """The forest stood in to decline, with ``--maxmums 50``: the 176
    root candidates abort the loop (ABORT_MAXMUMS) and the per-level
    frontier takes the pair: the GFA of the JAX route with the same
    stand-in, the node state and text of the JAX host engine at maxmums
    50, the serial host engine never called."""
    fastas = write_population(tmp_path, 2, 20_000, 1)
    G, idx = jax_rem.align_genomes(fastas, backend="auto", maxmums=50)
    host_state, host_T = node_state(G), idx.main.T.copy()
    _no_forest(monkeypatch)
    G, idx = jax_rem.align_genomes(fastas, backend="auto", frontier=True,
                                   maxmums=50)
    want = jax_gfa(G, idx, str(tmp_path / "jax.gfa"))
    monkeypatch.setattr(port_rem, "_align_loop", _refused)
    G, idx = port_rem.align_genomes(fastas, device="cpu", maxmums=50)
    why = ("forest: stood in; single-root loop: kernel abort code 7 "
           "(ABORT_MAXMUMS)")
    assert devloop.LAST_STATS["fallback"] == why
    assert devfrontier.LAST_STATS["fallback"] == why
    assert devfrontier.LAST_STATS["levels"] > 1
    assert node_state(G) == host_state
    np.testing.assert_array_equal(idx.main.T, host_T)
    assert port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa")) == want


def _refused(*_a, **_k):
    raise AssertionError("the serial host engine ran")


def test_forest_decline_takes_the_single_root_loop(tmp_path, monkeypatch):
    """A forest abort (ABORT_DUP_REF, stood in) sends the pair to the
    single-root loop on the same device: the host engine's GFA, the
    forest's abort named in ``LAST_STATS["fallback"]``."""
    fastas = write_population(tmp_path, 2, 20_000, 5)
    G, idx = jax_rem.align_genomes(fastas, backend="auto")
    want = jax_gfa(G, idx, str(tmp_path / "host.gfa"))

    def aborts(*_a, **_k):
        devloop.LAST_STATS.clear()
        devloop.LAST_STATS["abort"] = devloop.ABORT_DUP_REF
        return None

    monkeypatch.setattr(devloop, "rem_device_forest", aborts)
    monkeypatch.setattr(port_rem, "_align_loop", _refused)
    G, idx = port_rem.align_genomes(fastas, device="cpu")
    st = dict(devloop.LAST_STATS)
    assert st["fallback"] == "forest: kernel abort code 4 (ABORT_DUP_REF)"
    assert st["abort"] == 0 and st["levels"] > 1 and "loop_seconds" in st
    assert port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa")) == want
