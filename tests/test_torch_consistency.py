"""The torch port's device consistency transform and stage-1+2 chain on
the CPU, against the JAX package's.

The same numpy-seeded sequences (and, where a function takes them, the
same dense posteriors) go through ``reveal_tpu.hmm.msa`` and the port's
``hmm/msa.py`` and ``hmm/mea_score.py``; the JAX package runs on
``JAX_PLATFORMS=cpu`` as ``tests/test_consistency_device.py`` runs it
(its chain takes the XLA row-scan posteriors there).  Tolerances:

- the MEA-score row scan is one float32 add a cell and maxima: the port's
  plain version equals the host ``_mea_dp_fast`` and the JAX chain's
  ``lax.scan`` bit for bit on the same posteriors;
- the relaxation rounds sum the same float32 products in another order
  (the port skips the einsum's identity and transposed blocks): values
  within 1e-5 of the JAX package's, the same sparsity except cells
  within 1e-4 of the 0.01 cutoff, and within 5e-3 of the host float64
  loop (the gate of ``tests_tpu/test_pallas_hw.py``);
- the chain's posteriors come from the port's plain DP and the JAX
  package's row-scan (float32 formulations that differ): distances
  within 1e-4;
- the refined GFAs of the slice are byte-identical.
"""

import numpy as np
import pytest
import torch

import reveal_tpu.hmm.msa as jax_msa
import reveal_tpu.hmm.refine as jax_refine
from reveal_tpu.align.graphops import prune_nodes as jax_prune_nodes
from reveal_tpu.core.io_gfa import read_gfa as jax_read_gfa
from reveal_tpu.core.io_gfa import write_gfa as jax_write_gfa
from reveal_tpu.graph.simplify import contract as jax_contract
from reveal_tpu_torch.align.graphops import prune_nodes
from reveal_tpu_torch.core.io_gfa import read_gfa, write_gfa
from reveal_tpu_torch.graph.extract import extract
from reveal_tpu_torch.graph.simplify import contract
from reveal_tpu_torch.hmm import mea_score as port_mea
from reveal_tpu_torch.hmm import msa as port_msa
from reveal_tpu_torch.hmm import pairhmm_dp as dp
from reveal_tpu_torch.hmm import refine as port_refine
from torch_support import refine_graphs

CUT = port_msa.POSTERIOR_CUTOFF


def _mutate(rng, seq, n=6):
    mut = list(seq)
    for _ in range(n):
        i = int(rng.integers(0, len(mut)))
        if rng.random() < 0.6:
            mut[i] = "ACGT"[int(rng.integers(0, 4))]
        else:
            del mut[i]
    return "".join(mut)


def _seqs(seed, n, L):
    """n sequences of about L bp: one ancestor, six edits each."""
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), size=L))
    return [_mutate(rng, base) for _ in range(n)]


def _pairs(seqs):
    n = len(seqs)
    return [(seqs[a], seqs[b]) for a in range(n) for b in range(a + 1, n)]


def _problem(seed, n, L):
    """(seqs, res): res the dense posteriors [(p, total), ...] of the a<b
    pairs, from the port's plain DP (both packages get these arrays)."""
    seqs = _seqs(seed, n, L)
    return seqs, dp.batch_posteriors_dp(_pairs(seqs), "cpu")


def _host_consistency(seqs, res, rounds, consgap):
    """probcons_align's host stage 2 in float64 (the loop of
    tests/test_consistency_device.py)."""
    N = len(seqs)
    keys = [(a, b) for a in range(N) for b in range(a + 1, N)]
    mats = {k: jax_msa._sparsify(np.asarray(p)) for k, (p, _t) in
            zip(keys, res)}
    for _ in range(rounds):
        new = {}
        for a, b in keys:
            P = mats[(a, b)]
            acc = 2.0 * P.astype(np.float64)
            for z in range(N):
                if z in (a, b):
                    continue
                Paz = mats[(a, z)] if a < z else mats[(z, a)].T
                Pzb = mats[(z, b)] if z < b else mats[(b, z)].T
                acc += Paz.astype(np.float64) @ Pzb.astype(np.float64)
                if consgap:
                    acc += np.outer(1.0 - Paz.sum(axis=1),
                                    1.0 - Pzb.sum(axis=0))
            acc /= N
            acc[P == 0] = 0
            new[(a, b)] = jax_msa._sparsify(acc.astype(np.float32))
        mats = new
    return mats


def _same_mats(got, ref, tol=1e-5, edge=1e-4):
    """Values within ``tol``; a cell may be cut on one side only where the
    other holds it within ``edge`` of the cutoff."""
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape and g.dtype == np.float32, k
        one_side = (g > 0) != (r > 0)
        assert (np.maximum(g, r)[one_side] < CUT + edge).all(), k
        d = np.abs(g - r)
        d[one_side] = 0.0
        assert d.max(initial=0.0) <= tol, (k, d.max())


# --------------------------------------------------------------------------
# (1) the MEA-score row scan
# --------------------------------------------------------------------------

def _chain_posteriors():
    """Dense posteriors (B * 3, 64, 64) of two three-sequence problems at
    the chain's bucket (Lq 64), with sequences of 1 bp and pairs far
    shorter than the longest."""
    probs = [["ACGTACGTTGCA" * 4, "ACGTACGATGCA" * 4 + "GG", "A"],
             ["TTGACCA", "TTGACGA" * 8, "C"]]
    pairs = [pr for seqs in probs for pr in _pairs(seqs)]
    Lq = 64
    x, y, lx, ly = dp.pack(pairs, Lq, Lq, "cpu")
    p, _tot = dp.posterior_batch(x, y, lx, ly)
    return probs, pairs, p


def test_mea_score_plain_equals_host_dp_and_jax_chain():
    probs, pairs, p = _chain_posteriors()
    nrows = max(len(a) for a, _ in pairs)
    got = port_mea.mea_score_plain(p, nrows).numpy()
    assert np.array_equal(got, port_mea.mea_score(p).numpy())
    # the JAX chain on the same dense posteriors (B = 2, N = 3, Lq = 64)
    _qp, scores = jax_msa._get_chain_fn(2, 3, 64, 0, False)(p.numpy())
    assert np.array_equal(got, np.asarray(scores).reshape(-1))
    for (a, b), s, full in zip(pairs, got, p.numpy()):
        ref = jax_msa._mea_dp_fast(
            np.ascontiguousarray(full[: len(a) + 1, : len(b) + 1]))[1]
        assert np.float32(ref) == s


@pytest.mark.parametrize("shape, nrows", [((5, 9, 1), 4), ((3, 7, 12), 3),
                                          ((4, 33, 40), 20), ((2, 1, 8), 0)])
def test_mea_score_plain_equals_host_dp_on_random_rows(shape, nrows):
    """Any non-negative rows (widths 1 to 40; rows beyond nrows zero, as
    a batch's shorter pairs leave them) give the host DP's score."""
    rng = np.random.default_rng(sum(shape))
    p = rng.random(shape).astype(np.float32)
    p[:, nrows + 1:] = 0.0
    p[:, 0] = 0.0
    got = port_mea.mea_score_plain(torch.from_numpy(p), nrows).numpy()
    for b in range(shape[0]):
        assert np.float32(jax_msa._mea_dp_fast(p[b])[1]) == got[b]
    assert np.array_equal(
        got, port_mea.mea_score_plain(torch.from_numpy(p)).numpy())


def test_mea_score_checks_its_input():
    with pytest.raises(TypeError):
        port_mea.mea_score(torch.zeros((2, 3, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        port_mea.mea_score(torch.zeros((2, 4, 3)).transpose(1, 2))


# --------------------------------------------------------------------------
# (2) the relaxation rounds and batch_consistency
# --------------------------------------------------------------------------

@pytest.mark.parametrize("consgap", [True, False])
def test_batch_consistency_matches_jax_and_host(consgap):
    problems = [_problem(s, n=4, L=50 + 10 * s) for s in range(3)]
    problems.append(_problem(7, n=2, L=30))
    problems.append(_problem(8, n=6, L=40))
    got = port_msa.batch_consistency(problems, consistency=2,
                                     consgap=consgap, device="cpu")
    ref = jax_msa.batch_consistency(problems, consistency=2,
                                    consgap=consgap)
    for (seqs, res), g, r in zip(problems, got, ref):
        _same_mats(g, r)
        _same_mats(g, _host_consistency(seqs, res, 2, consgap), tol=5e-3,
                   edge=5e-3)


def test_consistency_rounds_equal_the_full_einsum():
    """The a<b blocks with z outside {a, b} are the einsum over every z
    with the identity on the diagonal (the JAX package's form)."""
    rng = np.random.default_rng(3)
    B, N, L = 2, 5, 24
    Q = rng.random((B, N, N, L, L)).astype(np.float32) / L
    Q[Q < 0.02] = 0.0
    Q = (Q + Q.transpose(0, 2, 1, 4, 3)) / 2
    Q[:, np.arange(N), np.arange(N)] = np.eye(L, dtype=np.float32)
    for consgap in (False, True):
        ref = np.asarray(jax_msa._get_cons_fn(1, consgap)(Q))
        got = port_msa.consistency_rounds(torch.from_numpy(Q.copy()), 1,
                                          consgap).numpy()
        for a in range(N):
            for b in range(a + 1, N):
                _same_mats({0: got[:, a, b]}, {0: ref[:, a, b]})
                assert np.array_equal(got[:, b, a],
                                      got[:, a, b].transpose(0, 2, 1))
        assert np.array_equal(got[:, np.arange(N), np.arange(N)],
                              Q[:, np.arange(N), np.arange(N)])


# --------------------------------------------------------------------------
# (3) and (4) batch_stage12_device
# --------------------------------------------------------------------------

def test_batch_stage12_device_matches_jax_and_host():
    problems = [_seqs(s, n=3, L=40 + 8 * s) for s in range(3)]
    problems += [_seqs(5, n=5, L=70), _seqs(6, n=2, L=25)]
    got = port_msa.batch_stage12_device(problems, consistency=2,
                                        consgap=True, device="cpu")
    ref = jax_msa.batch_stage12_device(problems, consistency=2,
                                       consgap=True)
    for seqs, (mats, dist), (rmats, rdist) in zip(problems, got, ref):
        res = dp.batch_posteriors_dp(_pairs(seqs), "cpu")
        _same_mats(mats, _host_consistency(seqs, res, 2, True), tol=5e-3,
                   edge=5e-3)
        _same_mats(mats, rmats, tol=5e-3, edge=5e-3)
        assert dist.shape == rdist.shape == (len(seqs), len(seqs))
        assert np.abs(dist - rdist).max() < 1e-4
        for k, (a, b) in enumerate((a, b) for a in range(len(seqs))
                                   for b in range(a + 1, len(seqs))):
            score = port_msa._mea_dp_fast(res[k][0])[1]
            assert dist[a, b] == dist[b, a]
            assert abs(dist[a, b] - score / min(len(seqs[a]),
                                                len(seqs[b]))) < 1e-6


def test_stage12_fetch_compacts_wide_blocks(monkeypatch):
    """Above the dense transfer width the blocks come back as top-K rows
    and are densified on the host: the same matrices."""
    problems = [_seqs(9, n=3, L=50)]
    dense = port_msa.batch_stage12_device(problems, device="cpu")
    monkeypatch.setattr(port_msa, "SPARSE_TRANSFER_MIN_WIDTH", 32)
    compact = port_msa.batch_stage12_device(problems, device="cpu")
    for k in dense[0][0]:
        assert np.array_equal(dense[0][0][k], compact[0][0][k])
    assert np.array_equal(dense[0][1], compact[0][1])


def test_stage12_oversized_problem_isolated(monkeypatch):
    monkeypatch.setattr(port_msa, "CHAIN_BYTES_CAP", 4 * 64 * 64 * 4)
    problems = [["ACGTACGTAC", "ACGAACGTAC"], ["A" * 200, "C" * 195],
                ["ACGT"]]
    stats = {}
    out = port_msa.batch_stage12_device(problems, device="cpu", stats=stats)
    mats, dist = out[0]
    assert set(mats) == {(0, 1)} and dist.shape == (2, 2)
    assert out[1] is None
    assert out[2][0] == {} and out[2][1].shape == (1, 1)
    assert stats == {"batches": 1, "dp_batches": 1, "shapes": {(2, 32): 1}}
    assert port_msa.batch_consistency(
        [(problems[1], dp.batch_posteriors_dp(_pairs(problems[1]), "cpu"))],
        device="cpu") == [None]


def test_stage12_chunks_and_dp_batches(monkeypatch):
    """Chunks of CHUNK_BYTES, DP batches of pairhmm_dp.batch_size."""
    problems = [_seqs(s, n=3, L=20) for s in range(5)]
    monkeypatch.setattr(port_msa, "CHUNK_BYTES", 2 * 9 * 32 * 32 * 4)
    monkeypatch.setitem(dp.MAX_BATCH_CELLS, "cpu", 4 * 32 * 32)
    stats = {}
    got = port_msa.batch_stage12_device(problems, device="cpu",
                                        stats=stats)
    assert stats == {"batches": 3, "dp_batches": 2 + 2 + 1,
                     "shapes": {(3, 32): 5}}
    ref = port_msa.batch_stage12_device([problems[3]], device="cpu")
    for k in ref[0][0]:
        assert np.array_equal(got[3][0][k], ref[0][0][k])


# --------------------------------------------------------------------------
# (5) the slice: refine on the chain route against the JAX package's
# --------------------------------------------------------------------------

_SELECT = ("minsize", "mindiff", "maxdiff", "maxsize", "maxcumsize",
           "mincumsize", "complex_only", "simple_only", "nogaps")


def _jax_chain_refined(gfa, out, minlength=20, **kw):
    """The JAX package's chain route, composed from its own functions as
    reveal_tpu/hmm/refine.py:699-832 and :893- run it on an accelerator:
    the bubbles of refine_all's phase 1, batch_stage12_device for all of
    them, the two-phase route (batch_posteriors_cut, host stage 2) for
    those it returns None for, refine_bubble and replace_bubble in bubble
    order, then refine_cmd's prune, contract and write."""
    G = jax_read_gfa(gfa)
    sel = {k: kw.pop(k) for k in _SELECT if k in kw}
    sel.setdefault("minsize", minlength)
    kw.pop("nproc", None)
    nn = max((n for n in G.nodes if isinstance(n, int)), default=0) + 1
    work = []
    for bubble in jax_refine.select_realign_bubbles(G, **sel):
        G.nodes[bubble.source]["aligned"] = 1
        G.nodes[bubble.sink]["aligned"] = 1
        sg = G.subgraph(list(set(bubble.nodes) - {bubble.source,
                                                  bubble.sink}))
        src = G.nodes[bubble.source]
        offsets = {sid: src["offsets"][sid] + len(src["seq"])
                   for sid in src["offsets"]}
        paths = set(src["offsets"]) & set(G.nodes[bubble.sink]["offsets"])
        aobjs = jax_refine.prepare_bubble_alleles(
            sg, bubble, paths, uniqueonly=kw.get("uniqueonly", False))
        if aobjs is not None:
            work.append((bubble, sg, offsets, paths, aobjs))
    stage12 = jax_msa.batch_stage12_device(
        [[sq for _n, sq in w[4]] for w in work],
        consistency=kw.get("constrans", 2), consgap=kw.get("consgap", True))
    two_phase = [i for i, md in enumerate(stage12) if md is None]
    pairs = [pr for i in two_phase
             for pr in _pairs([sq for _n, sq in work[i][4]])]
    trip = iter(jax_msa.batch_posteriors_cut(pairs))
    for i, md in enumerate(stage12):
        bubble, sg, offsets, paths, aobjs = work[i]
        if md is None:
            t = [next(trip) for _ in _pairs(aobjs)]
            pre = dict(precomputed=[(p, tot) for p, tot, _ in t],
                       precomputed_scores=[s for _, _, s in t])
        else:
            pre = dict(precomputed_mats=md[0], precomputed_dist=md[1])
        res = jax_refine.refine_bubble(sg, bubble, offsets, paths,
                                       aobjs=aobjs, minlength=minlength,
                                       **pre, **kw)
        if res is not None:
            G, nn = jax_refine.replace_bubble(G, *res, nn)
    jax_prune_nodes(G)
    jax_contract(G, [n for n in G.topological_sort()
                     if not isinstance(n, str)])
    jax_write_gfa(G, None, outputfile=out)
    with open(out, "rb") as fh:
        return fh.read()


def _port_refined(gfa, out, **kw):
    G = port_refine.refine_all(read_gfa(gfa), device="cpu", **kw)
    prune_nodes(G)
    contract(G, [n for n in G.topological_sort() if not isinstance(n, str)])
    write_gfa(G, None, outputfile=out)
    with open(out, "rb") as fh:
        return fh.read()


@pytest.fixture
def jax_no_native(monkeypatch):
    """The JAX package's two-phase stage 1 through batch_posteriors_cut,
    not its native host pair-HMM."""
    monkeypatch.setattr(jax_msa, "NATIVE_POST_MAX_CELLS", 0)


@pytest.mark.parametrize("name",
                         ["region", "no_bubble", "region_nproc", "chain"])
def test_chain_route_refines_as_the_jax_chain(tmp_path, jax_no_native,
                                              name):
    gfa, kw, want = refine_graphs(tmp_path)[name]
    kw = dict(kw, consgap=False)
    ref = _jax_chain_refined(str(gfa), str(tmp_path / "jax.gfa"), **kw)
    got = _port_refined(str(gfa), str(tmp_path / "port.gfa"),
                        route="chain", **kw)
    assert got == ref
    st = port_refine.LAST_STATS
    if name == "no_bubble":
        return
    assert st["route"] == "chain"
    assert st["chain_bubbles"] == st["bubbles"] == st["refined"]
    assert st["pair_shapes"] == {} and st["chain_batches"] >= 1
    if want is not None:
        assert st["chain_shapes"] == {(6, 64): 3, (6, 128): 1}
        assert st["chain_batches"] == st["chain_dp_batches"] == 2
        G = read_gfa(str(tmp_path / "port.gfa"))
        for path, seq in want.items():
            assert extract(G, path).upper() == seq


def test_mixed_routes_refine_as_the_jax_chain(tmp_path, jax_no_native,
                                              monkeypatch):
    """The cap lowered so that the 110 bp bubble (Lq 128) takes the
    two-phase route in both packages and the three 45 bp bubbles (Lq 64)
    the chain; consgap on (refine_all's default)."""
    gfa, kw, want = refine_graphs(tmp_path)["chain"]
    cap = 36 * 64 * 64 * 4
    monkeypatch.setattr(jax_msa, "CHAIN_BYTES_CAP", cap)
    monkeypatch.setattr(port_msa, "CHAIN_BYTES_CAP", cap)
    ref = _jax_chain_refined(str(gfa), str(tmp_path / "jax.gfa"), **kw)
    got = _port_refined(str(gfa), str(tmp_path / "port.gfa"),
                        route="chain", **kw)
    assert got == ref
    st = port_refine.LAST_STATS
    assert st["chain_bubbles"] == 3 and st["bubbles"] == 4
    assert st["chain_shapes"] == {(6, 64): 3}
    assert sum(st["pair_shapes"].values()) == 15


def test_two_phase_route_on_the_cpu_by_default(tmp_path):
    gfa, kw, _ = refine_graphs(tmp_path)["region"]
    port_refine.refine_all(read_gfa(str(gfa)), device="cpu", **kw)
    st = port_refine.LAST_STATS
    assert st["route"] == "two-phase" and st["chain_bubbles"] == 0
    assert st["chain_batches"] == 0
    with pytest.raises(ValueError):
        port_refine.refine_all(read_gfa(str(gfa)), device="cpu",
                               route="other", **kw)
    with pytest.raises(ValueError):
        port_refine.refine_all(read_gfa(str(gfa)), route="chain",
                               stage1="native", **kw)


# --------------------------------------------------------------------------
# (6) no card, no CPU
# --------------------------------------------------------------------------

def test_chain_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_msa.batch_stage12_device([_seqs(1, 3, 30)], device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        port_msa.batch_consistency([_problem(1, 3, 30)], device="cuda")
    gfa, kw, _ = refine_graphs(tmp_path)["region"]
    with pytest.raises(RuntimeError, match="is_available"):
        port_refine.refine_all(read_gfa(str(gfa)), route="chain", **kw)
