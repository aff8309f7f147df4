"""The torch port's pair-HMM (plain versions, on the CPU) against the JAX
package's: the Pallas kernels in interpret mode, the float64 oracle and
the XLA row-scan; the posterior cut against the host's sparsify and MEA
DP; and the parameters carried across.

The same numpy-seeded sequences go through both packages.  Tolerances:
the port's plain DP follows the Pallas kernels' formulas (same lse
guards, same doubling scan), so posteriors agree to float32 rounding
(1e-4, totals 1e-3); against float64 and against the row-scan's
different float32 formulation the gates are those of
tests_tpu/test_pallas_hw.py (2e-3 posteriors, 5e-2 totals).
"""

import numpy as np
import pytest
import torch

import reveal_tpu.hmm.msa as jax_msa
import reveal_tpu.hmm.pairhmm as jax_pairhmm
import reveal_tpu.hmm.pallas_pairhmm as jax_pallas
from reveal_tpu_torch.hmm import msa as port_msa
from reveal_tpu_torch.hmm import pairhmm as port_pairhmm
from reveal_tpu_torch.hmm import pairhmm_dp as dp

torch.set_num_threads(2)


def _seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), size=n))


def _mutate(rng, s, rate=0.12):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate:
            out.append(str(rng.choice(list("ACGT"))))
        elif r < rate + 0.02:
            continue
        elif r < rate + 0.04:
            out.append(ch + str(rng.choice(list("ACGT"))))
        else:
            out.append(ch)
    return "".join(out) or "A"


def _pairs8():
    """B = 8, lengths 1..60 mixed, with N, lowercase and a padded entry
    (the batch padding of the JAX package: the pair "A", "A")."""
    rng = np.random.default_rng(11)
    a = _seq(rng, 60)
    b = _seq(rng, 41)
    c = _seq(rng, 33)
    return [
        (a, _mutate(rng, a)[:64]),
        (b[:20] + "NN" + b[22:], _mutate(rng, b)),
        (c.lower(), _mutate(rng, c)),
        ("A", "ACGTTGCA"),
        ("ACGTACGTAC", "C"),
        (_seq(rng, 17), _seq(rng, 52)),
        (b[:30], b[:12].lower() + "N" + b[13:30]),
        ("A", "A"),
    ]


def _padded(pairs, L1p, L2p):
    x = np.stack([port_pairhmm._pad_with_dummy(a.encode(), L1p - 1)
                  for a, _ in pairs])
    y = np.stack([port_pairhmm._pad_with_dummy(b.encode(), L2p - 1)
                  for _, b in pairs])
    lx = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    ly = np.array([len(b) for _, b in pairs], dtype=np.int32)
    return x, y, lx, ly


@pytest.fixture(scope="module")
def pallas_interpret():
    """The JAX package's Pallas posterior under the TPU interpret mode,
    on x, y, lx, ly numpy arrays."""
    from jax.experimental.pallas import tpu as pltpu

    fn = jax_pallas._get_pallas_kernels()

    def run(x, y, lx, ly):
        with pltpu.force_tpu_interpret_mode():
            p, tot = fn(x, y, lx, ly)
        return np.asarray(p), np.asarray(tot)

    return run


def test_posterior_batch_matches_pallas_interpret(pallas_interpret):
    pairs = _pairs8()
    x, y, lx, ly = _padded(pairs, 65, 128)
    pj, tj = pallas_interpret(x, y, lx, ly)
    pt, tt = dp.posterior_batch(*(torch.from_numpy(v) for v in
                                  (x, y, lx, ly)))
    assert pt.shape == pj.shape == (8, 65, 128)
    assert np.abs(pt.numpy() - pj).max() < 1e-4
    assert np.abs(tt.numpy() - tj).max() < 1e-3


def test_fwd_bwd_plain_grids_match_float64_dp():
    """The forward M grid with its row-lx snapshot and the backward grid
    in forward coordinates, cell by cell against the float64 scalar DP
    (the Pallas grids themselves stay inside the JAX package's jitted
    posterior; its posterior and total are held in the test above)."""
    pairs = _pairs8()
    params = port_pairhmm.default_params()
    x, y, lx, ly = (torch.from_numpy(v) for v in _padded(pairs, 65, 128))
    xcls, ycls = dp._prep(x, y)
    m, snap = dp.fwd_dp_plain(xcls, ycls, lx, params)
    xr, yr = dp._prep(dp._reverse_within(x, lx), dp._reverse_within(y, ly))
    g = dp.bwd_dp_plain(xr, yr, params)
    b0 = dp.flip_within(g, lx, ly)
    for k, (s1, s2) in enumerate(pairs):
        f64 = jax_pairhmm.forward_np(s1, s2)
        b64 = jax_pairhmm.backward_np(s1, s2)
        l1, l2 = len(s1), len(s2)
        real = f64[0] > jax_pairhmm.LOG_ZERO / 2
        got = m[k, : l1 + 1, : l2 + 1].numpy()
        assert np.abs(got[real] - f64[0][real]).max() < 1e-3
        assert (got[~real] <= jax_pairhmm.LOG_ZERO / 2).all()
        for s in range(5):
            assert abs(float(snap[k, s, l2]) - f64[s, l1, l2]) < 1e-3 or (
                f64[s, l1, l2] <= jax_pairhmm.LOG_ZERO / 2
                and float(snap[k, s, l2]) <= jax_pairhmm.LOG_ZERO / 2
            )
        gotb = b0[k, : l1 + 1, : l2 + 1].numpy()
        assert np.abs(gotb - b64[0]).max() < 1e-3


def test_wrappers_take_plain_path_on_cpu():
    pairs = _pairs8()[:3]
    params = port_pairhmm.default_params()
    x, y, lx, ly = (torch.from_numpy(v) for v in _padded(pairs, 65, 128))
    xcls, ycls = dp._prep(x, y)
    before = dict(dp.LAUNCHES)
    m_w, s_w = dp.fwd_dp(xcls, ycls, lx, params)
    m_p, s_p = dp.fwd_dp_plain(xcls, ycls, lx, params)
    assert torch.equal(m_w, m_p) and torch.equal(s_w, s_p)
    g_w = dp.bwd_dp(xcls, ycls, lx, ly, params)
    g_p = dp.flip_within(dp.bwd_dp_plain(xcls, ycls, params), lx, ly)
    assert torch.equal(g_w, g_p)
    assert dp.LAUNCHES == before  # CPU tensors launch nothing
    with pytest.raises(TypeError):
        dp.fwd_dp(xcls.int(), ycls, lx, params)
    with pytest.raises(TypeError):
        dp.fwd_dp(xcls, ycls, lx.long(), params)


@pytest.mark.parametrize("k", range(8))
def test_posterior_matches_float64_oracle(k):
    s1, s2 = _pairs8()[k]
    (p, tot), = dp.batch_posteriors_dp([(s1, s2)], "cpu")
    po, to = jax_pairhmm.posterior_oracle(s1, s2)
    assert p.shape == po.shape
    assert np.abs(p - po).max() < 2e-3
    assert abs(tot - to) < 1e-3


def test_posterior_matches_xla_row_scan_at_length_200():
    rng = np.random.default_rng(5)
    a = _seq(rng, 200)
    pairs = [(a, _mutate(rng, a)[:256]), (_seq(rng, 180), _seq(rng, 140))]
    res_j = jax_pairhmm.batch_posteriors(pairs)
    res_t = dp.batch_posteriors_dp(pairs, "cpu")
    for (pj, tj), (pt, tt) in zip(res_j, res_t):
        assert pj.shape == pt.shape
        assert np.abs(np.asarray(pj) - pt).max() < 2e-3
        assert abs(tj - tt) < 5e-2


def test_batch_posteriors_dp_matches_pallas_bucketing(pallas_interpret):
    """Pairs of two buckets in one call come back in input order, each
    equal to the Pallas result of its own bucket."""
    rng = np.random.default_rng(3)
    pairs = [(_seq(rng, 12), _seq(rng, 9)), (_seq(rng, 30), _seq(rng, 28)),
             (_seq(rng, 5), _seq(rng, 16))]
    res = dp.batch_posteriors_dp(pairs, "cpu")
    for (s1, s2), (p, tot) in zip(pairs, res):
        L1p, L2p = dp.bucket_key(s1, s2)
        assert (L1p, L2p) == (jax_pairhmm._bucket(len(s1)) + 1,
                              jax_pallas._round_up(
                                  jax_pairhmm._bucket(len(s2)) + 1, 128))
        batch = [(s1, s2)] + [("A", "A")] * 7
        pj, tj = pallas_interpret(*_padded(batch, L1p, L2p))
        assert np.abs(p - pj[0, : len(s1) + 1, : len(s2) + 1]).max() < 1e-4
        assert abs(tot - float(tj[0])) < 1e-3


def test_cut_matches_host_sparsify_and_mea():
    """Counts, survivors and MEA score of the port's cut against
    msa._sparsify and msa._mea_dp_fast of the same dense matrix."""
    rng = np.random.default_rng(9)
    a = _seq(rng, 90)
    pairs = [(a, _mutate(rng, a)[:128]), (_seq(rng, 70), _seq(rng, 100)),
             ("ACGT", "ACGT")]
    dense = dp.batch_posteriors_dp(pairs, "cpu")
    cut = port_msa.batch_posteriors_cut(pairs, device="cpu")
    for (p, tot), (sp, tot_c, score) in zip(dense, cut):
        want = jax_msa._sparsify(p)
        assert isinstance(sp, port_msa.SparsePost)
        assert np.array_equal(sp.dense(), want)
        assert np.array_equal(sp.cnt, (want > 0).sum(axis=1))
        assert sp.nnz == int((want > 0).sum())
        assert tot_c == tot
        ref = jax_msa._mea_dp_fast(p)[1]
        assert abs(score - ref) <= 1e-5 * max(1.0, abs(ref))


def test_cut_ladder_holds_a_diffuse_row():
    """More than 8 survivors in a row take the next step of the K
    ladder; the survivors stay exact."""
    p = torch.zeros((1, 3, 128))
    p[0, 1, 1:21] = 0.04
    p[0, 2, 5] = 0.5
    v, i, cnt, tot, scores = port_pairhmm.fetch_posteriors_compact(
        p, torch.zeros(1))
    assert v.shape[-1] == 32 and cnt[0].tolist() == [0, 20, 1]
    assert sorted(i[0, 1, :20].tolist()) == list(range(1, 21))
    assert i[0, 2, 0] == 5 and (i[0, 2, 1:] == 0).all()


def test_params_from_numpy_equals_default():
    got = port_pairhmm.params_from_numpy(
        jax_pairhmm.LOG_INIT, jax_pairhmm.LOG_TRANS,
        jax_pairhmm.LOG_EMIT_SINGLE, jax_pairhmm.LOG_EMIT_PAIRS)
    want = port_pairhmm.default_params()
    for name in ("init", "trans", "single", "pair", "packed"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert np.array_equal(got.single.numpy(), jax_pallas._CLS_SINGLE)
    assert np.array_equal(got.pair.numpy(), jax_pallas._CLS_PAIR)
    assert np.array_equal(dp._CLS.astype(np.int32), jax_pallas._CLS)
    assert np.array_equal(port_pairhmm.LOG_TRANS, jax_pairhmm.LOG_TRANS)
    assert got.packed.numel() == 102
