"""The port's LOG_ADD lookup-table compat mode (reveal_tpu_torch/hmm/compat.py).

The cases of tests/test_compat.py on the port's copy, its posteriors held
to the JAX package's copy bit for bit, and the posterior and MSA cases of
tests/test_ref_golden_probcons.py on their checked-in fixtures (the
reference ProbCons binary's output).  The port's ``msa`` routes every
posterior through the copy in compat mode, on every device.
"""

import numpy as np
import pytest

import reveal_tpu.hmm.compat as jax_compat
from reveal_tpu_torch.hmm import msa
from reveal_tpu_torch.hmm.compat import (
    LOG_ZERO32,
    exp_compat,
    log_add_compat,
    lookup_compat,
    posterior_compat,
)
from reveal_tpu_torch.hmm.pairhmm import posterior_oracle
from test_ref_golden_probcons import (
    _gen_bubbles,
    _gen_pairs,
    _load_msas,
    _load_posteriors,
)
import torch_support  # noqa: F401  (the thread budget)


@pytest.fixture
def compat_mode():
    """The port's msa in compat mode for one test, switched off after."""
    msa.set_logadd_compat(True)
    yield
    msa.set_logadd_compat(False)


def test_lookup_approximates_log1pexp():
    """LOOKUP is a coarse polynomial fit of log(exp(x)+1); ScoreType.h
    tolerates ~1e-3 absolute error."""
    for x in np.linspace(0, 7.5, 200):
        got = float(lookup_compat(np.float32(x)))
        want = float(np.log1p(np.exp(x)))
        assert abs(got - want) < 2e-3, (x, got, want)


def test_exp_approximation_and_underflow():
    for x in np.linspace(-15.9, 0, 200):
        got = float(exp_compat(np.float32(x)))
        want = float(np.exp(x))
        assert abs(got - want) < 2e-3, (x, got, want)
    assert exp_compat(np.float32(-17)) == 0.0
    assert abs(float(exp_compat(np.float32(0.5))) - np.exp(0.5)) < 1e-6


def test_log_add_semantics():
    # LOG_ZERO short-circuits exactly (ScoreType.h:258-262)
    assert log_add_compat(LOG_ZERO32, np.float32(-3.0)) == np.float32(-3.0)
    assert log_add_compat(np.float32(-3.0), LOG_ZERO32) == np.float32(-3.0)
    # threshold shortcut: difference >= 7.5 returns the max verbatim
    assert log_add_compat(np.float32(-1.0), np.float32(-9.0)) == np.float32(
        -1.0
    )
    # interior: close to exact logaddexp
    got = float(log_add_compat(np.float32(-1.0), np.float32(-2.0)))
    want = float(np.logaddexp(-1.0, -2.0))
    assert abs(got - want) < 2e-3


def test_posterior_compat_close_to_oracle():
    rng = np.random.default_rng(3)
    base = "".join(rng.choice(list("ACGT"), size=40))
    mut = list(base)
    mut[10] = "T" if mut[10] != "T" else "A"
    del mut[25:28]
    s2 = "".join(mut)
    p_c, tot_c = posterior_compat(base, s2)
    p_o, tot_o = posterior_oracle(base, s2)
    assert p_c.shape == p_o.shape
    # table arithmetic drifts by O(1e-3) per op; posteriors must agree to
    # a loose tolerance and produce the same argmax alignment path
    assert np.max(np.abs(p_c.astype(np.float64) - p_o)) < 0.05
    assert abs(tot_c - tot_o) < 0.5
    am_c = np.argmax(p_c[1:], axis=1)
    am_o = np.argmax(p_o[1:], axis=1)
    assert (am_c == am_o).mean() > 0.9


def test_posterior_compat_equals_the_jax_package_copy():
    for a, b in _gen_pairs()[:3]:
        p, tot = posterior_compat(a, b)
        rp, rtot = jax_compat.posterior_compat(a, b)
        np.testing.assert_array_equal(p, rp)
        assert tot == rtot


def test_batch_posteriors_compat_route(compat_mode):
    """In compat mode the port's batch posteriors come from the table twin
    on the host, whatever the device (none is touched)."""
    pairs = [("ACGTACGTAA", "ACGTCCGTAA"), ("GGGTTT", "GGGTTT")]
    out = msa.batch_posteriors(pairs, device="cuda")
    assert len(out) == 2
    for (s1, s2), (p, tot) in zip(pairs, out):
        assert p.shape == (len(s1) + 1, len(s2) + 1)
        assert p.dtype == np.float32
        np.testing.assert_array_equal(
            p, posterior_compat(s1, s2)[0].astype(np.float32))
        assert np.isfinite(tot)
        assert p.max() > 0.5
    cut = msa.batch_posteriors_cut(pairs, device="cpu")
    for (p, tot), (pc, totc, score) in zip(out, cut):
        np.testing.assert_array_equal(pc, msa._sparsify(p))
        assert totc == tot and score == msa._mea_dp_fast(p)[1]


def test_msa_compat_switch_roundtrip():
    msa.set_logadd_compat(True)
    try:
        out = msa.batch_posteriors([("ACGTAC", "ACGTAC")])
        assert out[0][0].shape == (7, 7)
    finally:
        msa.set_logadd_compat(False)
    assert not msa._logadd_compat


def test_posteriors_match_reference_probcons():
    """The reference ProbCons binary's posteriors (checked-in fixture,
    printed %.6f)."""
    ref = _load_posteriors()
    pairs = _gen_pairs()
    assert len(ref) == len(pairs)
    for (a, b), want in zip(pairs, ref):
        got, _tot = posterior_compat(a, b)
        assert got.shape == want.shape
        assert np.max(np.abs(np.asarray(got) - want)) < 5e-6, (
            len(a), len(b),
        )


def test_msa_refinement0_matches_reference_doalign(compat_mode):
    """The reference's DoAlign with refinement 0 (checked-in fixture):
    the port's host MSA in compat mode gives its rows and confidences."""
    ref = _load_msas()
    bubbles = _gen_bubbles()
    assert len(ref) == len(bubbles)
    for alleles, want in zip(bubbles, ref):
        rows, conf = msa.probcons_align(
            alleles, consistency=2, refinement=0, consgap=True
        )
        assert {n: r for n, r in rows} == {n: r for n, r in want["rows"]}
        assert conf == want["conf"]
