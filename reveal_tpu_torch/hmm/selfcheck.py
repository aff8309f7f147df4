"""Self-check: the device's pair-HMM posteriors against the float64 oracle.

Counterpart of ``reveal_tpu/hmm/selfcheck.py``.  The refine stage's
numbers are only meaningful if the posterior kernels are numerically right
on the device actually used, so a check of the production path
(``hmm.msa.batch_posteriors`` on ``device``: the CUDA DP kernels on a
card, their plain versions on the CPU) against the scalar float64 port of
the reference DP (ProbabilisticModel.h:102-331, ``hmm.pairhmm.
posterior_oracle``) fails loudly instead of surfacing as wrong refined
graphs.  ``chip_smoke.py`` runs it on the card.
"""

from __future__ import annotations

import numpy as np

# The kernels run float32 with exact logaddexp; 2e-3 absolute on posterior
# probabilities matches the CPU test suite's tolerance.  The forward/
# backward log-values grow ~O(L), so their f32 rounding error (and hence
# the posterior error after EXP(f+b-tot)) scales with sequence length; the
# reference's own ScoreType is float32 (ScoreType.h:44), so it carries the
# same drift against a float64 oracle.
POSTERIOR_ATOL = 2e-3
POSTERIOR_ATOL_PER_BASE = 4e-5
LOGPROB_ATOL = 5e-2


def _atol_for(L1: int, L2: int, atol: float) -> float:
    return max(atol, POSTERIOR_ATOL_PER_BASE * max(L1, L2))


def check_posterior_oracle(
    lengths=(23, 57, 180, 511, 700), seed=0, atol=POSTERIOR_ATOL,
    device="cuda",
):
    """Run the production posterior path on ``device`` on random pairs
    (about 5% divergence) and compare against the float64 scalar oracle.

    Returns (max_abs_err, max_logprob_err, device name).  Raises
    AssertionError on any out-of-tolerance cell (an explicit raise, kept
    under ``python -O``).  Cells under the cut (oracle posterior < 0.011)
    are checked one-sided: they may be zeroed but never invented."""
    import torch

    from ..core.torchconfig import resolve_device
    from .msa import batch_posteriors
    from .pairhmm import posterior_oracle

    dev = resolve_device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    rng = np.random.default_rng(seed)
    pairs = []
    for L in lengths:
        a = "".join(rng.choice(list("ACGT"), size=L))
        b = list(a[: int(L * 0.95)])
        for _ in range(max(1, L // 20)):  # ~5% divergence
            b[int(rng.integers(0, len(b)))] = "ACGT"[int(rng.integers(4))]
        pairs.append((a, "".join(b)))

    out = batch_posteriors(pairs, slice_output=True, device=dev)
    max_err = 0.0
    max_tot_err = 0.0
    for (a, b), (p, tot) in zip(pairs, out):
        tol = _atol_for(len(a), len(b), atol)
        p_ref, tot_ref = posterior_oracle(a, b)
        p = np.asarray(p, dtype=np.float64)
        if p.shape != p_ref.shape:
            raise AssertionError("posterior of shape %s, oracle %s"
                                 % (p.shape, p_ref.shape))
        # cells the cut must carry exactly
        hi = p_ref >= 0.011
        err_hi = float(np.abs(p[hi] - p_ref[hi]).max()) if hi.any() else 0.0
        # everything else may be zeroed but never invented
        lo = ~hi
        err_lo = float(np.maximum(p[lo] - p_ref[lo] - tol, 0).max())
        err = max(err_hi, err_lo)
        terr = abs(float(tot) - float(tot_ref))
        max_err = max(max_err, err)
        max_tot_err = max(max_tot_err, terr)
        if err > tol:
            raise AssertionError(
                "posterior mismatch vs float64 oracle: |err|=%.2e > %.0e "
                "(pair lengths %d/%d, device %s)"
                % (err, tol, len(a), len(b), name))
        if terr > LOGPROB_ATOL:
            raise AssertionError(
                "total log-prob mismatch: %.3e (lengths %d/%d)"
                % (terr, len(a), len(b)))
    return max_err, max_tot_err, name
