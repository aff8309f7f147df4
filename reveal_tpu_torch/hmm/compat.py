"""ProbCons LOG_ADD lookup-table compatibility arithmetic.

The reference extension does all pair-HMM math in float32 with
piecewise-polynomial approximations of exp and log1p(exp(x))
(probcons/ScoreType.h): ``EXP`` (:34-55), ``LOOKUP``
(:185-197), ``LOG_ADD``/``LOG_PLUS_EQUALS`` with the
LOG_UNDERFLOW_THRESHOLD=7.5 shortcut (:232-262).  The production kernels
here use exact float32 logaddexp instead (documented deviation); this
module provides the table-emulated arithmetic plus forward/backward/
posterior twins that replicate the reference's float32 op order
(ProbabilisticModel.h:102-331), so bit-equivalence of refined graphs
against the reference binary can be attempted (enable with
``batch_posteriors(..., compat=True)`` / ``reveal_tpu refine
--logadd-compat``).

Remaining sources of last-ulp divergence documented here: the C++ build
may contract a*x+b to FMA under -O3 (numpy never does), and libm exp()
is used for LOOKUP inputs < 0 / EXP inputs > 0.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .pairhmm import (
    LOG_EMIT_PAIRS,
    LOG_EMIT_SINGLE,
    LOG_INIT,
    LOG_TRANS,
    LOG_ZERO,
    _pad_with_dummy,
)

F = np.float32
LOG_UNDERFLOW_THRESHOLD = F(7.5)
EXP_UNDERFLOW_THRESHOLD = F(-4.6)
LOG_ZERO32 = F(LOG_ZERO)


def _poly4(x, a, b, c, d, e):
    x = F(x)
    return F(F(F(F(F(F(F(F(F(a) * x) + F(b)) * x) + F(c)) * x) + F(d)) * x) + F(e))


def exp_compat(x) -> np.float32:
    """ScoreType.h EXP (:34-55): quartic piecewise approximation of
    exp(x) for x <= 0 (libm exp above 0)."""
    x = F(x)
    if x > F(-2):
        if x > F(-0.5):
            if x > 0:
                return F(np.exp(np.float64(x)))
            return _poly4(
                x,
                0.03254409303190190000, 0.16280432765779600000,
                0.49929760485974900000, 0.99995149601363700000,
                0.99999925508501600000,
            )
        if x > F(-1):
            return _poly4(
                x,
                0.01973899026052090000, 0.13822379685007000000,
                0.48056651562365000000, 0.99326940370383500000,
                0.99906756856399500000,
            )
        return _poly4(
            x,
            0.00940528203591384000, 0.09414963667859410000,
            0.40825793595877300000, 0.93933625499130400000,
            0.98369508190545300000,
        )
    if x > F(-8):
        if x > F(-4):
            return _poly4(
                x,
                0.00217245711583303000, 0.03484829428350620000,
                0.22118199801337800000, 0.67049462206469500000,
                0.83556950223398500000,
            )
        return _poly4(
            x,
            0.00012398771025456900, 0.00349155785951272000,
            0.03727721426017900000, 0.17974997741536900000,
            0.33249299994217400000,
        )
    if x > F(-16):
        return _poly4(
            x,
            0.00000051741713416603, 0.00002721456879608080,
            0.00053418601865636800, 0.00464101989351936000,
            0.01507447981459420000,
        )
    return F(0)


def _poly3(x, a, b, c, d):
    x = F(x)
    return F(F(F(F(F(F(F(a) * x) + F(b)) * x) + F(c)) * x) + F(d))


def lookup_compat(x) -> np.float32:
    """ScoreType.h LOOKUP (:185-197): cubic piecewise approximation of
    log(exp(x) + 1) for 0 <= x <= 7.5."""
    x = F(x)
    assert x >= 0 and x <= LOG_UNDERFLOW_THRESHOLD
    if x <= F(1.0):
        return _poly3(
            x,
            -0.009350833524763, 0.130659527668286,
            0.498799810682272, 0.693203116424741,
        )
    if x <= F(2.5):
        return _poly3(
            x,
            -0.014532321752540, 0.139942324101744,
            0.495635523139337, 0.692140569840976,
        )
    if x <= F(4.5):
        return _poly3(
            x,
            -0.004605031767994, 0.063427417320019,
            0.695956496475118, 0.514272634594009,
        )
    return _poly3(
        x,
        -0.000458661602210, 0.009695946122598,
        0.930734667215156, 0.168037164329057,
    )


def log_add_compat(x, y) -> np.float32:
    """ScoreType.h LOG_ADD (:258-262), float32 semantics."""
    x = F(x)
    y = F(y)
    if x < y:
        if x == LOG_ZERO32 or F(y - x) >= LOG_UNDERFLOW_THRESHOLD:
            return y
        return F(lookup_compat(F(y - x)) + x)
    if y == LOG_ZERO32 or F(x - y) >= LOG_UNDERFLOW_THRESHOLD:
        return x
    return F(lookup_compat(F(x - y)) + y)


# ---------------------------------------------------------------------------
# float32 forward / backward / posterior twins in reference op order
# ---------------------------------------------------------------------------

def forward_compat(seq1: str, seq2: str) -> np.ndarray:
    """ComputeForwardMatrix (ProbabilisticModel.h:102-176) with LOG_ADD
    table arithmetic, float32."""
    L1, L2 = len(seq1), len(seq2)
    x = _pad_with_dummy(seq1.encode(), L1)
    y = _pad_with_dummy(seq2.encode(), L2)
    f = np.full((5, L1 + 1, L2 + 1), LOG_ZERO32, dtype=np.float32)
    li = LOG_INIT.astype(np.float32)
    lt = LOG_TRANS.astype(np.float32)
    les = LOG_EMIT_SINGLE.astype(np.float32)
    lep = LOG_EMIT_PAIRS.astype(np.float32)

    if L1 >= 1 and L2 >= 1:
        f[0, 1, 1] = F(li[0] + lep[x[1], y[1]])
    for k in range(2):
        if L1 >= 1:
            f[2 * k + 1, 1, 0] = F(li[2 * k + 1] + les[x[1]])
        if L2 >= 1:
            f[2 * k + 2, 0, 1] = F(li[2 * k + 2] + les[y[1]])

    for i in range(L1 + 1):
        for j in range(L2 + 1):
            if not (i > 1 or j > 1):
                continue
            if i > 0 and j > 0:
                v = F(f[0, i - 1, j - 1] + lt[0, 0])
                for k in range(1, 5):
                    v = log_add_compat(v, F(f[k, i - 1, j - 1] + lt[k, 0]))
                f[0, i, j] = F(v + lep[x[i], y[j]])
            if i > 0:
                for k in range(2):
                    f[2 * k + 1, i, j] = F(
                        les[x[i]]
                        + log_add_compat(
                            F(f[0, i - 1, j] + lt[0, 2 * k + 1]),
                            F(
                                f[2 * k + 1, i - 1, j]
                                + lt[2 * k + 1, 2 * k + 1]
                            ),
                        )
                    )
            if j > 0:
                for k in range(2):
                    f[2 * k + 2, i, j] = F(
                        les[y[j]]
                        + log_add_compat(
                            F(f[0, i, j - 1] + lt[0, 2 * k + 2]),
                            F(
                                f[2 * k + 2, i, j - 1]
                                + lt[2 * k + 2, 2 * k + 2]
                            ),
                        )
                    )
    return f


def backward_compat(seq1: str, seq2: str) -> np.ndarray:
    """ComputeBackwardMatrix (ProbabilisticModel.h:194-258) with LOG_ADD
    table arithmetic, float32."""
    L1, L2 = len(seq1), len(seq2)
    x = _pad_with_dummy(seq1.encode(), L1)
    y = _pad_with_dummy(seq2.encode(), L2)
    b = np.full((5, L1 + 1, L2 + 1), LOG_ZERO32, dtype=np.float32)
    li = LOG_INIT.astype(np.float32)
    lt = LOG_TRANS.astype(np.float32)
    les = LOG_EMIT_SINGLE.astype(np.float32)
    lep = LOG_EMIT_PAIRS.astype(np.float32)

    for k in range(5):
        b[k, L1, L2] = li[k]

    for i in range(L1, -1, -1):
        for j in range(L2, -1, -1):
            if i < L1 and j < L2:
                pxy = F(b[0, i + 1, j + 1] + lep[x[i + 1], y[j + 1]])
                for k in range(5):
                    b[k, i, j] = log_add_compat(
                        b[k, i, j], F(pxy + lt[k, 0])
                    )
            if i < L1:
                for k in range(2):
                    b[0, i, j] = log_add_compat(
                        b[0, i, j],
                        F(
                            b[2 * k + 1, i + 1, j]
                            + les[x[i + 1]]
                            + lt[0, 2 * k + 1]
                        ),
                    )
                    b[2 * k + 1, i, j] = log_add_compat(
                        b[2 * k + 1, i, j],
                        F(
                            b[2 * k + 1, i + 1, j]
                            + les[x[i + 1]]
                            + lt[2 * k + 1, 2 * k + 1]
                        ),
                    )
            if j < L2:
                for k in range(2):
                    b[0, i, j] = log_add_compat(
                        b[0, i, j],
                        F(
                            b[2 * k + 2, i, j + 1]
                            + les[y[j + 1]]
                            + lt[0, 2 * k + 2]
                        ),
                    )
                    b[2 * k + 2, i, j] = log_add_compat(
                        b[2 * k + 2, i, j],
                        F(
                            b[2 * k + 2, i, j + 1]
                            + les[y[j + 1]]
                            + lt[2 * k + 2, 2 * k + 2]
                        ),
                    )
    return b


def posterior_compat(seq1: str, seq2: str) -> Tuple[np.ndarray, float]:
    """ComputePosteriorMatrix + ComputeTotalProbability
    (ProbabilisticModel.h:259-331): tot = (fwd-total + bwd-total)/2,
    posterior = EXP(min(0, f0+b0-tot)), cell (0,0) zeroed."""
    L1, L2 = len(seq1), len(seq2)
    f = forward_compat(seq1, seq2)
    b = backward_compat(seq1, seq2)

    tf = LOG_ZERO32
    for k in range(5):
        tf = log_add_compat(tf, F(f[k, L1, L2] + b[k, L1, L2]))
    tb = F(f[0, 1, 1] + b[0, 1, 1]) if (L1 and L2) else LOG_ZERO32
    for k in range(2):
        if L1 >= 1:
            tb = log_add_compat(tb, F(f[2 * k + 1, 1, 0] + b[2 * k + 1, 1, 0]))
        if L2 >= 1:
            tb = log_add_compat(tb, F(f[2 * k + 2, 0, 1] + b[2 * k + 2, 0, 1]))
    tot = F(F(tf + tb) / F(2))

    p = np.zeros((L1 + 1, L2 + 1), dtype=np.float32)
    for i in range(L1 + 1):
        for j in range(L2 + 1):
            p[i, j] = exp_compat(min(F(0), F(f[0, i, j] + b[0, i, j] - tot)))
    p[0, 0] = 0
    # the sparse consumers downstream index rows/cols >= 1 only; zero the
    # full borders like the exact kernels (SparseMatrix.h:54 skips them)
    p[0, :] = 0
    p[:, 0] = 0
    return p, float(tot)
