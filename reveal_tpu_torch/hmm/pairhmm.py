"""5-state pair-HMM: parameters, padding, the posterior cut and the oracle.

Counterpart of ``reveal_tpu/hmm/pairhmm.py``.  Model identical to REVEAL's
re-parameterized ProbCons (probcons/ProbabilisticModel.h:36-331, parameters
probcons/Defaults.h): states M, Ix_short, Iy_short, Ix_long, Iy_long
(NumInsertStates=2), pecan-derived DNA emissions over "ACGTN", init
distribution 0.2 each.  gapSwitch transitions only renormalize the
insert->match mass; they never appear in the DP
(ProbabilisticModel.h:149-166,232-252), which is what makes the row-wise
formulation exact.

This module holds what is independent of the DP's implementation: the
parameter tables (``_emission_tables``, ``_log_params``, copied), the
parameter object the kernels read (``PairHMMParams``,
``params_from_numpy``), sequence padding and bucketing, the float64
oracle (``forward_np``, ``backward_np``, ``posterior_oracle``, copied)
and the posterior cut (``posterior_cut``, ``fetch_posteriors_compact``:
the reference's ``_get_cut_fn`` as torch code).  The DP itself, forward
and backward, lives in ``pairhmm_dp.py`` with its CUDA kernels in
``csrc/pairhmm_dp.cu``.  The reference's XLA row-scan (``_get_kernels``)
and its ragged pack for a remote device link are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .mea_score import mea_score

LOG_ZERO = -2e20  # ScoreType.h:16

# ---------------------------------------------------------------------------
# parameters (Defaults.h)
# ---------------------------------------------------------------------------

ALPHABET = "ACGTN"
INIT_DISTRIB = np.array([0.2, 0.2, 0.2, 0.2, 0.2], dtype=np.float32)
GAP_OPEN = np.array(
    [0.0129868352330243, 0.0129868352330243, 0.001821479941, 0.001821479941],
    dtype=np.float32,
)
GAP_EXTEND = np.array(
    [0.7126062401851738, 0.7126062401851738, 0.99656342579062, 0.99656342579062],
    dtype=np.float32,
)
GAP_SWITCH = np.array([0.0073673675173412815, 0.0], dtype=np.float32)

EMIT_SINGLE_DEFAULT = 1e-5
EMIT_PAIR_DEFAULT = 1e-10
_EMIT_SINGLE_ALPHA = np.array([0.2] * 5, dtype=np.float32)
_EMIT_PAIRS_ALPHA = np.array(
    [
        [0.12064298095701059, 0.0, 0.0, 0.0, 0.0],
        [0.010367271172731285, 0.12064298095701059, 0.0, 0.0, 0.0],
        [0.01862247669752685, 0.010367271172731285, 0.12064298095701059, 0.0, 0.0],
        [
            0.010367271172731285,
            0.01862247669752685,
            0.010367271172731285,
            0.12064298095701059,
            0.0,
        ],
        [0.04, 0.04, 0.04, 0.04, 0.04],
    ],
    dtype=np.float32,
)


def _emission_tables():
    """256-wide byte-indexed log emission tables (Probcons.cc:917-935)."""
    emit_single = np.full(256, EMIT_SINGLE_DEFAULT, dtype=np.float32)
    emit_pairs = np.full((256, 256), EMIT_PAIR_DEFAULT, dtype=np.float32)
    for i, a in enumerate(ALPHABET):
        for ca in (a.lower(), a.upper()):
            emit_single[ord(ca)] = _EMIT_SINGLE_ALPHA[i]
        for j in range(i + 1):
            b = ALPHABET[j]
            v = _EMIT_PAIRS_ALPHA[i][j]
            for ca in (a.lower(), a.upper()):
                for cb in (b.lower(), b.upper()):
                    emit_pairs[ord(ca), ord(cb)] = v
                    emit_pairs[ord(cb), ord(ca)] = v
    with np.errstate(divide="ignore"):
        return np.log(emit_single), np.log(emit_pairs)


LOG_EMIT_SINGLE, LOG_EMIT_PAIRS = _emission_tables()


def _log_params():
    """(log_init[5], log_trans[5][5]) per ProbabilisticModel.h:51-77."""
    trans = np.zeros((5, 5), dtype=np.float64)
    trans[0][0] = 1.0
    for i in range(2):
        trans[0][2 * i + 1] = GAP_OPEN[2 * i]
        trans[0][2 * i + 2] = GAP_OPEN[2 * i + 1]
        trans[0][0] -= GAP_OPEN[2 * i] + GAP_OPEN[2 * i + 1]
        trans[2 * i + 1][2 * i + 1] = GAP_EXTEND[2 * i]
        trans[2 * i + 2][2 * i + 2] = GAP_EXTEND[2 * i + 1]
        trans[2 * i + 1][2 * i + 2] = GAP_SWITCH[i]
        trans[2 * i + 2][2 * i + 1] = GAP_SWITCH[i]
        trans[2 * i + 1][0] = 1 - GAP_EXTEND[2 * i] - GAP_SWITCH[i]
        trans[2 * i + 2][0] = 1 - GAP_EXTEND[2 * i + 1] - GAP_SWITCH[i]
    with np.errstate(divide="ignore"):
        log_trans = np.where(
            trans > 0, np.log(trans.astype(np.float32)), LOG_ZERO
        ).astype(np.float32)
        log_init = np.log(INIT_DISTRIB).astype(np.float32)
    return log_init, log_trans


LOG_INIT, LOG_TRANS = _log_params()


NCLS = 8  # class tables are padded from 6 to 8 entries


def _class_tables(log_emit_single, log_emit_pairs):
    """The byte-indexed emission tables reduced to the six sequence
    classes A C G T N other (``reveal_tpu/hmm/pallas_pairhmm.py:42-50``):
    (single (NCLS,), pairs (NCLS, NCLS)) float32."""
    cls_single = np.full(NCLS, math.log(1e-5), dtype=np.float32)
    cls_pair = np.full((NCLS, NCLS), math.log(1e-10), dtype=np.float32)
    for a in range(6):
        ca = ord("ACGTN"[a]) if a < 5 else ord("@")
        cls_single[a] = log_emit_single[ca] if a < 5 else math.log(1e-5)
        for b in range(6):
            cb = ord("ACGTN"[b]) if b < 5 else ord("@")
            if a < 5 and b < 5:
                cls_pair[a, b] = log_emit_pairs[ca, cb]
    return cls_single, cls_pair


@dataclass(frozen=True)
class PairHMMParams:
    """The model's parameters as float32 tensors on one device.

    ``init`` (5,), ``trans`` (5, 5), ``single`` (NCLS,), ``pair``
    (NCLS, NCLS) in log space; ``packed`` is their concatenation in that
    order (5 + 25 + 8 + 64 floats), the one buffer the CUDA kernels
    read."""

    init: torch.Tensor
    trans: torch.Tensor
    single: torch.Tensor
    pair: torch.Tensor
    packed: torch.Tensor

    @property
    def device(self):
        return self.packed.device


def params_from_numpy(log_init, log_trans, log_emit_single, log_emit_pairs,
                      device="cpu") -> PairHMMParams:
    """Parameter object from the reference package's tables as numpy
    arrays: ``LOG_INIT`` (5,), ``LOG_TRANS`` (5, 5), the 256-wide
    ``LOG_EMIT_SINGLE`` and the 256 x 256 ``LOG_EMIT_PAIRS``."""
    cls_single, cls_pair = _class_tables(
        np.asarray(log_emit_single), np.asarray(log_emit_pairs)
    )
    init = np.asarray(log_init, dtype=np.float32).reshape(5)
    trans = np.asarray(log_trans, dtype=np.float32).reshape(5, 5)
    packed = np.concatenate(
        [init, trans.ravel(), cls_single, cls_pair.ravel()]
    ).astype(np.float32)
    dev = torch.device(device)
    return PairHMMParams(
        init=torch.from_numpy(init.copy()).to(dev),
        trans=torch.from_numpy(trans.copy()).to(dev),
        single=torch.from_numpy(cls_single).to(dev),
        pair=torch.from_numpy(cls_pair).to(dev),
        packed=torch.from_numpy(packed).to(dev),
    )


_default_params = {}


def default_params(device="cpu") -> PairHMMParams:
    """The port's own parameters (``_emission_tables``/``_log_params``)
    on ``device``, built once per device."""
    dev = torch.device(device)
    p = _default_params.get(dev)
    if p is None:
        p = params_from_numpy(
            LOG_INIT, LOG_TRANS, LOG_EMIT_SINGLE, LOG_EMIT_PAIRS, dev
        )
        _default_params[dev] = p
    return p


def _pad_with_dummy(seq: bytes, L: int) -> np.ndarray:
    """'@' dummy at index 0 (probcons Sequence convention), '~' padding."""
    arr = np.full(L + 1, ord("~"), dtype=np.uint8)
    arr[0] = ord("@")
    s = np.frombuffer(seq, dtype=np.uint8)
    arr[1 : len(s) + 1] = s
    return arr


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b



# --- the posterior cut ------------------------------------------------------
# A posterior row sums to <= 1, so at most 100 entries can clear the MSA's
# POSTERIOR_CUTOFF=0.01 (SparseMatrix.h:14,67); per-row top-K with K=128 is
# therefore an exact copy of every cell the sparse consumers can see,
# while sub-cutoff mass is zeroed (the reference's SparseMatrix drops it at
# construction too).  The cut runs where the posterior lies, so only the
# survivors, their per-row counts, the totals and the MEA scores reach the
# host.  K is the smallest step of the ladder 8 -> 32 -> 128 that holds
# the fullest row (similar sequences rarely exceed 8 survivors per row).
# The MEA distance score is computed from the FULL posterior by the
# cummax row scan (``mea_score``: a CUDA kernel on the card), bit-equal to
# the host _mea_dp_fast recurrence (one float32 add and maxima per cell),
# so nothing downstream needs the dense matrix.
CUT_LADDER = (8, 32, 128)
POSTERIOR_CUTOFF = 0.01


def posterior_cut(p: torch.Tensor, nrows=None):
    """The >= 0.01 cut of a posterior batch ``p`` (B, L1p, L2p) with row
    and column 0 cleared: returns (q, cnt, scores) = the cut dense
    batch, the survivors per row (B, L1p) int32 and the MEA score of the
    full posterior per pair (B,) float32 (``mea_score``).  ``nrows``
    bounds the rows the score scan walks (rows beyond every pair's length
    are zero and leave the scan unchanged)."""
    m = p >= POSTERIOR_CUTOFF
    m[:, 0, :] = False
    m[:, :, 0] = False
    q = torch.where(m, p, torch.zeros((), dtype=p.dtype, device=p.device))
    cnt = m.sum(-1, dtype=torch.int32)
    return q, cnt, mea_score(p, nrows)


def compact_rows(q: torch.Tensor, cnt: torch.Tensor):
    """The nonzero cells of a cut batch ``q`` (B, L1p, L2p), ``cnt[b, r]``
    of them in row r, as host numpy (v, i): per-row top-K values and
    columns, K the smallest step of ``CUT_LADDER`` that holds the fullest
    row.  The first cnt[b, r] entries of a row are its nonzero cells;
    the slots beyond point at column 0."""
    most = int(cnt.max()) if cnt.numel() else 0
    K = next((k for k in CUT_LADDER if k >= most), CUT_LADDER[-1])
    if most > K:
        raise AssertionError(
            "%d cells of one posterior row are >= %g; rows sum to <= 1"
            % (most, POSTERIOR_CUTOFF)
        )
    K = min(K, q.shape[-1])
    v, i = torch.topk(q, k=K, dim=-1)
    # slots beyond a row's survivors hold zeros from arbitrary columns;
    # point them at column 0, which every consumer clears
    keep = torch.arange(K, device=q.device) < cnt[..., None]
    i = torch.where(keep, i, torch.zeros((), dtype=i.dtype, device=q.device))
    i = i.to(torch.int16 if q.shape[-1] < 2**15 else torch.int32)
    return v.cpu().numpy(), i.cpu().numpy()


def fetch_posteriors_compact(p: torch.Tensor, tot: torch.Tensor,
                             nrows=None):
    """Cutoff-sparsified posteriors and MEA scores as host numpy arrays,
    compact form: (v, i, cnt, tot, scores) with v, i (B, L1p, K) the
    per-row top-K values and columns (``compact_rows``).  The first
    cnt[b, r] entries of a row are exactly the >= 0.01 survivors of
    ``msa._sparsify`` (row and column 0 cleared)."""
    q, cnt, scores = posterior_cut(p, nrows=nrows)
    v, i = compact_rows(q, cnt)
    return (
        v,
        i,
        cnt.cpu().numpy(),
        tot.cpu().numpy(),
        scores.cpu().numpy(),
    )


# ---------------------------------------------------------------------------
# numpy oracle — direct port of the reference scalar DP for testing
# ---------------------------------------------------------------------------

def forward_np(seq1: str, seq2: str) -> np.ndarray:
    """Scalar forward DP (ProbabilisticModel.h:102-176), exact logaddexp."""
    L1, L2 = len(seq1), len(seq2)
    x = _pad_with_dummy(seq1.encode(), L1)
    y = _pad_with_dummy(seq2.encode(), L2)
    f = np.full((5, L1 + 1, L2 + 1), LOG_ZERO, dtype=np.float64)
    li = LOG_INIT.astype(np.float64)
    lt = LOG_TRANS.astype(np.float64)
    les = LOG_EMIT_SINGLE.astype(np.float64)
    lep = LOG_EMIT_PAIRS.astype(np.float64)

    def lae(a, b):
        if a <= LOG_ZERO / 2 and b <= LOG_ZERO / 2:
            return LOG_ZERO
        return np.logaddexp(a, b)

    if L1 >= 1 and L2 >= 1:
        f[0, 1, 1] = li[0] + lep[x[1], y[1]]
    for k in range(2):
        if L1 >= 1:
            f[2 * k + 1, 1, 0] = li[2 * k + 1] + les[x[1]]
        if L2 >= 1:
            f[2 * k + 2, 0, 1] = li[2 * k + 2] + les[y[1]]

    for i in range(L1 + 1):
        for j in range(L2 + 1):
            if not (i > 1 or j > 1):
                continue
            if i > 0 and j > 0:
                v = f[0, i - 1, j - 1] + lt[0, 0]
                for k in range(1, 5):
                    v = lae(v, f[k, i - 1, j - 1] + lt[k, 0])
                f[0, i, j] = v + lep[x[i], y[j]]
            if i > 0:
                for k in range(2):
                    f[2 * k + 1, i, j] = les[x[i]] + lae(
                        f[0, i - 1, j] + lt[0, 2 * k + 1],
                        f[2 * k + 1, i - 1, j] + lt[2 * k + 1, 2 * k + 1],
                    )
            if j > 0:
                for k in range(2):
                    f[2 * k + 2, i, j] = les[y[j]] + lae(
                        f[0, i, j - 1] + lt[0, 2 * k + 2],
                        f[2 * k + 2, i, j - 1] + lt[2 * k + 2, 2 * k + 2],
                    )
    return f


def backward_np(seq1: str, seq2: str) -> np.ndarray:
    """Scalar backward DP (ProbabilisticModel.h:194-258)."""
    L1, L2 = len(seq1), len(seq2)
    x = _pad_with_dummy(seq1.encode(), L1)
    y = _pad_with_dummy(seq2.encode(), L2)
    b = np.full((5, L1 + 1, L2 + 1), LOG_ZERO, dtype=np.float64)
    li = LOG_INIT.astype(np.float64)
    lt = LOG_TRANS.astype(np.float64)
    les = LOG_EMIT_SINGLE.astype(np.float64)
    lep = LOG_EMIT_PAIRS.astype(np.float64)

    def lae(a, bb):
        if a <= LOG_ZERO / 2 and bb <= LOG_ZERO / 2:
            return LOG_ZERO
        return np.logaddexp(a, bb)

    for k in range(5):
        b[k, L1, L2] = li[k]

    for i in range(L1, -1, -1):
        for j in range(L2, -1, -1):
            if i < L1 and j < L2:
                pxy = b[0, i + 1, j + 1] + lep[x[i + 1], y[j + 1]]
                for k in range(5):
                    b[k, i, j] = lae(b[k, i, j], pxy + lt[k, 0])
            if i < L1:
                for k in range(2):
                    b[0, i, j] = lae(
                        b[0, i, j],
                        b[2 * k + 1, i + 1, j]
                        + les[x[i + 1]]
                        + lt[0, 2 * k + 1],
                    )
                    b[2 * k + 1, i, j] = lae(
                        b[2 * k + 1, i, j],
                        b[2 * k + 1, i + 1, j]
                        + les[x[i + 1]]
                        + lt[2 * k + 1, 2 * k + 1],
                    )
            if j < L2:
                for k in range(2):
                    b[0, i, j] = lae(
                        b[0, i, j],
                        b[2 * k + 2, i, j + 1]
                        + les[y[j + 1]]
                        + lt[0, 2 * k + 2],
                    )
                    b[2 * k + 2, i, j] = lae(
                        b[2 * k + 2, i, j],
                        b[2 * k + 2, i, j + 1]
                        + les[y[j + 1]]
                        + lt[2 * k + 2, 2 * k + 2],
                    )
    return b


def posterior_oracle(seq1: str, seq2: str) -> Tuple[np.ndarray, float]:
    f = forward_np(seq1, seq2)
    b = backward_np(seq1, seq2)
    L1, L2 = len(seq1), len(seq2)
    tot = LOG_ZERO
    for k in range(5):
        v = f[k, L1, L2] + b[k, L1, L2]
        tot = np.logaddexp(tot, v) if tot > LOG_ZERO / 2 else v
    p = np.exp(np.minimum(0.0, f[0] + b[0] - tot))
    p[0, :] = 0
    p[:, 0] = 0
    return p, tot
