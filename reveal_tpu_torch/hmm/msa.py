"""ProbCons-style consistency MSA over the pair-HMM kernels.

Counterpart of ``reveal_tpu/hmm/msa.py``.  Pipeline identical to the
reference's probconslib (DoAlign, probcons/Probcons.cc:312-544):

1. all-pairs posterior matrices (device batch, hmm.pairhmm_dp) sparsified
   at POSTERIOR_CUTOFF=0.01 (SparseMatrix.h:14,67) + expected-accuracy
   distances from the pairwise MEA alignment;
2. ``consistency`` rounds of the relaxation transform
   P' = (2P_xy + sum_z P_xz P_zy)/N (DoRelaxation, Probcons.cc:1135-1248;
   gap-aware variant Relax_gap adds the p_gap outer product,
   Probcons.cc:1291-1353), masked to the previous sparsity pattern and
   re-cut;
3. expected-accuracy guide tree (EvolutionaryTree.h:104-160);
4. progressive alignment: BuildPosterior sum over mapped sparse cells +
   maximum-expected-accuracy DP with D>=L>=U tie-breaking
   (ProbabilisticModel.h:641-701,1018-1089; ChooseBestOfThree
   ScoreType.h:320);
5. ``refinement`` rounds of random-bipartition realignment
   (DoIterativeRefinement, Probcons.cc:1467-1490);
6. per-column confidence annotation = 200 * mean pairwise posterior
   (ComputeAnnotation/ComputeScore, Probcons.cc:1545-1602).

Stages 1 and 2 run on the torch device given, by either of two routes.
``batch_stage12_device`` is the chain: posteriors (the DP kernels at
square (Lq, Lq) buckets), MEA distances (``mea_score``), the cut and the
relaxation rounds (``consistency_rounds``, float32 products) all stay on
the device, and only the transformed a<b matrices and the scores reach
the host; a problem whose (N, N, Lq, Lq) tensor exceeds
``CHAIN_BYTES_CAP`` comes back ``None``.  ``batch_posteriors_cut`` is
stage 1 alone (cut posteriors and scores), after which
``probcons_align`` runs stage 2 on the host in float64 (dense, or scipy
sparse for long pairs).  ``batch_consistency`` runs stage 2 on the device
for posteriors the caller has.  On the CPU the DP kernels and the MEA
scan are their plain torch versions; the same code surrounds them.

Left out of the reference's chain: the power-of-two padding of a batch
(it bounded XLA's compile cache; torch compiles nothing per shape), the
thread pool over chunks (it overlapped a remote device link's executable
loads) and the choice between the Pallas kernels and the XLA row-scan
by backend (the port has one DP, kernels on a card and their plain
versions on the CPU); its ``except`` that turned a failed chunk into
``None`` is not carried: a failure raises.  The bf16 option of the
consistency products (``REVEAL_TPU_CONS_BF16``) is not ported.  The
reference's small-workload routes to the native host pair-HMM are not
ported either.  ``batch_posteriors_cut_native`` is the float64-exact
native host route for stage 1; it is a reference to hold the device
against, chosen by the caller by name, never a fallback.
``set_logadd_compat`` (``refine --logadd-compat``) sends every posterior
through the float32 LOG_ADD table twin of ``hmm/compat.py`` on the host,
on every device, as the reference does.  Alignment
strings use '-' for gaps like the reference.
"""

from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import numpy as np

import torch

from ..core.torchconfig import resolve_device
from .compat import posterior_compat
from .mea_score import mea_score
from .pairhmm import POSTERIOR_CUTOFF, compact_rows, fetch_posteriors_compact
from .pairhmm_dp import (
    _ceil_div,
    batch_posteriors_dp,
    batch_size,
    batches,
    pack,
    posterior_batch,
)

log = logging.getLogger(__name__)

# device of batch_posteriors when the caller names none (probcons_align
# without precomputed posteriors)
DEFAULT_DEVICE = "cuda"


_logadd_compat = False


def set_logadd_compat(flag: bool) -> None:
    """Route all posterior computation through the float32 LOG_ADD
    lookup-table arithmetic (ScoreType.h:185-262 semantics, see
    hmm/compat.py).  Slow scalar mode for reference bit-equivalence
    attempts; enabled by ``refine --logadd-compat``."""
    global _logadd_compat
    _logadd_compat = bool(flag)


def batch_posteriors(pairs, slice_output: bool = True, device=None):
    """Dense posteriors [(posterior, total), ...] of string pairs on
    ``device`` (default ``DEFAULT_DEVICE``), through the DP wrappers; in
    compat mode (``set_logadd_compat``) from the LOG_ADD table twin, pair
    by pair on the host, on every device
    (reveal_tpu/hmm/pairhmm.py:733-740)."""
    if _logadd_compat:
        out = []
        for s1, s2 in pairs:
            p, tot = posterior_compat(s1, s2)
            out.append((p.astype(np.float32), tot))
        return out
    dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    return batch_posteriors_dp(pairs, dev, slice_output=slice_output)


class SparsePost:
    """Cutoff-compacted posterior of ONE pair: the device's top-K rows
    (values descending, first cnt[r] entries are the >=0.01 survivors
    of row r, row/col 0 excluded — exactly the _sparsify(dense)
    pattern, SparseMatrix.h:14-67).  Long-pair consumers use .tocsr()
    directly (the host consistency transform's sparse path); short-pair
    consumers materialize .dense().  Nothing dense ever crosses the
    device link."""

    __slots__ = ("v", "i", "cnt", "shape")

    def __init__(self, v, i, cnt, shape):
        self.v = v
        self.i = i
        self.cnt = cnt
        self.shape = shape

    @property
    def nnz(self) -> int:
        return int(self.cnt.sum())

    def dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float32)
        L1, K = self.v.shape
        np.put_along_axis(
            out[:L1],
            np.minimum(self.i.astype(np.int64), self.shape[1] - 1),
            np.where(
                np.arange(K)[None, :] < self.cnt[:, None], self.v, 0.0
            ),
            axis=1,
        )
        out[:, 0] = 0.0
        return out

    def tocsr(self, dtype=np.float64):
        import scipy.sparse as sp

        L1, K = self.v.shape
        valid = np.arange(K)[None, :] < self.cnt[:, None]
        indptr = np.zeros(self.shape[0] + 1, dtype=np.int64)
        indptr[1 : L1 + 1] = np.cumsum(self.cnt, dtype=np.int64)
        indptr[L1 + 1 :] = indptr[L1]
        # rows come value-sorted from top_k; csr wants column order
        order = np.argsort(
            np.where(valid, self.i.astype(np.int64), 2**31), axis=1
        )
        iv = np.take_along_axis(self.i.astype(np.int64), order, axis=1)
        vv = np.take_along_axis(self.v, order, axis=1)
        vmask = np.take_along_axis(valid, order, axis=1)
        indices = iv[vmask]
        data = vv[vmask]
        return sp.csr_matrix(
            (data.astype(dtype), indices, indptr), shape=self.shape
        )

    def sum(self, axis=None):
        valid = np.arange(self.v.shape[1])[None, :] < self.cnt[:, None]
        vv = np.where(valid, self.v, 0.0)
        if axis == 1:
            out = np.zeros(self.shape[0], dtype=np.float64)
            out[: self.v.shape[0]] = vv.sum(axis=1)
            return out
        if axis == 0:
            out = np.zeros(self.shape[1], dtype=np.float64)
            np.add.at(
                out,
                np.where(valid, self.i.astype(np.int64), 0).ravel(),
                vv.ravel(),
            )
            out[0] = 0.0
            return out
        return float(vv.sum())



def batch_posteriors_cut(pairs, device="cuda"):
    """Stage 1 on ``device`` with the cut applied there: posteriors are
    cutoff-compacted where they were computed
    (pairhmm.fetch_posteriors_compact), so only surviving cells, per-row
    counts, totals and MEA scores reach the host.

    Returns [(p_cut, total, score), ...] in input order, where p_cut is
    a ``SparsePost`` (compact top-K rows; ``.dense()`` reproduces
    ``_sparsify(p_dense)`` exactly) and score equals the host
    ``_mea_dp_fast(p_dense)[1]``.  The same code runs on a CUDA device
    (the DP kernels) and on the CPU (their plain versions).  In compat
    mode (``set_logadd_compat``) every pair takes the host route on every
    device: dense posteriors of the LOG_ADD table twin, ``_sparsify`` and
    ``_mea_dp_fast`` (reveal_tpu/hmm/msa.py:199-203)."""
    dev = resolve_device(device)
    if _logadd_compat:
        res = batch_posteriors(pairs)
        return [
            (_sparsify(p), tot, _mea_dp_fast(p)[1]) for p, tot in res
        ]
    out = [None] * len(pairs)
    for _L1p, _L2p, idxs, x, y, lx, ly in batches(pairs, dev):
        p, tot = posterior_batch(x, y, lx, ly)
        vq, iq, cnt, tot, scores = fetch_posteriors_compact(
            p, tot, nrows=int(lx.max())
        )
        del p
        for bi, i in enumerate(idxs):
            L1 = len(pairs[i][0]) + 1
            out[i] = (
                SparsePost(
                    vq[bi, :L1],
                    iq[bi, :L1],
                    cnt[bi, :L1],
                    (L1, len(pairs[i][1]) + 1),
                ),
                float(tot[bi]),
                float(scores[bi]),
            )
    return out


def batch_posteriors_cut_native(pairs):
    """Stage 1 on the host by the native float64-exact pair-HMM
    (native.pairhmm_post_batch_native): the same triples as
    ``batch_posteriors_cut`` with dense cut posteriors.  A reference for
    the device route; raises when the native library is unavailable."""
    from ..native import pairhmm_post_batch_native

    res = pairhmm_post_batch_native(pairs, cutoff=POSTERIOR_CUTOFF)
    if res is None:
        raise RuntimeError("the native host library "
                           "(reveal_tpu_torch/native) failed to build or "
                           "load")
    return res


def _sparsify(p: np.ndarray) -> np.ndarray:
    q = np.where(p >= POSTERIOR_CUTOFF, p, 0.0).astype(np.float32)
    q[0, :] = 0
    q[:, 0] = 0
    return q


# Single-problem footprint cap for the device stage-1+2 chain (the
# reference's, reveal_tpu/hmm/msa.py:309-313): a problem whose (N, N, Lq,
# Lq) float32 tensor is larger takes the two-phase route (stage 1 on the
# device, stage 2 on the host).  The relaxation rounds keep about 2.7
# such tensors live (``consistency_rounds``).
CHAIN_BYTES_CAP = 1 << 31
# bytes of the (B, N, N, Lq, Lq) tensor of one chunk of a bucket
CHUNK_BYTES = 1 << 28
# the transformed matrices of a chunk come back dense below this width
# and as per-row top-K above it (reveal_tpu/hmm/pairhmm.py:683-714)
SPARSE_TRANSFER_MIN_WIDTH = 513


def _bucket_len(x: int) -> int:
    """Pow2 tiers up to 2048, then multiples of 512: above 2k the pow2
    jump (e.g. 4.7k -> 8192) inflates the (N, N, Lq, Lq) chain tensor
    ~3x and pushes real bubbles past CHAIN_BYTES_CAP onto the slow
    host path; big bubbles are rare, so the extra shape signatures
    don't multiply executable loads in practice."""
    b = 32
    while b < x and b < 2048:
        b *= 2
    if b >= x:
        return b
    return ((x + 511) // 512) * 512


def _pair_index(N, device):
    """(a, b) index tensors of the a<b pairs of N sequences, in
    probcons_align's pair order."""
    keys = [(a, b) for a in range(N) for b in range(a + 1, N)]
    return (torch.tensor([a for a, _ in keys], device=device),
            torch.tensor([b for _, b in keys], device=device))


def consistency_rounds(Q: torch.Tensor, rounds: int, consgap: bool):
    """``rounds`` relaxation rounds of a batch of problems, in place.

    Q: (B, N, N, Lq, Lq) float32, block (a, b) the sparsified posterior
    of sequences a and b (zero-padded), block (b, a) its transpose, the
    diagonal blocks the identity: the tensor of the reference's
    ``_get_cons_fn`` (reveal_tpu/hmm/msa.py:336-381), whose einsum sums
    Q[a, z] @ Q[z, b] over every z.  Its terms z = a and z = b are I @ P
    and P @ I, which are P exactly, and block (b, a) is the transpose of
    block (a, b); so a round here computes, for the a<b blocks only,

        acc = (2 P_ab + sum over z not in {a, b} of P_az @ P_zb) / N

    (with ``consgap`` each z also adds the outer product of P_az's row
    gaps and P_zb's column gaps; the diagonal blocks' gaps are 0), z in
    ascending order as the host loop of ``probcons_align`` sums them:
    N(N-1)/2 (N-2) float32 products a round instead of N^3 (60 instead
    of 216 at N = 6).  Then the reference's mask (Q > 0) & (acc >=
    POSTERIOR_CUTOFF) and the block (b, a) written as the transpose; the
    diagonal blocks are never written.  The products are ``torch`` batched
    matrix products in float32 with TF32 off (``configure_torch``), as
    the reference left its einsum to XLA."""
    B, N, _, L, _ = Q.shape
    ai, bi = _pair_index(N, Q.device)
    npairs = ai.numel()
    others = [[z for z in range(N) if z not in (a, b)]
              for a, b in zip(ai.tolist(), bi.tolist())]
    zs = [torch.tensor([o[k] for o in others], device=Q.device)
          for k in range(N - 2)]
    for _ in range(rounds):
        P = Q[:, ai, bi]
        acc = P * 2.0
        flat = acc.view(B * npairs, L, L)
        if consgap:
            gx = 1.0 - Q.sum(dim=-1)  # row gaps of every block
            gy = 1.0 - Q.sum(dim=-2)  # column gaps
        for z in zs:
            flat.baddbmm_(Q[:, ai, z].reshape(-1, L, L),
                          Q[:, z, bi].reshape(-1, L, L))
            if consgap:
                flat.baddbmm_(gx[:, ai, z].reshape(-1, L, 1),
                              gy[:, z, bi].reshape(-1, 1, L))
        acc /= N
        new = torch.where((P > 0) & (acc >= POSTERIOR_CUTOFF), acc,
                          torch.zeros((), dtype=acc.dtype, device=Q.device))
        Q[:, ai, bi] = new
        Q[:, bi, ai] = new.transpose(-1, -2)
    return Q


def _chunks(idxs, N, Lq):
    """A bucket's problems cut so that one chunk's (B, N, N, Lq, Lq)
    tensor holds at most CHUNK_BYTES."""
    maxb = max(1, CHUNK_BYTES // max(1, N * N * Lq * Lq * 4))
    return [idxs[lo: lo + maxb] for lo in range(0, len(idxs), maxb)]


def _fetch_pairs(Q: torch.Tensor, seqs_list):
    """The a<b blocks of Q (B, N, N, Lq, Lq) as one mats dict a problem
    ((a, b) -> float32 array of (len(a) + 1, len(b) + 1)): the whole
    blocks below SPARSE_TRANSFER_MIN_WIDTH, above it their nonzero cells
    as per-row top-K (``pairhmm.compact_rows``; the relaxation's mask
    only shrinks the cut's pattern, so a row keeps at most 100 cells)."""
    B, N, _, Lq, _ = Q.shape
    ai, bi = _pair_index(N, Q.device)
    Qp = Q[:, ai, bi]
    keys = list(zip(ai.tolist(), bi.tolist()))
    if Lq < SPARSE_TRANSFER_MIN_WIDTH:
        dense = Qp.cpu().numpy()

        def block(b, k, la, lb):
            return dense[b, k, : la + 1, : lb + 1]
    else:
        cnt = (Qp > 0).sum(-1, dtype=torch.int32)
        v, i = compact_rows(Qp, cnt)
        cnt = cnt.cpu().numpy()

        def block(b, k, la, lb):
            return SparsePost(v[b, k, : la + 1], i[b, k, : la + 1],
                              cnt[b, k, : la + 1], (la + 1, lb + 1)).dense()
    return [
        {(a, b): block(bi_, k, len(seqs[a]), len(seqs[b]))
         for k, (a, b) in enumerate(keys)}
        for bi_, seqs in enumerate(seqs_list)
    ]


def batch_consistency(problems, consistency=2, consgap=False,
                      device="cuda"):
    """Stage 2 on ``device`` across many MSA problems.

    problems: list of (seqs, res) with res = [(posterior, total), ...]
    dense posteriors over the a<b pair list of seqs.  Returns one mats
    dict per problem ((a, b) -> sparsified float32 matrix), equal to
    probcons_align's host stage 2 up to float32 rounding, or ``None`` for
    a problem over CHAIN_BYTES_CAP.  Problems are bucketed by (N, padded
    L) and run a chunk at a time (reveal_tpu/hmm/msa.py:384-447)."""
    dev = resolve_device(device)
    out = [None] * len(problems)
    buckets = {}
    for pi, (seqs, res) in enumerate(problems):
        N = len(seqs)
        Lp = _bucket_len(max(len(s) for s in seqs) + 1)
        if N * N * Lp * Lp * 4 > CHAIN_BYTES_CAP:
            continue  # out[pi] stays None: probcons_align's own stage 2
        buckets.setdefault((N, Lp), []).append(pi)
    for (N, Lp), idxs in sorted(buckets.items()):
        for part in _chunks(idxs, N, Lp):
            Q = np.zeros((len(part), N, N, Lp, Lp), dtype=np.float32)
            Q[:, np.arange(N), np.arange(N)] = np.eye(Lp, dtype=np.float32)
            for bi, pi in enumerate(part):
                seqs, res = problems[pi]
                k = 0
                for a in range(N):
                    for b in range(a + 1, N):
                        sp = _sparsify(np.asarray(res[k][0]))
                        k += 1
                        Q[bi, a, b, : sp.shape[0], : sp.shape[1]] = sp
                        Q[bi, b, a, : sp.shape[1], : sp.shape[0]] = sp.T
            Qd = consistency_rounds(torch.from_numpy(Q).to(dev), consistency,
                                    consgap)
            for pi, mats in zip(part, _fetch_pairs(
                    Qd, [problems[pi][0] for pi in part])):
                out[pi] = mats
    return out


def _posteriors_device(pairs, Lq, dev):
    """Dense posteriors (len(pairs), Lq, Lq) of string pairs shorter than
    Lq, on ``dev``: ``pairhmm_dp.posterior_batch`` (zero outside 1..lx x
    1..ly) in batches of ``pairhmm_dp.batch_size``.  Returns (posteriors,
    batches)."""
    mB = batch_size(Lq, Lq, dev.type)
    if len(pairs) <= mB:
        return posterior_batch(*pack(pairs, Lq, Lq, dev))[0], 1
    out = torch.empty((len(pairs), Lq, Lq), dtype=torch.float32, device=dev)
    for lo in range(0, len(pairs), mB):
        part = pairs[lo: lo + mB]
        out[lo: lo + len(part)] = posterior_batch(*pack(part, Lq, Lq, dev))[0]
    return out, _ceil_div(len(pairs), mB)


def _chain(p: torch.Tensor, B: int, N: int, nrows: int, rounds: int,
           consgap: bool):
    """Stage 1+2 of one chunk on the device from its dense posteriors p
    (B * npairs, Lq, Lq), problem by problem and a<b pair by pair
    (reveal_tpu/hmm/msa.py:576-652): the MEA scores of the full
    posteriors over rows 1..nrows, then the cut at POSTERIOR_CUTOFF with
    row and column 0 cleared (in place on p), the (B, N, N, Lq, Lq)
    tensor and ``rounds`` relaxation rounds.  Returns (Q, scores (B,
    npairs))."""
    Lq = p.shape[-1]
    scores = mea_score(p, nrows)
    p.masked_fill_(p < POSTERIOR_CUTOFF, 0.0)
    p[:, 0, :] = 0.0
    p[:, :, 0] = 0.0
    ai, bi = _pair_index(N, p.device)
    P = p.view(B, ai.numel(), Lq, Lq)
    Q = torch.zeros((B, N, N, Lq, Lq), dtype=torch.float32, device=p.device)
    Q[:, ai, bi] = P
    Q[:, bi, ai] = P.transpose(-1, -2)
    d = torch.arange(N, device=p.device)
    Q[:, d, d] = torch.eye(Lq, dtype=torch.float32, device=p.device)
    del P
    return consistency_rounds(Q, rounds, consgap), scores.view(B, -1)


def batch_stage12_device(problems, consistency=2, consgap=False,
                         device="cuda", stats=None):
    """Device-resident ProbCons stages 1+2 across many MSA problems
    (reveal_tpu/hmm/msa.py:655-765).

    problems: list of seq-lists.  For each problem returns (mats, dist):
    the consistency-transformed sparse matrices ((a, b) -> float32 array
    of (len(a) + 1, len(b) + 1)) and the expected-accuracy distance
    matrix (N, N) for the guide tree, or ``None`` for a problem whose
    (N, N, Lq, Lq) chain tensor exceeds CHAIN_BYTES_CAP.  Posteriors never
    leave the device; the transformed matrices come back through
    ``_fetch_pairs``.  Problems are bucketed by (N, Lq = _bucket_len of
    the longest sequence + 1) and run a chunk at a time; a chunk's pairs
    go through the DP in batches of ``pairhmm_dp.batch_size``.  ``stats``,
    a dict, receives the chunks ("batches") and the DP batches
    ("dp_batches") run and the problems of each (N, Lq) ("shapes")."""
    dev = resolve_device(device)
    out = [None] * len(problems)
    buckets = {}
    for pi, seqs in enumerate(problems):
        N = len(seqs)
        if N < 2:
            out[pi] = ({}, np.zeros((N, N), dtype=np.float64))
            continue
        Lq = _bucket_len(max(len(s) for s in seqs) + 1)
        if N * N * Lq * Lq * 4 > CHAIN_BYTES_CAP:
            continue  # out[pi] stays None: the two-phase route
        buckets.setdefault((N, Lq), []).append(pi)
    chunks = dp_batches = 0
    for (N, Lq), idxs in sorted(buckets.items()):
        for part in _chunks(idxs, N, Lq):
            seqs_list = [problems[pi] for pi in part]
            pairs = [(seqs[a], seqs[b]) for seqs in seqs_list
                     for a in range(N) for b in range(a + 1, N)]
            p, nb = _posteriors_device(pairs, Lq, dev)
            Q, scores = _chain(p, len(part), N,
                               max(len(a) for a, _ in pairs), consistency,
                               consgap)
            del p
            mats_list = _fetch_pairs(Q, seqs_list)
            del Q
            scores = scores.cpu().numpy()
            for bi_, (pi, seqs, mats) in enumerate(
                    zip(part, seqs_list, mats_list)):
                dist = np.zeros((N, N), dtype=np.float64)
                k = 0
                for a in range(N):
                    for b in range(a + 1, N):
                        dist[a, b] = dist[b, a] = float(
                            scores[bi_, k]
                        ) / max(1, min(len(seqs[a]), len(seqs[b])))
                        k += 1
                out[pi] = (mats, dist)
            chunks += 1
            dp_batches += nb
    if stats is not None:
        stats.update(batches=chunks, dp_batches=dp_batches,
                     shapes={k: len(v) for k, v in buckets.items()})
    return out



# edit-op codes shared by the MEA DPs and _add_gaps: 0 = 'B' (both rows
# advance), 1 = 'Y' (second group advances), 2 = 'X' (first group advances)
OP_B, OP_Y, OP_X = 0, 1, 2



def _mea_dp(post: np.ndarray) -> Tuple[np.ndarray, float]:
    """MEA alignment DP over a (L1+1)x(L2+1) posterior; returns the edit
    ops (uint8 array of OP_B/OP_X/OP_Y per column) and the total score.

    Scalar reference implementation (differential oracle for the native
    kernel); tie-breaking matches ChooseBestOfThree: D >= L >= U.
    """
    L1 = post.shape[0] - 1
    L2 = post.shape[1] - 1
    old = np.zeros(L2 + 1, dtype=np.float32)
    # traceback: 0=D,1=L,2=U
    tb = np.zeros((L1 + 1, L2 + 1), dtype=np.uint8)
    tb[0, :] = 1  # 'L'
    for i in range(1, L1 + 1):
        tb[i, 0] = 2  # 'U'
        d = post[i, 1:] + old[:-1]
        u = old[1:]
        # c[j] = winner of D vs U at column j (D wins ties)
        c = np.where(d >= u, d, u)
        cb = np.where(d >= u, 0, 2).astype(np.uint8)
        # now fold in L (new[j-1]): new[j] = max(c[j], new[j-1]),
        # with D/U >= L on ties (ChooseBestOfThree checks x1>=x2 (D vs L)
        # first, then >= x3; L beats U on ties but D beats L)
        new = np.empty(L2 + 1, dtype=np.float32)
        new[0] = 0.0
        run = 0.0
        # running max with tie semantics: choose c[j] if c[j] >= run for
        # D-winner, or c[j] > run ... reference: x1=D, x2=L, x3=U.
        # D chosen if D>=L and D>=U; L chosen if L>D and L>=U; U otherwise.
        prev = 0.0
        for j in range(1, L2 + 1):
            dv = d[j - 1]
            lv = new[j - 1]
            uv = u[j - 1]
            if dv >= lv:
                if dv >= uv:
                    new[j] = dv
                    tb[i, j] = 0
                else:
                    new[j] = uv
                    tb[i, j] = 2
            elif lv >= uv:
                new[j] = lv
                tb[i, j] = 1
            else:
                new[j] = uv
                tb[i, j] = 2
        old = new
    total = float(old[L2])

    # traceback
    out = []
    r, c_ = L1, L2
    while r != 0 or c_ != 0:
        ch = tb[r, c_]
        if ch == 1:
            c_ -= 1
            out.append(OP_Y)
        elif ch == 2:
            r -= 1
            out.append(OP_X)
        else:
            r -= 1
            c_ -= 1
            out.append(OP_B)
    out.reverse()
    return np.array(out, dtype=np.uint8), total



def _mea_dp_fast(post: np.ndarray) -> Tuple[np.ndarray, float]:
    """MEA DP: native C++ kernel when available (identical float32
    arithmetic and tie order, native/esa.cpp mea_dp), else the
    row-vectorized numpy path.

    Exact same cell values and traceback choices as _mea_dp: within a row,
    new[j] = max(c[j], new[j-1]) where c[j] = max-with-D-preference(d, u);
    the L choice applies when new[j-1] > c[j] (strict, since D>=L wins for
    equality) — computed via running argmax over prefix maxima.
    """
    try:
        from ..native import mea_dp_native

        res = mea_dp_native(post)
        if res is not None:
            return res
    except Exception:
        pass
    L1 = post.shape[0] - 1
    L2 = post.shape[1] - 1
    old = np.zeros(L2 + 1, dtype=np.float32)
    tb = np.zeros((L1 + 1, L2 + 1), dtype=np.uint8)
    tb[0, :] = 1
    for i in range(1, L1 + 1):
        tb[i, 0] = 2
        d = post[i, 1:] + old[:-1]
        u = old[1:]
        c = np.where(d >= u, d, u)
        cb = np.where(d >= u, 0, 2).astype(np.uint8)
        # new[j] = max(new[j-1], c[j]) (all candidates >= 0; new[0]=0)
        m = np.maximum.accumulate(c)
        mprev = np.empty_like(m)
        mprev[0] = 0.0
        mprev[1:] = m[:-1]
        mprev = np.maximum(mprev, 0.0)
        # ChooseBestOfThree(d, l, u) tie order: pick L iff (l > d) and
        # (l >= u); given cb: when cb==D (d>=u) that is l > c; when cb==U
        # (u>d) that is l >= c
        use_l = np.where(cb == 0, mprev > c, mprev >= c)
        new = np.empty(L2 + 1, dtype=np.float32)
        new[0] = 0.0
        new[1:] = np.maximum(c, mprev)
        tb[i, 1:] = np.where(use_l, 1, cb)
        old = new
    total = float(old[L2])
    out = []
    r, c_ = L1, L2
    while r != 0 or c_ != 0:
        ch = tb[r, c_]
        if ch == 1:
            c_ -= 1
            out.append(OP_Y)
        elif ch == 2:
            r -= 1
            out.append(OP_X)
        else:
            r -= 1
            c_ -= 1
            out.append(OP_B)
    out.reverse()
    return np.array(out, dtype=np.uint8), total



class _Aln:
    """A (sub-)alignment: rows of gapped strings + original labels."""

    def __init__(self, labels: List[int], rows: List[str]):
        self.labels = labels
        self.rows = rows

    @property
    def length(self) -> int:
        return len(self.rows[0]) if self.rows else 0

    def mapping(self, r: int) -> np.ndarray:
        """mapping[k] = alignment column (1-based) of residue k (1-based),
        mapping[0]=0 (Sequence::GetMapping, Sequence.h:391-397)."""
        arr = np.frombuffer(self.rows[r].encode("latin1"), dtype=np.uint8)
        nz = np.nonzero(arr != ord("-"))[0]
        out = np.empty(len(nz) + 1, dtype=np.int64)
        out[0] = 0
        out[1:] = nz + 1
        return out



def _build_posterior(a1: _Aln, a2: _Aln, mats) -> np.ndarray:
    """BuildPosterior (ProbabilisticModel.h:1018-1089): sum sparse pairwise
    posteriors into alignment-column coordinates (one native batched
    scatter-add call when available, numpy fancy-index fallback)."""
    L1 = a1.length
    L2 = a2.length
    m1s = [a1.mapping(i) for i in range(len(a1.labels))]
    m2s = [a2.mapping(j) for j in range(len(a2.labels))]
    jobs = []
    for i, first in enumerate(a1.labels):
        for j, second in enumerate(a2.labels):
            if first < second:
                jobs.append((mats[(first, second)], i, j, False))
            else:
                jobs.append((mats[(second, first)], i, j, True))
    try:
        from ..native import build_posterior_native

        post = build_posterior_native(L1, L2 + 1, jobs, m1s, m2s)
        if post is not None:
            return post
    except Exception:  # pragma: no cover
        pass
    post = np.zeros((L1 + 1, L2 + 1), dtype=np.float32)
    for P, i, j, transpose in jobs:
        # scatter-add P[ii, jj] into post[m1[ii], m2[jj]]
        post[np.ix_(m1s[i], m2s[j])] += P.T if transpose else P
    return post



def _align_alignments(a1: _Aln, a2: _Aln, mats) -> Tuple["_Aln", float]:
    post = _build_posterior(a1, a2, mats)
    edit, total = _mea_dp_fast(post)
    rows1 = _add_gaps(a1.rows, edit, OP_X)
    rows2 = _add_gaps(a2.rows, edit, OP_Y)
    merged = _Aln(a1.labels + a2.labels, rows1 + rows2)
    # SortByLabel (Probcons.cc:1113-1114)
    order = np.argsort(np.array(merged.labels), kind="stable")
    merged = _Aln(
        [merged.labels[k] for k in order], [merged.rows[k] for k in order]
    )
    return merged, total



def _add_gaps(rows: List[str], edit: np.ndarray, keep: int) -> List[str]:
    """Sequence::AddGaps: expand rows by the edit ops; this group's
    characters advance on OP_B and `keep` columns, others insert '-'."""
    mask = (edit == OP_B) | (edit == keep)
    tmpl = np.full(len(edit), ord("-"), dtype=np.uint8)
    out = []
    for row in rows:
        buf = tmpl.copy()
        buf[mask] = np.frombuffer(row.encode("latin1"), dtype=np.uint8)
        out.append(buf.tobytes().decode("latin1"))
    return out



def _compute_tree(dist: np.ndarray) -> list:
    """Guide tree by repeated best-pair merging (EvolutionaryTree.h:104).
    Returns a nested tuple tree of leaf indices."""
    n = len(dist)
    d = dist.copy()
    valid = [True] * n
    nodes: List = list(range(n))
    for _ in range(n - 1):
        best = -1.0
        bp = None
        for i in range(n):
            if not valid[i]:
                continue
            for j in range(i + 1, n):
                if not valid[j]:
                    continue
                if d[i, j] > best:
                    best = d[i, j]
                    bp = (i, j)
        i, j = bp
        nodes[i] = (nodes[i], nodes[j])
        nodes[j] = None
        for k in range(n):
            if valid[k]:
                d[i, k] = d[k, i] = (d[k, i] + d[k, j]) * best / 2
        valid[j] = False
    return nodes[0]



# Use scipy-sparse host consistency above this many matrix elements
# (2048^2): beyond it one dense f64 L^2 x L^2 matmul costs ~Tflops while
# the cutoff keeps <=1/POSTERIOR_CUTOFF nonzeros per row.
_SPARSE_CONS_MIN_ELEMS = 2048 * 2048



def _consistency_round_sparse(mats, pair_keys, N, consgap):
    """One relaxation round with scipy.sparse csr products, equal to the
    dense round up to f64 summation order.  mats stay dense float32
    arrays for the downstream consumers (BuildPosterior / MEA)."""
    import scipy.sparse as sp

    csr = {
        k: (
            m.tocsr()
            if isinstance(m, SparsePost)
            else sp.csr_matrix(m.astype(np.float64))
        )
        for k, m in mats.items()
    }
    csc_t = {k: c.T.tocsr() for k, c in csr.items()}
    new_mats = {}
    for (a, b) in pair_keys:
        Ps = csr[(a, b)]
        shp = Ps.shape
        pi_, pj_ = Ps.nonzero()
        mask = sp.csr_matrix(
            (np.ones(len(pi_)), (pi_, pj_)), shape=shp
        )
        acc = 2.0 * Ps
        gap_vals = None
        for z in range(N):
            if z == a or z == b:
                continue
            Paz = csr[(a, z)] if a < z else csc_t[(z, a)]
            Pzb = csr[(z, b)] if z < b else csc_t[(b, z)]
            acc = acc + (Paz @ Pzb).multiply(mask)
            if consgap:
                pgx = 1.0 - np.asarray(Paz.sum(axis=1)).ravel()
                pgy = 1.0 - np.asarray(Pzb.sum(axis=0)).ravel()
                gv = pgx[pi_] * pgy[pj_]
                gap_vals = gv if gap_vals is None else gap_vals + gv
        if gap_vals is not None:
            acc = acc + sp.csr_matrix(
                (gap_vals, (pi_, pj_)), shape=shp
            )
        acc = acc.multiply(mask) / N
        dense = np.zeros(shp, dtype=np.float32)
        accc = acc.tocoo()
        dense[accc.row, accc.col] = accc.data.astype(np.float32)
        new_mats[(a, b)] = _sparsify(dense)
    return new_mats



def probcons_align(
    aobjs: Sequence[Tuple[str, str]],
    consistency: int = 2,
    refinement: int = 100,
    pretraining: int = 0,
    consgap: bool = False,
    seed: int = 0,
    precomputed=None,
    precomputed_scores=None,
    precomputed_mats=None,
    precomputed_dist=None,
):
    """Drop-in equivalent of probconslib.probcons().align(...)
    (Probcons.cc:1608-1713).  Returns ([(name, alnseq)...], conf list).

    precomputed: optional [(posterior, total), ...] for the (a<b) pair
    list, letting callers batch posterior computation across many MSA
    problems (e.g. all bubbles of a refinement pass) in one device call.
    precomputed_mats: optional consistency-transformed sparse matrices
    ((a, b) -> array) from batch_consistency — skips stage 2 here.
    precomputed_dist: optional (N, N) expected-accuracy distance matrix;
    together with precomputed_mats (batch_stage12_device) it skips
    stage 1 entirely — no posteriors ever reach the host.
    """
    del pretraining  # the binding accepts it; training is not reachable
    names = [n for n, s in aobjs]
    seqs = [s for n, s in aobjs]
    N = len(seqs)
    if N == 1:
        return [(names[0], seqs[0])], [0] * len(seqs[0])

    # ---- stage 1: all-pairs posteriors + expected-accuracy distances ----
    pair_keys = [(a, b) for a in range(N) for b in range(a + 1, N)]
    if precomputed_mats is not None and precomputed_dist is not None:
        mats = precomputed_mats
        dist = precomputed_dist
        consistency = 0
    else:
        if precomputed is not None:
            res = precomputed
            assert len(res) == len(pair_keys)
        else:
            res = batch_posteriors(
                [(seqs[a], seqs[b]) for a, b in pair_keys]
            )
        mats = {}
        dist = np.zeros((N, N), dtype=np.float64)
        for k, ((a, b), (p, tot)) in enumerate(zip(pair_keys, res)):
            # compact device transfers stay sparse until a consumer
            # actually needs dense (long pairs never densify)
            mats[(a, b)] = (
                p if isinstance(p, SparsePost) else _sparsify(p)
            )
            # expected-accuracy distance uses the dense posterior
            # (DoAlign, Probcons.cc:384-400); with the sparsified
            # transfer path the score comes precomputed from the device
            # (same cummax recurrence, pairhmm.fetch_posteriors_cut)
            if precomputed_scores is not None:
                score = precomputed_scores[k]
            else:
                edit, score = _mea_dp_fast(p)
            dist[a, b] = dist[b, a] = score / max(
                1, min(len(seqs[a]), len(seqs[b]))
            )

        if precomputed_mats is not None:
            mats = precomputed_mats
            consistency = 0

    # ---- stage 2: consistency transform ----
    # Dense f64 matmuls for typical bubble sizes; sparse (scipy csr)
    # triple products for long bubbles, where the cutoff leaves <=100
    # nonzeros per row — the reference's own representation
    # (SparseMatrix.h:14-67).  The relaxed value is only needed on P's
    # nonzero pattern (DoRelaxation masks to it, Probcons.cc:1203-1234).
    use_sparse = consistency > 0 and any(
        m.shape[0] * m.shape[1] > _SPARSE_CONS_MIN_ELEMS
        for m in mats.values()
    )
    if not use_sparse:
        # short pairs: the dense rounds (and stage 3) want ndarrays
        mats = {
            k: (m.dense() if isinstance(m, SparsePost) else m)
            for k, m in mats.items()
        }
    for _ in range(consistency):
        if use_sparse:
            mats = _consistency_round_sparse(mats, pair_keys, N, consgap)
            continue
        new_mats = {}
        for (a, b) in pair_keys:
            P = mats[(a, b)]
            acc = 2.0 * P.astype(np.float64)
            for z in range(N):
                if z == a or z == b:
                    continue
                Paz = mats[(a, z)] if a < z else mats[(z, a)].T
                Pzb = mats[(z, b)] if z < b else mats[(b, z)].T
                acc += Paz.astype(np.float64) @ Pzb.astype(np.float64)
                if consgap:
                    pgx = 1.0 - Paz.sum(axis=1)
                    pgy = 1.0 - Pzb.sum(axis=0)
                    acc += np.outer(pgx, pgy)
            acc /= N
            # mask to the previous sparsity pattern (DoRelaxation
            # Probcons.cc:1203-1234), then re-cutoff
            acc[P == 0] = 0
            new_mats[(a, b)] = _sparsify(acc.astype(np.float32))
        mats = new_mats

    # ---- stage 3+4: guide tree + progressive alignment ----
    tree = _compute_tree(dist)

    def process(node) -> _Aln:
        if isinstance(node, int):
            return _Aln([node], [seqs[node]])
        left = process(node[0])
        right = process(node[1])
        merged, _ = _align_alignments(left, right, mats)
        return merged

    aln = process(tree)

    # ---- stage 5: iterative refinement ----
    # the bipartition stream is drawn up front (identical rng call
    # sequence to the per-round draw) so the whole stage can run in one
    # native call: project + BuildPosterior + MEA + re-merge per round,
    # CSR posteriors, no per-round Python (DoIterativeRefinement,
    # Probcons.cc:1467-1490)
    rng = np.random.default_rng(seed)
    masks = np.stack(
        [rng.integers(0, 2, size=N) for _ in range(refinement)]
    ).astype(np.uint8) if refinement else np.zeros((0, N), np.uint8)
    aln = _refine_stage(aln, masks, mats, N)

    # ---- stage 6: column confidence ----
    conf = _annotation(aln, mats)

    rows_by_label = {l: r for l, r in zip(aln.labels, aln.rows)}
    return [(names[k], rows_by_label[k]) for k in range(N)], conf



def _project(aln: _Aln, group: List[int]) -> _Aln:
    """MultiSequence::Project (MultiSequence.h:653-700): drop all-gap
    columns of the sub-alignment."""
    idxs = [aln.labels.index(g) for g in sorted(group)]
    rows = [aln.rows[i] for i in idxs]
    mat = np.stack(
        [np.frombuffer(r.encode("latin1"), dtype=np.uint8) for r in rows]
    )
    keep = (mat != ord("-")).any(axis=0)
    sub = mat[:, keep]
    return _Aln(
        [aln.labels[i] for i in idxs],
        [sub[k].tobytes().decode("latin1") for k in range(sub.shape[0])],
    )



def _refine_once(aln: _Aln, g1, g2, mats) -> _Aln:
    a1 = _project(aln, g1)
    a2 = _project(aln, g2)
    merged, _ = _align_alignments(a1, a2, mats)
    return merged



def _refine_stage(aln: _Aln, masks: np.ndarray, mats, N: int) -> _Aln:
    """Run all refinement rounds: one native call when available
    (native.refine_rounds_native, bit-identical differential test in
    tests/test_msa.py), else the per-round Python loop."""
    if aln.labels == list(range(N)):
        try:
            from ..native import refine_rounds_native

            rows = np.stack(
                [
                    np.frombuffer(r.encode("latin1"), dtype=np.uint8)
                    for r in aln.rows
                ]
            ) if aln.length else np.zeros((N, 0), np.uint8)
            mats_list = [
                mats[(a, b)] for a in range(N) for b in range(a + 1, N)
            ]
            res = refine_rounds_native(rows, mats_list, masks)
            if res is not None:
                return _Aln(
                    list(range(N)),
                    [
                        res[k].tobytes().decode("latin1")
                        for k in range(N)
                    ],
                )
        except Exception:  # pragma: no cover
            pass
    for mask in masks:
        g1 = [k for k in range(N) if mask[k]]
        g2 = [k for k in range(N) if not mask[k]]
        if not g1 or not g2:
            continue
        aln = _refine_once(aln, g1, g2, mats)
    return aln



def _annotation(aln: _Aln, mats) -> List[int]:
    """ComputeAnnotation/ComputeScore (Probcons.cc:1545-1602), vectorized:
    conf[c] = int(200 * sum over active pairs of P[pos_a, pos_b]
                  / (n_active * (n_active - 1)))."""
    L = aln.length
    n = len(aln.rows)
    act = np.array(
        [[ch != "-" for ch in row] for row in aln.rows], dtype=bool
    )  # (n, L)
    pos = np.cumsum(act, axis=1)  # 1-based residue index where active
    val = np.zeros(L, dtype=np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            a, b = aln.labels[i], aln.labels[j]
            m = act[i] & act[j]
            if not m.any():
                continue
            if a < b:
                P = mats[(a, b)]
                val[m] += P[pos[i][m], pos[j][m]]
            else:
                P = mats[(b, a)]
                val[m] += P[pos[j][m], pos[i][m]]
    nact = act.sum(axis=0)
    denom = nact * (nact - 1)
    conf = np.where(denom > 0, 200 * val / np.maximum(denom, 1), 0.0)
    return [int(c) for c in conf]
