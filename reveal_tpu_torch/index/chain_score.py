"""The score pass of the multi loop's sum-of-pairs chain DP.

``chain_scores`` returns the (R, W + 1) int32 score plane of one level of
``devloop_multi.chain_dense_multi``: a sequential pass over the candidate
columns of every live segment row at once, column j seeing only the
columns before it (schemes.py:20-104, the sum-of-pairs gap cost).  On a
CUDA tensor it launches the kernel of ``csrc/chain_score_multi.cu`` (one
block a row, the column loop inside it: one launch a level); on a CPU
tensor it runs ``chain_scores_plain``, the same pass as a loop over
columns.  There is no other route between the two.  Integer arithmetic
that wraps as int32 and maxima: the two give the same bits.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .devloop import I32, NEG

# kernel launches made by chain_scores (CUDA tensors only)
LAUNCHES = 0


def pair_index(D, dev):
    """The path pairs (a, b), a < b, as two index tensors."""
    ia, ib = zip(*[(a, b) for a in range(D) for b in range(a + 1, D)])
    return (torch.tensor(ia, dtype=torch.long, device=dev),
            torch.tensor(ib, dtype=torch.long, device=dev))


def pair_pen(delta, pairs, hbp):
    """Sum over path pairs (a, b) present in the segment of
    |delta_a - delta_b|: ``delta`` (D, R, ...), ``pairs`` the index
    tensors of ``pair_index``, ``hbp`` (NPAIR, R)."""
    ia, ib = pairs
    t = torch.abs(delta[ia] - delta[ib])
    mask = hbp.reshape(hbp.shape + (1,) * (delta.dim() - 2))
    return torch.where(mask, t, 0).sum(0, dtype=I32)


def chain_scores_plain(dS, dE, dalb, dL, dwl, mulr, hbp, pairs, wp, W):
    """The score pass as a loop over the columns up to the widest live
    segment; column j only sees columns before it."""
    R = dL.shape[0]
    score = torch.full((R, W + 1), NEG, dtype=I32, device=dL.device)
    for j in range(W):
        if j == 0:
            mx = torch.full((R,), NEG, dtype=I32, device=dL.device)
        else:
            delta = dS[:, :, j, None] - dE[:, :, :j]          # (D, R, j)
            compat = dalb[:, :j] & (delta >= 0).all(0)
            tw = torch.where(compat,
                             score[:, :j] - wp * pair_pen(delta, pairs, hbp),
                             NEG)
            mx = tw.amax(dim=1)
        sc_new = torch.maximum(
            dwl[:, j], torch.where(mx > NEG // 2, mx + dL[:, j] * mulr, NEG)
        )
        score[:, j] = torch.where(dalb[:, j], sc_new, NEG)
    return score


def _check(dS, dE, dalb, dL, dwl, mulr, hbp, pairs, wp, W):
    if dS.dim() != 3:
        raise ValueError("dS must be (D, R, W + 1), got %s"
                         % (tuple(dS.shape),))
    D, R, W1 = dS.shape
    if W1 != W + 1 or W < 0:
        raise ValueError("planes of %d columns for W = %d" % (W1, W))
    if not 2 <= D <= 8:
        raise ValueError("D = %d paths; the chain takes 2 to 8" % D)
    if not -2**31 <= wp < 2**31:
        raise ValueError("wp %d is out of int32" % wp)
    npair = D * (D - 1) // 2
    ia, ib = pairs
    for name, t, dtype, shape in (
            ("dS", dS, I32, (D, R, W1)), ("dE", dE, I32, (D, R, W1)),
            ("dalb", dalb, torch.bool, (R, W1)), ("dL", dL, I32, (R, W1)),
            ("dwl", dwl, I32, (R, W1)), ("mulr", mulr, I32, (R,)),
            ("hbp", hbp, torch.bool, (npair, R)),
            ("pairs[0]", ia, torch.long, (npair,)),
            ("pairs[1]", ib, torch.long, (npair,))):
        if t.dtype != dtype:
            raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("%s has shape %s, expected %s"
                             % (name, tuple(t.shape), shape))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != dS.device:
            raise ValueError("%s is on %s, dS on %s"
                             % (name, t.device, dS.device))


def _on_card(t):
    """Whether ``t`` lies on a CUDA card: the kernel's route."""
    return t.device.type == "cuda"


def _launch(score, dS, dE, dalb, dL, dwl, mulr, hbp, pairs, wp, W):
    """One launch of the kernel, writing ``score`` whole."""
    D, R, _W1 = dS.shape
    lib = build.load_library()
    with torch.cuda.device(dS.device):
        stream = torch.cuda.current_stream(dS.device).cuda_stream
        err = lib.rtt_chain_score_multi_i32(
            dS.data_ptr(), dE.data_ptr(), dalb.data_ptr(), dL.data_ptr(),
            dwl.data_ptr(), mulr.data_ptr(), hbp.data_ptr(),
            pairs[0].data_ptr(), pairs[1].data_ptr(), score.data_ptr(),
            D, R, W, hbp.shape[0], wp, stream,
        )
    build.check(err, "chain_scores")


def chain_scores(dS, dE, dalb, dL, dwl, mulr, hbp, pairs, wp, W):
    """Score plane (R, W + 1) int32 of one level of the chain.

    ``dS``, ``dE``: (D, R, W + 1) int32 start and end of each candidate
    in each path (0 where the path is absent); ``dalb``: (R, W + 1) bool
    live candidates; ``dL``: (R, W + 1) int32 lengths; ``dwl``: (R, W +
    1) int32 weights of the link from the left pseudo; ``mulr``: (R,)
    int32 score a base; ``hbp``: (NPAIR, R) bool, path pair present;
    ``pairs``: ``pair_index(D)``; ``wp``: the gap penalty; ``W``: the
    real columns (column W is the pseudo column and stays NEG)."""
    global LAUNCHES
    wp = int(wp)
    _check(dS, dE, dalb, dL, dwl, mulr, hbp, pairs, wp, W)
    if not _on_card(dS):
        if dS.device.type != "cpu":
            raise ValueError("unsupported device %s" % dS.device)
        return chain_scores_plain(dS, dE, dalb, dL, dwl, mulr, hbp, pairs,
                                  wp, W)
    score = torch.empty((dL.shape[0], W + 1), dtype=I32, device=dL.device)
    if W == 0:
        return score.fill_(NEG)
    _launch(score, dS, dE, dalb, dL, dwl, mulr, hbp, pairs, wp, W)
    LAUNCHES += 1
    return score
