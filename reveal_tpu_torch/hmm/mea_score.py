"""The MEA-score row scan of a batch of dense posteriors.

``mea_score(p, nrows)`` returns, for each pair of ``p`` (B, L1p, L2p)
float32, the expected-accuracy alignment score of the MEA DP (DoAlign,
probcons/Probcons.cc:384-400): ``old[-1]`` after rows 1..nrows of

    c[j] = max(p[r, j] + old[j-1], old[j]),  new = [0, cummax(c)],

from ``old = 0``.  It equals the score of the host ``msa._mea_dp_fast`` and
of the JAX chain's ``lax.scan`` (``reveal_tpu/hmm/msa.py:600-615``).  On a
CUDA tensor the wrapper launches the kernel of ``csrc/mea_score.cu`` (one
block a pair, the row loop inside it); on a CPU tensor it runs
``mea_score_plain``, the same recurrence as a loop over rows.  There is no
other route between the two.  One add a cell and maxima: the two give the
same bits for any finite input.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build

# kernel launches made by mea_score (CUDA tensors only)
LAUNCHES = 0


def _rows(p, nrows):
    return p.shape[1] - 1 if nrows is None else min(p.shape[1] - 1,
                                                    int(nrows))


def mea_score_plain(p: torch.Tensor, nrows=None) -> torch.Tensor:
    """The row scan as a loop over rows 1..nrows (all rows when None)."""
    B, _L1p, L2p = p.shape
    old = torch.zeros((B, L2p), dtype=torch.float32, device=p.device)
    zero = torch.zeros((B, 1), dtype=torch.float32, device=p.device)
    for r in range(1, _rows(p, nrows) + 1):
        c = torch.maximum(p[:, r, 1:] + old[:, :-1], old[:, 1:])
        old = torch.cat([zero, torch.cummax(c, dim=1).values], dim=1)
    return old[:, -1]


def plan(L2p: int):
    """(threads a block, float4s a thread) the kernel takes for rows of
    L2p columns; raises ValueError for a width it does not take."""
    threads, k4 = ctypes.c_int(), ctypes.c_int()
    if not build.load_library().rtt_mea_score_plan(
            L2p, ctypes.byref(threads), ctypes.byref(k4)):
        raise ValueError("the MEA-score kernel takes rows of a multiple of "
                         "4 columns, 4 to 29,040; got %d" % L2p)
    return threads.value, k4.value


def mea_score(p: torch.Tensor, nrows=None) -> torch.Tensor:
    """MEA score (B,) float32 of each pair of ``p`` (B, L1p, L2p) float32
    over rows 1..nrows (every row when None); rows beyond a pair's
    length must be zero, as the posteriors of ``pairhmm_dp`` are."""
    global LAUNCHES
    if p.dtype != torch.float32 or p.dim() != 3:
        raise TypeError("p must be a 3-D float32 tensor, got %s %s"
                        % (p.dtype, tuple(p.shape)))
    if not p.is_contiguous():
        raise ValueError("p must be contiguous")
    if p.device.type == "cpu":
        return mea_score_plain(p, nrows)
    if p.device.type != "cuda":
        raise ValueError("unsupported device %s" % p.device)
    B, L1p, L2p = p.shape
    out = torch.empty(B, dtype=torch.float32, device=p.device)
    if B == 0:
        return out
    plan(L2p)
    if p.data_ptr() % 16:
        raise ValueError("p must be 16-byte aligned")
    lib = build.load_library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.rtt_mea_score_f32(p.data_ptr(), out.data_ptr(), B, L1p,
                                    L2p, _rows(p, nrows), stream)
    build.check(err, "mea_score")
    LAUNCHES += 1
    return out
