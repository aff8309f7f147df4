"""Batched device frontier: pairwise MUM enumeration for MANY recursion
segments in one pass, in torch.

Port of ``reveal_tpu/index/frontier.py`` on one device.  The segments of
a frontier level are packed along one axis (each keeps its own SA/LCP
slice, tagged with a segment id) and the pairwise-MUM conditions
(reveal.c:119-180: straddle, left-maximality, uniqueness) are evaluated
elementwise over the packed arrays (``devfrontier.pair_mask``): one pass
a level instead of one host scan a segment.

Segment-boundary correctness falls out of the ESA invariants: every
segment's LCP[0] is 0, so a neighbor read that crosses into the next
segment's first slot reads 0, the value the per-segment scan uses at its
boundary.  Only the pair mask needs the explicit same-segment guard.
The groups of ``pack_segments`` are the reference's per-device rows: the
sharded pipeline step (``parallel/mesh.build_pipeline_step``) scores one
group a rank.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .devfrontier import pair_mask


def packed_mum_mask(T, SA, LCP, SEG, nsep0: int, minl: int):
    """(G, Lp) packed tensors -> per-slot MUM mask + (l, a, b) and the
    mask's count (``reveal_tpu``'s ``packed_mum_mask``, frontier.py:45-88).

    Slot (g, i) pairs SA[g, i-1] with SA[g, i]; valid only when both
    slots belong to the same segment (SEG equal, not padding)."""
    mask, a, b = pair_mask(T, SA, LCP, nsep0, minl, SEG)
    return mask, LCP, a, b, mask.sum(dtype=torch.int32)


def pack_segments(
    segments: List[Tuple[np.ndarray, np.ndarray]],
    n_groups: int = 1,
):
    """Pack per-segment (SA, LCP) arrays into (n_groups, Lp) int32 arrays
    plus a segment-id array (-1 = padding).  Whole segments only per
    group (largest-first balance), Lp padded to a power of two so jit
    recompiles stay bucketed."""
    order = sorted(
        range(len(segments)), key=lambda i: -len(segments[i][0])
    )
    groups = [[] for _ in range(n_groups)]
    gsize = [0] * n_groups
    for si in order:
        g = int(np.argmin(gsize))
        groups[g].append(si)
        gsize[g] += len(segments[si][0])
    width = max(1, max(gsize))
    Lp = 1
    while Lp < width:
        Lp *= 2
    SA = np.zeros((n_groups, Lp), dtype=np.int32)
    LCP = np.zeros((n_groups, Lp), dtype=np.int32)
    SEG = np.full((n_groups, Lp), -1, dtype=np.int32)
    for g, sids in enumerate(groups):
        o = 0
        for si in sids:
            sa, lcp = segments[si]
            k = len(sa)
            SA[g, o : o + k] = sa
            LCP[g, o : o + k] = lcp
            SEG[g, o : o + k] = si
            o += k
    return SA, LCP, SEG


def frontier_mums(
    segments: List[Tuple[np.ndarray, np.ndarray]],
    T_dev,
    nsep0: int,
    minl: int,
) -> List[list]:
    """One pass over a whole frontier level on the device of ``T_dev``
    (the text as a uint8 tensor): returns, per input segment, the
    getmums_rem-format list (l, 2, ((0, a), (1, b))) in slot order
    (``reveal_tpu``'s ``frontier_mums``, frontier.py:130-164)."""
    if not segments:
        return []
    SA, LCP, SEG = pack_segments(segments, n_groups=1)
    packed = torch.from_numpy(np.stack([SA, LCP, SEG])).to(T_dev.device)
    mask, l, a, b, _ = packed_mum_mask(T_dev, *packed, int(nsep0),
                                       int(minl))
    idx = torch.nonzero(mask.reshape(-1)).squeeze(1)
    seg, ls, aa, bb = (
        torch.stack([x.reshape(-1)[idx] for x in (packed[2], l, a, b)])
        .cpu().tolist())
    out = [[] for _ in segments]
    for s, li, ai, bi in zip(seg, ls, aa, bb):
        out[s].append((li, 2, ((0, ai), (1, bi))))
    return out
