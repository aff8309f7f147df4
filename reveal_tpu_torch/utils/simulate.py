"""Simulated genome populations for evaluation.

The host part of ``reveal_tpu/utils/simulate.py`` that generates data:
``mutate`` evolves a sequence with substitutions, indels and inversions
while tracking each base's ancestral identity, and
``simulate_population`` draws a population from one random ancestor.
The alignment-scoring and tool-comparison helpers of the reference
module are not part of this copy.
"""

from __future__ import annotations

import numpy as np


def mutate(
    seq_ids: np.ndarray,
    seq: np.ndarray,
    rng: np.random.Generator,
    subrate: float = 0.01,
    indelrate: float = 0.001,
    zipf_a: float = 1.7,
    maxindel: int = 1000,
):
    """One branch of evolution: returns (new_ids, new_seq).

    ids: int64 ancestral base ids (-1 for inserted material).
    """
    n = len(seq)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    # substitutions: change base, KEEP id (homology preserved like the
    # reference's `mut` which tracks ids through substitutions);
    # vectorized uniform pick among the 3 other bases
    nsub = rng.poisson(subrate * n)
    pos = rng.integers(0, n, size=nsub)
    seq = seq.copy()
    cur_idx = np.searchsorted(bases, seq[pos])
    new_idx = (cur_idx + 1 + rng.integers(0, 3, size=nsub)) % 4
    seq[pos] = bases[new_idx]

    # indels: one left-to-right pass over sorted event positions (a
    # per-event np.concatenate is O(n) each — terabytes of memcpy at
    # tens of Mbp), single concatenate at the end
    nind = rng.poisson(indelrate * n)
    epos = np.sort(rng.integers(0, n, size=nind))
    elen = np.minimum(rng.zipf(zipf_a, size=nind), maxindel).astype(int)
    edel = rng.random(size=nind) < 0.5
    pieces_seq = []
    pieces_ids = []
    ids = seq_ids
    cur = 0
    for p, l, isdel in zip(epos, elen, edel):
        p = int(max(p, cur))
        if p > n:
            break
        pieces_seq.append(seq[cur:p])
        pieces_ids.append(ids[cur:p])
        if isdel:
            cur = min(p + int(l), n)
        else:
            ins = bases[rng.integers(0, 4, size=int(l))]
            pieces_seq.append(ins)
            pieces_ids.append(np.full(int(l), -1, dtype=np.int64))
            cur = p
    pieces_seq.append(seq[cur:])
    pieces_ids.append(ids[cur:])
    return (
        np.concatenate(pieces_ids),
        np.concatenate(pieces_seq),
    )


def simulate_population(
    n: int,
    length: int,
    seed: int = 0,
    subrate: float = 0.01,
    indelrate: float = 0.001,
):
    """Random binary-ish tree: each leaf accumulates mutations from the
    ancestor.  Returns [(name, seq_str, ids)], ids per base."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    anc = bases[rng.integers(0, 4, size=length)]
    anc_ids = np.arange(length, dtype=np.int64)

    pop = [("anc", anc_ids, anc)]
    while len(pop) < n:
        name, ids, seq = pop[rng.integers(0, len(pop))]
        ids2, seq2 = mutate(ids, seq, rng, subrate, indelrate)
        pop.append(("g%d" % len(pop), ids2, seq2))
    out = []
    for name, ids, seq in pop[:n]:
        out.append((name, seq.tobytes().decode(), ids))
    return out

