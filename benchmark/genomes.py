"""The one traffic generator: fasta inputs of a cell, made from the seed.

``simulate_population`` and ``mutate`` are a copy of the port's
``utils/simulate.py`` (itself the data half of REVEAL's
``utils/simulate.py``): a random ancestor, and each further genome drawn
from one already made by substitutions (kept homologous) and Zipf-sized
indels.  One departure: ``SHAPE_SEED`` fixes the tree and the sizes of
the events (how many, how long, which kind), so that every run seed
aligns the same amount of work, placed anew.
``write_inputs`` reads a configuration (how many genomes, the ancestor's
length, the mutation rates) and a traffic mix (how each genome is cut
into contigs) and writes one fasta a genome for one input of a run's
pool; the run's seed and the input's index make it, and the same pair
gives the same files.
"""

from __future__ import annotations

import os

import numpy as np

# the seed of the tree and of the events' sizes, the same for every run
SHAPE_SEED = 1


def mutate(
    seq_ids: np.ndarray,
    seq: np.ndarray,
    rng: np.random.Generator,
    subrate: float = 0.01,
    indelrate: float = 0.001,
    zipf_a: float = 1.7,
    maxindel: int = 1000,
    shape: np.random.Generator = None,
):
    """One branch of evolution: returns (new_ids, new_seq).

    ids: int64 ancestral base ids (-1 for inserted material).  ``shape``
    (default: ``rng``) draws the sizes: how many substitutions and indels,
    each indel's length and kind; ``rng`` draws where they fall and the
    bases.
    """
    shape = rng if shape is None else shape
    n = len(seq)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    # substitutions: change base, keep id; uniform pick among the 3 others
    nsub = shape.poisson(subrate * n)
    pos = rng.integers(0, n, size=nsub)
    seq = seq.copy()
    cur_idx = np.searchsorted(bases, seq[pos])
    new_idx = (cur_idx + 1 + rng.integers(0, 3, size=nsub)) % 4
    seq[pos] = bases[new_idx]

    # indels: one left-to-right pass over sorted event positions
    nind = shape.poisson(indelrate * n)
    epos = np.sort(rng.integers(0, n, size=nind))
    elen = np.minimum(shape.zipf(zipf_a, size=nind), maxindel).astype(int)
    edel = shape.random(size=nind) < 0.5
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
    shape_seed: int = None,
):
    """Random binary-ish tree: each leaf accumulates mutations from the
    ancestor.  Returns [(name, seq_str, ids)], ids per base.

    With ``shape_seed`` the tree and the sizes of every branch's events
    (counts, indel lengths and kinds) come from that seed and only the
    sequence (the ancestor's bases, where each event falls, the new bases)
    from ``seed``: every seed then gets the same sizes, placed anew."""
    rng = np.random.default_rng(seed)
    shape = rng if shape_seed is None else np.random.default_rng(shape_seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    anc = bases[rng.integers(0, 4, size=length)]
    anc_ids = np.arange(length, dtype=np.int64)

    pop = [("anc", anc_ids, anc)]
    while len(pop) < n:
        name, ids, seq = pop[shape.integers(0, len(pop))]
        ids2, seq2 = mutate(ids, seq, rng, subrate, indelrate, shape=shape)
        pop.append(("g%d" % len(pop), ids2, seq2))
    out = []
    for name, ids, seq in pop[:n]:
        out.append((name, seq.tobytes().decode(), ids))
    return out


def contig_bounds(length: int, fractions) -> list:
    """Cut points of a genome of ``length`` bases into contigs whose
    lengths are the given shares of it (the last takes the rest)."""
    bounds = [0]
    acc = 0.0
    for f in fractions[:-1]:
        acc += f
        bounds.append(int(round(acc * length)))
    bounds.append(length)
    return bounds


def write_fasta(path: str, records, width: int = 100) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(">%s\n" % name)
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")


def write_inputs(config: dict, traffic: dict, seed: int, workdir: str,
                 index: int = 0):
    """Input ``index`` of a run's pool: the cell's fastas in ``workdir``,
    one a genome.  Returns (paths, bases), bases being the sum of the
    sequence lengths."""
    pop = simulate_population(
        config["genomes"], config["genome_bp"], seed=[seed, index],
        subrate=config["subrate"], indelrate=config["indelrate"],
        shape_seed=SHAPE_SEED)
    fractions = traffic.get("contig_fractions") or [1.0]
    paths, bases = [], 0
    for name, seq, _ids in pop:
        cuts = contig_bounds(len(seq), fractions)
        recs = [(name if len(cuts) == 2 else "%s_%d" % (name, k + 1),
                 seq[lo:hi]) for k, (lo, hi) in enumerate(zip(cuts, cuts[1:]))]
        path = os.path.join(workdir, name + ".fa")
        write_fasta(path, recs)
        paths.append(path)
        bases += len(seq)
    return paths, bases
