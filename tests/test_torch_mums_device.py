"""The port's device pairwise-MUM scans on the CPU.

``reveal_tpu_torch.index.mums.pairwise_mums_device`` and
``reveal_tpu_torch.index.frontier`` (``pack_segments``,
``packed_mum_mask``, ``frontier_mums``) are held against their
``reveal_tpu`` counterparts on CPU JAX and against the host scan
``pairwise_mums`` (per segment), on the inputs of
``tests/test_suffix.py::test_device_mum_mask_matches_host`` and
``tests/test_frontier.py::test_packed_mask_matches_per_segment`` and on
larger seeded ones, over suffix arrays from the port's device doubling
build (``build_esa(T, "jax", device="cpu")``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reveal_tpu.index import frontier as jax_frontier
from reveal_tpu.index.mums import pairwise_mums_device as jax_pairwise
from reveal_tpu_torch.core.textstore import TextStore
from reveal_tpu_torch.index import frontier
from reveal_tpu_torch.index.mums import pairwise_mums, pairwise_mums_device
from reveal_tpu_torch.index.suffix import build_esa
import torch_support  # noqa: F401  (the thread budget)


def _pair_text(seed, n, nsubs, lower=False):
    """tests/test_suffix.py:118's input: a random base and a copy with
    ``nsubs`` substitutions, as two samples (at seed 4, 800, 12), with
    (``lower``) a lowercase stretch and an 'N' in each."""
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), size=n))
    mut = list(base)
    for _ in range(nsubs):
        mut[int(rng.integers(0, len(mut)))] = "ACGT"[int(rng.integers(0, 4))]
    mut = "".join(mut)
    ts = TextStore()
    for name, seq in (("a", base), ("b", mut)):
        ts.add_sample(name)
        ts.add_sequence(seq)
    T, _SO, nsep = ts.build()
    if lower:
        for lo in (n // 3, n + 1 + n // 2):
            T[lo: lo + 25] += ord("a") - ord("A")
            T[lo + 60] = ord("N")
    return T, int(nsep[0])


# (seed, length, substitutions, lowercase, minl)
PAIRS = [
    (4, 800, 12, False, 10),    # tests/test_suffix.py:118
    (3, 700, 10, False, 15),    # tests/test_frontier.py:65
    (11, 5_000, 120, True, 8),
    (12, 20_000, 400, True, 20),
    (13, 20_000, 60, False, 1),
]


def _host(T, sa, lcp, nsep0, minl):
    return sorted((m[0], m[2][0][1], m[2][1][1])
                  for m in pairwise_mums(T, sa, lcp, nsep0, minl=minl))


@pytest.mark.parametrize("seed,n,nsubs,lower,minl", PAIRS)
def test_pairwise_mums_device(seed, n, nsubs, lower, minl):
    T, nsep0 = _pair_text(seed, n, nsubs, lower)
    sa, lcp, _sai = build_esa(T, "jax", device="cpu")
    args = (T, sa.astype(np.int32), lcp.astype(np.int32))
    got = pairwise_mums_device(*(torch.from_numpy(x) for x in args), nsep0,
                               minl)
    want = jax_pairwise(*(jnp.asarray(x) for x in args), nsep0, minl)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert len(got[0]) > 0
    assert sorted(zip(*(x.tolist() for x in got))) == _host(
        T, sa, lcp, nsep0, minl)


def _segments(T, sa, lcp, labels, k):
    """The root's SA split into ``k`` pseudo-segments by ``labels`` (slot
    -> segment), each with its valid per-segment LCP (the running minimum
    over the parent's slots between two of its own, as
    tests/test_frontier.py:88-101 builds them)."""
    segs = []
    for s in range(k):
        pos = np.nonzero(labels == s)[0]
        clcp = np.zeros(len(pos), dtype=np.int64)
        if len(pos) > 1:
            # min(LCP[pos[j-1] + 1 : pos[j] + 1]) for every j >= 1
            clcp[1:] = np.minimum.reduceat(lcp[: pos[-1] + 1], pos[:-1] + 1)
        segs.append((sa[pos].astype(np.int32), clcp.astype(np.int32)))
    return segs


# (seed, length, substitutions, minl, segments: "interleaved" or a count
# of random labels)
FRONTIERS = [
    (3, 700, 10, 15, "interleaved"),   # tests/test_frontier.py:65
    (3, 700, 10, 4, "interleaved"),
    (21, 4_000, 80, 6, 3),
    (22, 20_000, 300, 10, 4),
]


def _labels(n, how, seed):
    if how == "interleaved":
        lab = np.ones(n, dtype=np.int64)
        lab[::2] = 0
        return lab, 2
    return np.random.default_rng(seed).integers(0, how, size=n), how


@pytest.mark.parametrize("seed,n,nsubs,minl,how", FRONTIERS)
def test_frontier_mums(seed, n, nsubs, minl, how):
    T, nsep0 = _pair_text(seed, n, nsubs)
    sa, lcp, _sai = build_esa(T, "jax", device="cpu")
    labels, k = _labels(len(sa), how, seed)
    segs = _segments(T, sa, lcp, labels, k)
    got = frontier.frontier_mums(segs, torch.from_numpy(T), nsep0, minl)
    assert got == jax_frontier.frontier_mums(segs, jnp.asarray(T), nsep0,
                                             minl)
    for (csa, clcp), mums in zip(segs, got):
        want = pairwise_mums(T, csa.astype(np.int64), clcp.astype(np.int64),
                             nsep0, minl=minl)
        assert sorted(mums) == sorted(want)
    if how != "interleaved" or minl < 15:
        assert sum(map(len, got)) > 0


def test_segments_helper_equals_the_loop():
    """``_segments``' vectorised LCPs equal tests/test_frontier.py's loop."""
    T, _ = _pair_text(21, 500, 10)
    sa, lcp, _sai = build_esa(T, "np")
    labels, k = _labels(len(sa), 3, 5)
    for s, (_csa, clcp) in enumerate(_segments(T, sa, lcp, labels, k)):
        pos = np.nonzero(labels == s)[0]
        want = [0] + [int(lcp[pos[j - 1] + 1: pos[j] + 1].min())
                      for j in range(1, len(pos))]
        assert clcp.tolist() == want


@pytest.mark.parametrize("n_groups", [1, 2, 3])
def test_packed_mum_mask_equals_jax(n_groups):
    """The packed mask over several groups (rows), slot by slot: mask,
    (l, a, b) where the mask is set, and the count."""
    T, nsep0 = _pair_text(23, 6_000, 150, lower=True)
    sa, lcp, _sai = build_esa(T, "jax", device="cpu")
    labels, k = _labels(len(sa), 5, 23)
    segs = _segments(T, sa, lcp, labels, k)
    SA, LCP, SEG = frontier.pack_segments(segs, n_groups=n_groups)
    want_packed = jax_frontier.pack_segments(segs, n_groups=n_groups)
    for g, w in zip((SA, LCP, SEG), want_packed):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    got = frontier.packed_mum_mask(
        torch.from_numpy(T), *(torch.from_numpy(x) for x in (SA, LCP, SEG)),
        nsep0, 6)
    want = jax_frontier._get_packed_mask_fn()(
        jnp.asarray(T), jnp.asarray(SA), jnp.asarray(LCP), jnp.asarray(SEG),
        jnp.int32(nsep0), jnp.int32(6))
    mask = got[0].numpy()
    assert np.array_equal(mask, np.asarray(want[0]))
    assert mask.sum() > 0
    for g, w in zip(got[1:4], want[1:4]):
        assert np.array_equal(g.numpy()[mask], np.asarray(w)[mask])
    assert int(got[4]) == int(want[4]) == int(mask.sum())


def test_pack_segments_shapes():
    """tests/test_frontier.py's shape check on the copy."""
    segs = [
        (np.arange(5, dtype=np.int32), np.zeros(5, np.int32)),
        (np.arange(3, dtype=np.int32), np.zeros(3, np.int32)),
    ]
    SA, LCP, SEG = frontier.pack_segments(segs, n_groups=2)
    assert SA.shape == LCP.shape == SEG.shape
    assert SA.shape[0] == 2
    assert (SA.shape[1] & (SA.shape[1] - 1)) == 0
    for si in range(2):
        assert len({g for g in range(2) if (SEG[g] == si).any()}) == 1
    assert (SEG == -1).sum() == SA.size - 8
    assert frontier.frontier_mums([], torch.zeros(1, dtype=torch.uint8),
                                  0, 1) == []
