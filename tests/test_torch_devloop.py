"""The port's device forest (reveal_tpu_torch/index/devloop.py) on the CPU.

The same deferred forest, from the native host prefix
``rem2_defer_native``, goes through the JAX package's
``rem_device_forest`` (JAX on the CPU) and through the port's (torch on
the CPU).  Subtrees, lowercased text, level count and the kernel's
counters must be equal exactly (all outputs are integers).  The cases are
those of tests/test_devloop.py.  The stage functions are also held
against numpy oracles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reveal_tpu.index.devloop as jax_devloop
from reveal_tpu.align.chaining import trim_overlap
from reveal_tpu.core.textstore import TextStore
from reveal_tpu.index.esa_index import ESAIndex
from reveal_tpu.native import rem2_defer_native
from reveal_tpu_torch.index import devloop
from torch_support import devloop_case

CPU = torch.device("cpu")
STAT_KEYS = (
    "levels", "dispatches", "anchors", "abort", "forest", "slots",
    "trim_steps", "chain_steps", "repair_steps",
)


def _defers(seqa, seqb, minlength):
    ts = TextStore()
    for name, seq in (("a", seqa), ("b", seqb)):
        ts.add_sample(name)
        ts.add_sequence(seq)
    idx = ESAIndex.construct(ts, backend="native")
    T = idx.main.T.copy()
    SAi = idx.main.SAi.copy()
    nsep0 = int(idx.main.nsep[0])
    res = rem2_defer_native(
        T, idx.SA, idx.LCP, SAi, nsep0, minlength, True, 10000, 1, 1.0,
        1e-8, 16, threads=1,
    )
    assert res is not None
    return T, res[1], nsep0


@pytest.mark.parametrize(
    "name",
    [
        "fuzz-3-2000-25", "fuzz-7-5000-60", "identical", "no_matches",
        "short_minlength", "repetitive-5", "repetitive-19",
    ],
)
def test_forest_matches_jax(name):
    seqa, seqb, minl = devloop_case(name)
    T, defers, nsep0 = _defers(seqa, seqb, minl)
    ref = jax_devloop.rem_device_forest(
        T.copy(), defers, nsep0, minl, 10000, 1, 1
    )
    ref_stats = dict(jax_devloop.LAST_STATS)
    got = devloop.rem_device_forest(
        T.copy(), defers, nsep0, minl, 10000, 1, 1, device=CPU
    )
    assert ref is not None and got is not None
    (rsub, rT, rlev), (gsub, gT, glev) = ref, got
    assert glev == rlev
    np.testing.assert_array_equal(gT, rT)
    assert sorted(gsub) == sorted(rsub)
    for did in rsub:
        np.testing.assert_array_equal(gsub[did], rsub[did])
    if defers:
        assert {k: devloop.LAST_STATS[k] for k in STAT_KEYS} == {
            k: ref_stats[k] for k in STAT_KEYS
        }
        assert devloop.LAST_STATS["abort"] == 0
    if name.startswith("repetitive"):
        # capacity retries ran; every dispatch's repair rounds count
        assert devloop.LAST_STATS["dispatches"] > 1
        assert (devloop.LAST_STATS["repair_rounds_total"]
                > devloop.LAST_STATS["repair_steps"])


# ----------------------------------------------------------------------
# stage functions against numpy oracles
# ----------------------------------------------------------------------
LENGTHS = [1, 2, 3, 5, 8, 33, 1000]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", LENGTHS)
def test_associative_scan_sum_wraps_like_int32(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-(2**31), 2**31, size=n, dtype=np.int64).astype(np.int32)

    def add(a, b):
        return (a[0] + b[0],)

    (got,) = devloop.associative_scan(add, (_t(x),))
    exp = np.cumsum(x.astype(np.int64)).astype(np.int32)  # wraps mod 2^32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("n", LENGTHS)
def test_segmented_scans(n):
    rng = np.random.default_rng(100 + n)
    v = rng.integers(-50, 50, size=n).astype(np.int32)
    f = rng.random(n) < 0.3
    mn = np.empty(n, np.int32)
    lv = np.empty(n, np.int32)
    for i in range(n):
        if i == 0 or f[i]:
            mn[i] = v[i]
        else:
            mn[i] = min(mn[i - 1], v[i])
        if f[i]:
            lv[i] = v[i]
        else:
            lv[i] = lv[i - 1] if i else v[0]
    # (last_value_scan leaves rows before the first flag at v[0])
    np.testing.assert_array_equal(
        devloop.seg_min_scan(_t(v), _t(f)).numpy(), mn)
    np.testing.assert_array_equal(
        devloop.last_value_scan(_t(v), _t(f)).numpy(), lv)


@pytest.mark.parametrize("n", [2, 7, 64, 1000, 4096])
def test_associative_scan_matches_jax_on_wrapping_combine(n):
    """Trim's clamped-subtract combine can wrap in int32 and is then not
    associative; the port's recursion must combine in JAX's order."""
    A30 = 2**30
    rng = np.random.default_rng(n)
    a = np.where(rng.random(n) < 0.8, A30,
                 rng.integers(1, 100, size=n)).astype(np.int32)
    b = rng.integers(0, 300, size=n).astype(np.int32)

    def comb_jax(x, y):
        (a1, b1), (a2, b2) = x, y
        return jnp.minimum(a1 + a2, A30), jnp.maximum(b1 - a2, b2)

    def comb_torch(x, y):
        (a1, b1), (a2, b2) = x, y
        return (a1 + a2).clamp(max=A30), torch.maximum(b1 - a2, b2)

    ra, rb = jax.lax.associative_scan(comb_jax, (jnp.asarray(a),
                                                 jnp.asarray(b)))
    ga, gb = devloop.associative_scan(comb_torch, (_t(a), _t(b)))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))


@pytest.mark.parametrize("n", [1, 17, 500])
def test_sort_by_is_lexsort(n):
    rng = np.random.default_rng(7 + n)
    k1 = rng.integers(-3, 3, size=n).astype(np.int32)
    k2 = rng.integers(-(2**31), 2**31, size=n, dtype=np.int64).astype(
        np.int32)
    k2[: n // 2] = 5  # ties on the first two keys
    iar = np.arange(n, dtype=np.int32)
    v = rng.integers(0, 1000, size=n).astype(np.int32)
    (got_v, got_k2) = devloop.sort_by(
        (_t(k1), _t(k2), _t(iar)), (_t(v), _t(k2))
    )
    order = np.lexsort((iar, k2, k1))
    np.testing.assert_array_equal(got_v.numpy(), v[order])
    np.testing.assert_array_equal(got_k2.numpy(), k2[order])


@pytest.mark.parametrize("seed", range(8))
def test_trim_dim_matches_host_trim_overlap(seed):
    """Both trim dimensions over a batch of segments == the host
    picker's trim_overlap (schemes.py:161-191) per segment."""
    rng = np.random.default_rng(seed)
    K = 256
    nseg = 12
    rows = []
    for s in range(nseg):
        m = int(rng.integers(0, 14))
        # distinct starts per coordinate avoid sort-key ties
        aa = rng.choice(np.arange(0, 400), size=m, replace=False)
        bb = rng.choice(np.arange(1000, 1400), size=m, replace=False)
        ll = rng.integers(1, 60, size=m)
        rows += [(s, int(l), int(a), int(b)) for l, a, b in zip(ll, aa, bb)]
    order = rng.permutation(len(rows))
    rows = [rows[i] for i in order]
    seg = np.full(K, devloop.BIG, np.int32)
    l = np.zeros(K, np.int32)
    a = np.zeros(K, np.int32)
    b = np.zeros(K, np.int32)
    for i, (s, li, ai, bi) in enumerate(rows):
        seg[i], l[i], a[i], b[i] = s, li, ai, bi
    st = (_t(seg), _t(l), _t(a), _t(b))
    s0, l0, a0, b0, n0 = devloop.trim_dim(*st, 0)
    s1, l1, a1, b1, n1 = devloop.trim_dim(s0, l0, a0, b0, 1)
    got = {}
    for s, li, ai, bi in zip(s1.tolist(), l1.tolist(), a1.tolist(),
                             b1.tolist()):
        if s < devloop.BIG:
            got.setdefault(s, []).append((li, ai, bi))
    exp = {}
    for s in range(nseg):
        mums = [(li, 2, ((0, ai), (1, bi)))
                for ss, li, ai, bi in rows if ss == s]
        out = trim_overlap(mums)
        if out:
            exp[s] = [(m[0], m[2][0][1], m[2][1][1]) for m in out]
    assert {s: sorted(v) for s, v in got.items()} == {
        s: sorted(v) for s, v in exp.items()
    }


def test_compact_and_scatter_drop():
    mask = _t(np.array([0, 1, 1, 0, 1, 0, 1], bool))
    np.testing.assert_array_equal(
        devloop.compact(mask, 3, 99).numpy(), [1, 2, 4])
    np.testing.assert_array_equal(
        devloop.compact(mask, 6, 99).numpy(), [1, 2, 4, 6, 99, 99])
    x = torch.arange(5, dtype=torch.int32)
    got = devloop.scatter_drop(
        x, _t(np.array([4, 5, -1, 0], np.int32)),
        _t(np.array([40, 50, 60, 70], np.int32)),
    )
    np.testing.assert_array_equal(got.numpy(), [70, 1, 2, 3, 40])
    np.testing.assert_array_equal(x.numpy(), [0, 1, 2, 3, 4])
