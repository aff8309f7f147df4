"""The torch port's per-level device frontier, stage by stage, on the CPU.

Each device stage of ``reveal_tpu_torch/index/devfrontier.py`` is held
exactly against its JAX function on the same packed state: the states of
every level of small runs (a multi-contig pair, a repetitive pair, four
genomes), recorded as the port's frontier runs, and edge cases (the root
as one segment, no live segment, no candidate, empty tables).  The native
repair walk is held against the numpy walk on the repair jobs of a
repetitive run.  Every input is made from a numpy seed.
"""

import numpy as np
import pytest
import torch

import reveal_tpu.index.devfrontier as jax_df
from reveal_tpu_torch.align import rem as port_rem
from reveal_tpu_torch.index import devfrontier
from torch_support import four_genomes, multicontig_pair, repetitive_pair

CPU = torch.device("cpu")


def _frontier(fastas, **cfg):
    """``fastas`` through the port's frontier on the CPU."""
    ts, t, G, root_nodes = port_rem._read_inputs(fastas)
    idx = port_rem.ESAIndex.construct(ts, backend="native")
    idx.nodes = root_nodes
    port_rem._align_loop_frontier(G, t, idx, port_rem.PickerConfig(**cfg),
                                  CPU)
    return G, idx


def _np(x):
    return x.numpy().copy()


def _record(monkeypatch, make, **cfg):
    """Run the port's frontier on ``make``'s input and record every
    stage call: ("pw", inputs, outputs), ("mm", ...), ("apply", host
    arguments, state before, outputs)."""
    calls = []
    enum_pw = devfrontier.enumerate_pairwise
    enum_mm = devfrontier.enumerate_multi
    apply_method = devfrontier.DeviceFrontier.apply_level

    def pw(T, SA, LCP, SEG, nsep0, minl):
        out = enum_pw(T, SA, LCP, SEG, nsep0, minl)
        calls.append(("pw", [_np(a) for a in (T, SA, LCP, SEG)]
                      + [nsep0, minl], [_np(o) for o in out]))
        return out

    def mm(T, SA, LCP, SEG, SO, minl, minn, nsamples, W):
        out = enum_mm(T, SA, LCP, SEG, SO, minl, minn, nsamples, W)
        calls.append(("mm", [_np(a) for a in (T, SA, LCP, SEG, SO)]
                      + [minl, minn, nsamples, W], [_np(o) for o in out]))
        return out

    def apply(self, intervals, seg_map_rows, match_intervals,
              repair_jobs=()):
        before = [_np(a) for a in (self.T, self.SA, self.LCP, self.SEG)]
        counts, rcount = apply_method(self, intervals, seg_map_rows,
                                      match_intervals, repair_jobs)
        after = [_np(a) for a in (self.T, self.SA, self.LCP, self.SEG)]
        calls.append(("apply", (list(intervals), seg_map_rows.copy(),
                                list(match_intervals),
                                [(s, list(b)) for s, b in repair_jobs]),
                      (before, self.n), after + [counts, rcount]))
        return counts, rcount

    monkeypatch.setattr(devfrontier, "enumerate_pairwise", pw)
    monkeypatch.setattr(devfrontier, "enumerate_multi", mm)
    monkeypatch.setattr(devfrontier.DeviceFrontier, "apply_level", apply)
    _frontier(make, **cfg)
    return calls


def _jax_enum_pairwise(T, SA, LCP, SEG, nsep0, minl):
    import jax.numpy as jnp

    fn = jax_df._get_enum_pairwise(len(SA))
    slots, l, a, b, _valid, count = fn(
        *(jnp.asarray(x) for x in (T, SA, LCP, SEG)), jnp.int32(nsep0),
        jnp.int32(minl))
    count = int(count)
    return [np.asarray(x)[:count] for x in (slots, l, a, b)]


def _jax_enum_multi(T, SA, LCP, SEG, SO, minl, minn, nsamples, W):
    import jax.numpy as jnp

    fn = jax_df._get_enum_multi(len(SA), W)
    *rows, count = fn(*(jnp.asarray(x) for x in (T, SA, LCP, SEG, SO)),
                      jnp.int32(minl), jnp.int32(minn), jnp.int32(nsamples))
    count = int(count)
    return [np.asarray(x)[:count] for x in rows]


def _jax_apply(host_args, before, n):
    """The JAX ``DeviceFrontier.apply_level`` (its table padding and
    ``_get_apply``) on a frontier of ``n`` slots whose device state is
    ``before``."""
    import jax.numpy as jnp

    jf = jax_df.DeviceFrontier.__new__(jax_df.DeviceFrontier)
    jf.mesh = None
    jf.n = n
    jf.T, jf.SA, jf.LCP, jf.SEG = (jnp.asarray(x) for x in before)
    counts, rcount = jf.apply_level(*host_args)
    return [np.asarray(x) for x in (jf.T, jf.SA, jf.LCP, jf.SEG)] + [
        counts, rcount]


def _assert_apply_equal(got, want):
    for name, g, w in zip(("T", "SA", "LCP", "SEG"), got[:4], want[:4]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name, g, w in zip(("counts", "rcount"), got[4:], want[4:]):
        # the JAX tables are padded to a bucket: its tail counts nothing
        np.testing.assert_array_equal(g, w[:len(g)], err_msg=name)
        assert not w[len(g):].any(), name


CASES = {
    "multicontig-pair": (multicontig_pair, {}),
    "repetitive-pair": (repetitive_pair, {"minlength": 15}),
    "four-genomes": (four_genomes, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_stage_equals_its_jax_function(case, tmp_path, monkeypatch):
    """Every level's enumeration and apply of a run, on the state the
    port's frontier had there, equal the JAX functions exactly: the
    candidates (pairwise: the valid prefix; multi: every interval row
    with its ``ok`` flag) and the next layout, text, counts and repair
    counts."""
    make, cfg = CASES[case]
    calls = _record(monkeypatch, make(tmp_path), **cfg)
    kinds = [c[0] for c in calls]
    assert kinds.count("apply") >= 5
    assert kinds.count("mm" if case == "four-genomes" else "pw") >= 5
    repaired = 0
    for kind, args, out in ((c[0], c[1], c[2:]) for c in calls):
        if kind == "pw":
            for g, w in zip(out[0], _jax_enum_pairwise(*args)):
                np.testing.assert_array_equal(g, w)
        elif kind == "mm":
            for g, w in zip(out[0], _jax_enum_multi(*args)):
                np.testing.assert_array_equal(g, w)
        else:
            (before, n), got = out
            _assert_apply_equal(got, _jax_apply(args, before, n))
            repaired += int(got[5].sum() > 0)
    assert repaired > 0  # some level flags repair candidates


def _root_state(fastas):
    """The frontier's state at the root: one segment over the whole
    text."""
    ts, _t, _G, _nodes = port_rem._read_inputs(fastas)
    idx = port_rem.ESAIndex.construct(ts, backend="native")
    main = idx.main
    return devfrontier.DeviceFrontier(
        main.T, idx.SA, idx.LCP, main.SO, int(main.nsep[0]),
        main.nsamples, CPU), main


@pytest.mark.parametrize("minl", [20, 10**6])
def test_enumeration_edges_equal_jax(tmp_path, minl):
    """One segment over the whole text (the root), no candidate (a
    minimum length past every LCP), and no live segment (SEG all -1)."""
    for fastas in (multicontig_pair(tmp_path), four_genomes(tmp_path)):
        dev, main = _root_state(fastas)
        for SEG in (dev.SEG, torch.full_like(dev.SEG, -1)):
            if main.nsamples == 2:
                got = devfrontier.enumerate_pairwise(
                    dev.T, dev.SA, dev.LCP, SEG, dev.nsep0, minl)
                want = _jax_enum_pairwise(
                    *(_np(x) for x in (dev.T, dev.SA, dev.LCP, SEG)),
                    dev.nsep0, minl)
            else:
                W = max(2, dev.nsamples)
                got = devfrontier.enumerate_multi(
                    dev.T, dev.SA, dev.LCP, SEG, dev.SO, minl, 2,
                    dev.nsamples, W)
                want = _jax_enum_multi(
                    *(_np(x) for x in (dev.T, dev.SA, dev.LCP, SEG,
                                       dev.SO)), minl, 2, dev.nsamples, W)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_np(g), w)
            live = bool((SEG >= 0).any()) and minl == 20
            assert (len(got[0]) > 0) == live


def test_apply_with_empty_tables_equals_jax(tmp_path):
    """Empty interval, match and repair-key tables (the JAX tables hold
    only their padding): every slot dies, the text stays, nothing is
    counted."""
    dev, _main = _root_state(repetitive_pair(tmp_path))
    before = [_np(a) for a in (dev.T, dev.SA, dev.LCP, dev.SEG)]
    seg_map = np.full((1, 5), -1, np.int32)
    dev.apply_level([], seg_map, [], [])
    got = [_np(a) for a in (dev.T, dev.SA, dev.LCP, dev.SEG)]
    e32 = torch.zeros(0, dtype=torch.int32)
    *_, counts, rcount = devfrontier.apply_level(
        *(torch.from_numpy(x) for x in before), e32, e32, e32,
        torch.from_numpy(np.full((2, 5), -1, np.int32)), e32, e32,
        torch.zeros(0, dtype=torch.int64))
    want = _jax_apply(([], seg_map, [], []), before, dev.n)
    _assert_apply_equal(got + [_np(counts), _np(rcount)], want)
    assert (got[3] == -1).all() and not counts.any()


def test_native_repair_equals_the_numpy_walk(tmp_path, monkeypatch):
    """The native walk and the numpy walk leave the same SA and LCP: on
    every repair job of the repetitive pair at minlength 15, and on the
    whole root of its text with seeded match begins inside the repeats
    (where thousands of slots move)."""
    jobs = []
    native = devfrontier._repair_host

    def both(SA, LCP, begins, scratch=None):
        sa, lcp = SA.copy(), LCP.copy()
        native(SA, LCP, begins, scratch)
        devfrontier._repair_host_plain(sa, lcp, begins)
        jobs.append(int((sa != SA).sum()))
        np.testing.assert_array_equal(SA, sa)
        np.testing.assert_array_equal(LCP, lcp)

    fastas = repetitive_pair(tmp_path)
    monkeypatch.setattr(devfrontier, "_repair_host", both)
    _frontier(fastas, minlength=15)
    assert len(jobs) >= 5

    ts, _t, _G, _nodes = port_rem._read_inputs(fastas)
    idx = port_rem.ESAIndex.construct(ts, backend="native")
    rng = np.random.default_rng(5)
    moved = []
    for k in (1, 3, 5):
        begins = sorted(int(b) for b in rng.integers(1, 12 * 120, size=k))
        SA = idx.SA.astype(np.int64)
        LCP = idx.LCP.astype(np.int64)
        both(SA, LCP, begins)
        moved.append(int((SA != idx.SA).sum()))
    assert min(moved) > 100


def test_repair_raises_without_the_native_library(monkeypatch):
    """No quiet numpy walk: a missing native library raises."""
    import reveal_tpu_torch.native as native

    monkeypatch.setattr(native, "get_lib", lambda: None)
    SA = np.arange(8, dtype=np.int64)[::-1].copy()
    LCP = np.zeros(8, dtype=np.int64)
    with pytest.raises(RuntimeError, match="native repair walk"):
        devfrontier._repair_host(SA, LCP, [3])


def test_state_past_int32_is_refused(monkeypatch):
    """A text whose padded state would pass 2^30 slots (int32 sums of a
    slot's SA and LCP window could wrap) raises before anything moves."""
    monkeypatch.setattr(devfrontier, "_next_pow2", lambda _x: 2**31)
    one = np.zeros(4, np.int32)
    with pytest.raises(ValueError, match="2\\^30"):
        devfrontier.DeviceFrontier(one.astype(np.uint8), one, one, one, 1,
                                   2, CPU)
