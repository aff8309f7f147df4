"""Peak memory of the port's mesh frontier stages per rank: O(n/P).

The counterpart of ``tests/test_mesh_memory.py`` (its bounds, :22-159):
there XLA's compiled temp sizes per device, here the peak of the live
tensor bytes a rank allocates inside one stage call, from the CPU
allocator's events under ``torch.profiler`` (``profile_memory=True``;
every allocation and free in order, their running sum's maximum).  A
gloo world of 8 ranks on the CPU holds the root layout of eight related
genomes of 32 kbp (npad 2^18, shards of 2^15 slots) and runs:

* the level apply, with 4,096 intervals of random classes over the text
  and a 4,096-row child map: below 64 int32 planes of npad/P, and below
  2/P of the single-device ``apply_level``'s peak on the same inputs;
* the multi enumeration (radius W = 8): below 150 int32 planes of
  npad/P;
* the window rows of K = 4,096 intervals: below 64 int32 planes of
  K * W.
"""

import numpy as np
import pytest
import torch

from reveal_tpu_torch.core.textstore import TextStore
from reveal_tpu_torch.index import devfrontier
from reveal_tpu_torch.index.suffix import build_esa
from reveal_tpu_torch.parallel.distributed import World

P = 8
NPAD = 1 << 18
NI = SCAP = K = 4096


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_memory_world")
    w = World(P, "file://%s" % (d / "store"), device="cpu", timeout=120)
    yield w
    w.close()


@pytest.fixture(scope="module")
def case():
    """The root of eight related genomes (seed 71) and one level's
    tables (seed 72)."""
    rng = np.random.default_rng(71)
    base = rng.choice(list("ACGT"), size=32_000)
    ts = TextStore()
    for s in range(8):
        seq = base.copy()
        hits = rng.integers(0, len(seq), size=320)
        seq[hits] = rng.choice(list("ACGT"), size=len(hits))
        ts.add_sample("g%d" % s)
        ts.add_sequence("".join(seq))
    T, SO, nsep = ts.build()
    SA, LCP, _sai = build_esa(T, "native")
    n = len(T)
    assert devfrontier._next_pow2(n) == NPAD
    rng = np.random.default_rng(72)
    cuts = np.sort(rng.choice(np.arange(1, n), size=NI - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    cls = rng.integers(1, 5, size=NI)
    intervals = [(int(b), int(e), int(c))
                 for b, e, c in zip(bounds[:-1], bounds[1:], cls)]
    seg_map = np.full((SCAP, 5), -1, dtype=np.int32)
    seg_map[0, [1, 2, 4]] = [1, 2, 3]
    matches = [(b, e) for b, e, c in intervals if c == 3]
    jobs = [(1, [b for b, _e in matches[:64]])]
    qlb = np.sort(rng.integers(0, NPAD - 8, size=K)).astype(np.int32)
    qub = (qlb + rng.integers(1, 8, size=K)).astype(np.int32)
    return dict(root=(T, SA, LCP, SO, int(nsep[0]), 8), nsep=nsep,
                level=(intervals, seg_map, matches, jobs), q=(qlb, qub))


def _peak(fn):
    """(fn's result, the peak of the tensor bytes allocated in it)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        out = fn()
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]"), key=lambda e: e.start_ns())
    now = peak = 0
    for e in events:
        now += e.nbytes()
        peak = max(peak, now)
    return out, peak


def stage_peaks(case):
    """This rank's peaks of the three mesh stages."""
    from reveal_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    f = devfrontier.DeviceFrontier(*case["root"], None, mesh=mesh,
                                   nsep=case["nsep"])
    kit = f.kit
    T, SA, LCP, SEG = f.T, f.SA, f.LCP, f.SEG
    nsep_d = f.nsep
    (rows, lm, ssid), multi = _peak(lambda: devfrontier.enumerate_multi_mesh(
        kit, T, SA, LCP, SEG, nsep_d, f.n, 20, 2, 8, 8))
    qlb, qub = (torch.from_numpy(x) for x in case["q"])
    _out, windows = _peak(lambda: devfrontier.multi_windows_mesh(
        kit, SA, lm, ssid, qlb, qub, 8, f.npad))
    _out, apply = _peak(lambda: f.apply_level(*case["level"]))
    return dict(multi=multi, windows=windows, apply=apply,
                sh=kit.sh, rows=rows.shape[1])


def test_mesh_stage_memory_per_rank(world, case):
    res = world.run(stage_peaks, case)
    single = devfrontier.DeviceFrontier(*case["root"], "cpu")
    _out, single_apply = _peak(lambda: single.apply_level(*case["level"]))
    plane = 4 * (NPAD // P)
    for rank, r in enumerate(res):
        assert r["sh"] == NPAD // P and r["rows"] > 0
        assert r["apply"] < 64 * plane, (rank, r)
        assert r["apply"] * P < 2 * single_apply, (rank, r, single_apply)
        assert r["multi"] < 150 * plane, (rank, r)
        assert r["windows"] < 64 * 4 * K * 8, (rank, r)
