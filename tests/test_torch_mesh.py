"""The port's mesh of ranks and sharded pipeline step
(``reveal_tpu_torch/parallel/mesh.py``, ``parallel/distributed.py``)
against ``reveal_tpu``'s on the 8-virtual-device CPU mesh.

``build_pipeline_step`` runs in a gloo world of 8 processes (one world
for the module, a ``file://`` store, a time limit on every call) on the
case of ``tests/test_mesh.py``: 16 pseudo-segments packed in 8 groups and
8 pairs.  The count equals the host scans, ``cells`` the sum of lx * ly,
the candidates the JAX step's, and the summed log-probability the JAX
step's and the float64 oracle's within ``LOGPROB_RTOL``.  The two-process
scenario of ``tests/test_distributed.py::test_two_host_mesh`` runs as two
processes that join a gloo world through ``init_distributed``.
"""

import textwrap

import numpy as np
import pytest

from reveal_tpu_torch.core.textstore import TextStore
from reveal_tpu_torch.hmm.pairhmm import _pad_with_dummy, posterior_oracle
from reveal_tpu_torch.index.frontier import pack_segments
from reveal_tpu_torch.index.mums import pairwise_mums
from reveal_tpu_torch.index.suffix import lcp_from_sa_np, suffix_array_np
from reveal_tpu_torch.parallel import dsa
from reveal_tpu_torch.parallel.distributed import World
from reveal_tpu_torch.parallel.mesh import make_mesh, run_pipeline_step
from torch_support import run_ranks

# the summed log-probability of 8 pairs of 24 x 28 bases (about -94 a
# pair): both steps sum float32 totals, each the end of a float32
# log-space DP over the pair's cells, in different orders; they and the
# float64 oracle agree within a few float32 roundings of the sum (1.2e-7
# of it against the oracle on the CPU)
LOGPROB_RTOL = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_world")
    w = World(8, "file://%s" % (d / "store"), device="cpu", timeout=120)
    yield w
    w.close()


@pytest.fixture(scope="module")
def case():
    """``tests/test_mesh.py:26``'s inputs, from the same seed."""
    rng = np.random.default_rng(21)
    base = "".join(rng.choice(list("ACGT"), size=500))
    mut = list(base)
    for _ in range(8):
        mut[int(rng.integers(0, len(mut)))] = "ACGT"[int(rng.integers(0, 4))]
    ts = TextStore()
    ts.add_sample("a")
    ts.add_sequence(base)
    ts.add_sample("b")
    ts.add_sequence("".join(mut))
    T, SO, nsep = ts.build()
    sa = suffix_array_np(T)
    lcp = lcp_from_sa_np(T, sa)
    nseg = 16
    segs = []
    for s in range(nseg):
        pos = np.arange(s, len(sa), nseg)
        csa = sa[pos]
        clcp = np.zeros(len(pos), dtype=np.int64)
        for j in range(1, len(pos)):
            clcp[j] = lcp[pos[j - 1] + 1: pos[j] + 1].min()
        segs.append((csa.astype(np.int32), clcp.astype(np.int32)))
    SA, LCP, SEG = pack_segments(segs, n_groups=8)
    want = sum(
        len(pairwise_mums(T, csa.astype(np.int64), clcp.astype(np.int64),
                          int(nsep[0]), minl=1))
        for csa, clcp in segs)
    B, L = 8, 32
    s1 = ["".join(rng.choice(list("ACGT"), size=24)) for _ in range(B)]
    s2 = ["".join(rng.choice(list("ACGT"), size=28)) for _ in range(B)]
    xb = np.stack([_pad_with_dummy(x.encode(), L) for x in s1])
    yb = np.stack([_pad_with_dummy(x.encode(), L) for x in s2])
    lx = np.array([len(x) for x in s1], dtype=np.int32)
    ly = np.array([len(x) for x in s2], dtype=np.int32)
    return dict(T=T, nsep0=int(nsep[0]), arrays=(T, SA, LCP, SEG, xb, yb,
                                                   lx, ly),
                want=want, pairs=list(zip(s1, s2)))


def _jax_step(case):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from reveal_tpu.parallel.mesh import build_pipeline_step, make_mesh

    mesh = make_mesh(8)
    axis = mesh.axis_names[0]
    T, SA, LCP, SEG, xb, yb, lx, ly = case["arrays"]
    shard = NamedSharding(mesh, P(axis))
    grouped = NamedSharding(mesh, P(axis, None))
    out = build_pipeline_step(mesh, nsep0=case["nsep0"])(
        jax.device_put(T, NamedSharding(mesh, P())),
        *(jax.device_put(x, grouped) for x in (SA, LCP, SEG, xb, yb)),
        jax.device_put(lx, shard), jax.device_put(ly, shard))
    return [np.asarray(x) for x in jax.block_until_ready(out)]


def test_pipeline_step_equals_the_jax_step(world, case):
    res = world.run(run_pipeline_step, *case["arrays"], case["nsep0"],
                    device="cpu")
    count, cl, cp, cells, logprob = res[0]
    for other in res[1:]:
        assert other[0] == count and other[3] == cells
        assert other[4] == logprob
        assert np.array_equal(other[1], cl) and np.array_equal(other[2], cp)
    j_count, j_cl, j_cp, j_cells, j_logprob = _jax_step(case)
    assert count == int(j_count) == case["want"]
    lx, ly = case["arrays"][6:]
    assert cells == int(j_cells) == int(np.sum(lx.astype(np.int64) * ly))
    assert cl.shape == (8 * 64,)
    np.testing.assert_array_equal(cl.numpy(), j_cl)
    np.testing.assert_array_equal(cp.numpy(), j_cp)
    oracle = sum(posterior_oracle(a, b)[1] for a, b in case["pairs"])
    for ref in (float(j_logprob), oracle):
        assert abs(logprob - ref) <= LOGPROB_RTOL * abs(ref), (logprob, ref)


def test_pipeline_step_in_a_world_of_one(case):
    """The same step on one rank in this process: one group of all 16
    segments and the whole batch."""
    from reveal_tpu_torch.index.frontier import pack_segments as pack

    T, SA, LCP, SEG = case["arrays"][:4]
    segs = []
    for g in range(8):
        for s in np.unique(SEG[g][SEG[g] >= 0]):
            keep = SEG[g] == s
            segs.append((SA[g][keep], LCP[g][keep]))
    SA1, LCP1, SEG1 = pack(segs, n_groups=1)
    count, cl, cp, cells, logprob = run_pipeline_step(
        T, SA1, LCP1, SEG1, *case["arrays"][4:], case["nsep0"],
        device="cpu")
    assert count == case["want"]
    lx, ly = case["arrays"][6:]
    assert cells == int(np.sum(lx.astype(np.int64) * ly))
    oracle = sum(posterior_oracle(a, b)[1] for a, b in case["pairs"])
    assert abs(logprob - oracle) <= LOGPROB_RTOL * abs(oracle)
    assert list(cl.numpy()) == sorted(cl.numpy(), reverse=True)
    with pytest.raises(ValueError, match="segment groups"):
        run_pipeline_step(T, SA, LCP, SEG, *case["arrays"][4:],
                          case["nsep0"], device="cpu")


def test_make_mesh_sizes(world):
    """``make_mesh(n)`` over the first n ranks of a world of 8 (None on
    the others); a world of one in this process."""
    T = np.frombuffer(b"ACGTTGCA$", np.uint8)
    for n in (1, 2, 4, 8):
        res = world.run(dsa.build_on_world, T, n_devices=n, device="cpu")
        assert [r is None for r in res] == [i >= n for i in range(8)]
        assert all(r[1]["P"] == n for r in res[:n])
    mesh = make_mesh(1, device="cpu")
    assert mesh.size == 1 and mesh.ranks == [0]
    with pytest.raises(RuntimeError, match="a mesh of 9 ranks"):
        world.run(dsa.build_on_world, T, n_devices=9, device="cpu")


WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from reveal_tpu_torch.parallel.distributed import (global_mesh,
                                                       init_distributed)
    from reveal_tpu_torch.parallel.dsa import dsa_shard
    from reveal_tpu_torch.parallel.mesh import make_mesh
    from reveal_tpu_torch.index.suffix import lcp_from_sa_np, suffix_array_np

    me = int(sys.argv[1])
    init_distributed(%(address)r, 2, me, device="cpu")
    mesh = global_mesh("cpu")
    assert (mesh.size, mesh.rank) == (2, me), mesh
    assert (make_mesh(1, "cpu") is None) == (me == 1)

    # per-shard candidate lengths -> all-reduced total + all_gather
    local = torch.arange(4, dtype=torch.int32) + 10 * (me + 1)
    total = local.sum()
    dist.all_reduce(total)
    got = [torch.empty_like(local) for _ in range(2)]
    dist.all_gather(got, local)
    want = sum(range(4)) + 4 * 10 + sum(range(4)) + 4 * 20
    assert int(total) == want, (int(total), want)
    assert torch.cat(got).tolist() == [10, 11, 12, 13, 20, 21, 22, 23]

    # the distributed build's shard body: each rank feeds its text shard
    # and checks its SA and LCP shards against the oracle's slices
    rng = np.random.default_rng(5)
    T = np.concatenate([
        rng.choice(list(b"ACGT"), size=63).astype(np.uint8),
        np.frombuffer(b"$", dtype=np.uint8),
    ])  # n = 64 = npad: no padding
    sh = 32
    sa_ref = suffix_array_np(T)
    lcp_ref = lcp_from_sa_np(T, sa_ref)
    T_local = torch.from_numpy(T[me * sh:(me + 1) * sh].copy())
    # stride None, 2 (levels regenerated mid-descent) and 4 twice (the
    # top level regenerated first, while the descent has no result yet)
    for stride in (None, 2, 4, 4):
        sa, sai, lcp = dsa_shard(T_local, mesh, sh, 7, False, stride)
        assert np.array_equal(sa.numpy(), sa_ref[me * sh:(me + 1) * sh]), (
            "SA shard, stride %%s, rank %%d" %% (stride, me))
        assert np.array_equal(lcp.numpy(), lcp_ref[me * sh:(me + 1) * sh]), (
            "LCP shard, stride %%s, rank %%d" %% (stride, me))
    dist.destroy_process_group()
    print("OK process", me)
    """
)


def test_two_process_world(tmp_path):
    """Two processes join one gloo group by ``init_distributed`` (a
    ``file://`` address): an all-reduce and an all_gather, then each
    rank's ``dsa_shard`` SA and LCP shards against the oracle's slices
    for LCP strides None, 2 and 4 (4 twice)."""
    fn = tmp_path / "worker.py"
    fn.write_text(WORKER % {"address": "file://%s" % (tmp_path / "store")})
    for i, p in enumerate(run_ranks(fn, 2, timeout=150)):
        assert p.returncode == 0, "process %d failed:\n%s" % (
            i, p.stdout + p.stderr)
        assert "OK process %d" % i in p.stdout
