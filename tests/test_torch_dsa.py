"""The distributed suffix-array build of the port (``reveal_tpu_torch/
parallel/dsa.py``) in a gloo world of 8 ranks on the CPU, against
``reveal_tpu``'s ``build_esa_distributed`` on the 8-virtual-device CPU
mesh, the numpy oracle, the port's device build and its native build.

One world of 8 processes serves the whole module (a ``file://`` store in
a temporary directory, a time limit on every call); a mesh of P < 8 ranks
is the subgroup of the first P.  The cases are those of
``tests/test_dsa.py``.  In place of its HLO inspection, every rank's
counts of what it posted show that the build really communicates: the
exchanges and all_gathers reckoned from the comparator network's layers
and the rounds run, and no exchanged array wider than 3 * sh.
"""

import math

import numpy as np
import pytest
import torch

from reveal_tpu.parallel import dsa as jax_dsa
from reveal_tpu.parallel.mesh import make_mesh as jax_make_mesh
from reveal_tpu_torch.index import suffix
from reveal_tpu_torch.parallel import dsa
from reveal_tpu_torch.parallel.distributed import World
from reveal_tpu_torch.parallel.mesh import make_mesh
import torch_support  # noqa: F401  (the thread budget)

WORLD = 8


def _mktext(rng, n, nseq=2):
    """Concatenated samples with $ sentinels, reveal text conventions."""
    parts = []
    per = max(1, n // nseq - 1)
    for _ in range(nseq):
        parts.append(rng.choice(list(b"ACGT"), size=per).astype(np.uint8))
        parts.append(np.frombuffer(b"$", dtype=np.uint8))
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("dsa_world")
    w = World(WORLD, "file://%s" % (d / "store"), device="cpu",
              timeout=120)
    yield w
    w.close()


_JAX = {"meshes": {}, "builds": {}}


def _jax_build(T, P, **kw):
    """``reveal_tpu``'s distributed build on a mesh of P virtual devices
    (one mesh a size, so that its compiled builds are reused)."""
    key = (T.tobytes(), P, tuple(sorted(kw.items())))
    if key not in _JAX["builds"]:
        mesh = _JAX["meshes"].setdefault(P, jax_make_mesh(P))
        _JAX["builds"][key] = jax_dsa.build_esa_distributed(T, mesh, **kw)
    return _JAX["builds"][key]


def _build(world, T, P=WORLD, **kw):
    """The port's build on the first P ranks: (SA, LCP, SAi) of rank 0,
    every member's arrays equal to it, and every rank's LAST_STATS."""
    res = world.run(dsa.build_on_world, T, n_devices=P, device="cpu",
                    **kw)
    assert all(r is None for r in res[P:])
    got = res[0][0]
    for r in res[1:P]:
        for a, b in zip(r[0], got):
            np.testing.assert_array_equal(a, b)
    return got, [r[1] for r in res[:P]]


def _hold(T, got, P=WORLD, jax=True):
    """Exactly the JAX build on P devices (unless ``jax`` is off), the
    numpy oracle, the port's device build (CPU) and its native build."""
    if jax:
        for a, b in zip(got, _jax_build(T, P)):
            np.testing.assert_array_equal(a, b)
    sa, lcp, sai = got
    np.testing.assert_array_equal(sa, suffix.suffix_array_np(T))
    np.testing.assert_array_equal(lcp, suffix.lcp_from_sa_np(T, sa))
    np.testing.assert_array_equal(sai[sa], np.arange(len(T)))
    for other in (suffix.build_esa_device(T, torch.device("cpu")),
                  suffix.build_esa(T, "native")):
        for a, b in zip(got, other):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,nseq", [(64, 1), (1000, 2), (4096, 3),
                                    (5000, 4)])
def test_dsa_matches_oracle(world, n, nseq):
    T = _mktext(np.random.default_rng(n), n, nseq)
    got, _ = _build(world, T)
    _hold(T, got)


@pytest.mark.parametrize("P", [2, 3, 4, 6])
def test_dsa_submesh_sizes(world, P):
    """Both network branches: P = 2 and 4 bitonic, 3 and 6 odd-even."""
    T = _mktext(np.random.default_rng(100 + P), 777, 2)
    got, _ = _build(world, T, P)
    _hold(T, got, P)


def test_dsa_with_n_runs(world):
    T = _mktext(np.random.default_rng(7), 900, 2)
    T[100:140] = ord("N")
    got, _ = _build(world, T)
    _hold(T, got)


def test_dsa_force64_matches_32(world):
    """The int64 twin (the path of texts of 2^29 slots or more) at a
    small size: the int32 build's arrays, and the JAX build's."""
    T = _mktext(np.random.default_rng(13), 700, 2)
    got32, st32 = _build(world, T)
    got64, st64 = _build(world, T, force64=True)
    assert st64[0]["int64"] and not st32[0]["int64"]
    for a, b in zip(got64, got32):
        np.testing.assert_array_equal(a, b)
    _hold(T, got64)


@pytest.mark.parametrize("stride", [1, 3, "sqrt", 100])
def test_dsa_lcp_ckpt_stride_matches_stored(world, stride):
    """Every s-th level kept and the rest regenerated on the descent
    gives the stored levels' arrays (1: all kept, 100: all regenerated
    from the byte ranks, 'sqrt': round(sqrt(nlev)))."""
    T = _mktext(np.random.default_rng(31), 1200, 3)
    got, st = _build(world, T, lcp_ckpt_stride=stride)
    nlev = st[0]["nlev"]
    assert st[0]["stride"] == (max(1, round(math.sqrt(nlev)))
                               if stride == "sqrt" else stride)
    stored, _ = _build(world, T)
    for a, b in zip(got, stored):
        np.testing.assert_array_equal(a, b)
    _hold(T, got)


def test_dsa_host_lcp_matches_device(world):
    """``host_lcp=True`` (the LCP recomputed on the host from the
    gathered SA) gives the arrays of the device descent, and of the JAX
    build with the same option."""
    T = _mktext(np.random.default_rng(37), 1100, 3)
    T[200:230] = ord("N")
    got, _ = _build(world, T, host_lcp=True)
    device, _ = _build(world, T)
    for a, b, c in zip(got, device, _jax_build(T, WORLD, host_lcp=True)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    _hold(T, got)


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """Without a device named, a world, a build on a world and a pipeline
    step go to the card, and with none visible they raise: nothing falls
    back to the CPU, and a world spawns no process first."""
    from reveal_tpu_torch.parallel.mesh import run_pipeline_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    T = _mktext(np.random.default_rng(5), 64, 1)
    with pytest.raises(RuntimeError, match="is_available"):
        World(2, "file://%s" % (tmp_path / "store"))
    assert not (tmp_path / "store").exists()
    with pytest.raises(RuntimeError, match="is_available"):
        dsa.build_on_world(T)
    z = np.zeros((1, 8), np.int32)
    with pytest.raises(RuntimeError, match="is_available"):
        run_pipeline_step(T, z, z, z, z.astype(np.uint8), z.astype(np.uint8),
                          z[0, :1], z[0, :1], 1)


def test_dsa_ckpt_stride_rejects_bad(world):
    T = _mktext(np.random.default_rng(1), 100, 1)
    with pytest.raises(RuntimeError, match="lcp_ckpt_stride must be"):
        world.run(dsa.build_on_world, T, device="cpu", lcp_ckpt_stride=0)
    with pytest.raises(ValueError, match="lcp_ckpt_stride must be"):
        dsa.build_esa_distributed(T, make_mesh(device="cpu"),
                                  lcp_ckpt_stride=0)


def test_dsa_rejects_zero_bytes(world):
    with pytest.raises(RuntimeError, match="byte 0"):
        world.run(dsa.build_on_world, np.zeros(16, np.uint8),
                  device="cpu")
    with pytest.raises(ValueError, match="byte 0"):
        dsa.build_esa_distributed(np.zeros(16, np.uint8),
                                  make_mesh(device="cpu"))
    # every rank raised before any collective: the world still works
    T = _mktext(np.random.default_rng(2), 64, 1)
    got, _ = _build(world, T)
    _hold(T, got)


@pytest.mark.parametrize("P", [8, 3])
def test_dsa_every_round_when_the_text_needs_it(world, P):
    """``A`` x 1,000 tells its suffixes apart only at prefix length 1,024:
    every doubling round runs.  A random text of the same size stops
    early with the same arrays as the JAX build, which runs every round."""
    T = np.full(1000, ord("A"), np.uint8)
    got, st = _build(world, T, P)
    assert st[0]["rounds"] == 10
    assert all(s["rounds"] == 10 for s in st)
    np.testing.assert_array_equal(got[0], suffix.suffix_array_np(T))
    np.testing.assert_array_equal(got[1], suffix.lcp_from_sa_np(T, got[0]))
    T = _mktext(np.random.default_rng(P), 1000, 2)
    got, st = _build(world, T, P)
    assert st[0]["rounds"] < st[0]["nlev"] - 1
    _hold(T, got, P)


def _reckon(P, me, sh, rounds, nlev, stride):
    """What rank ``me`` posts in a build of ``rounds`` rounds, from the
    comparator network of ``reveal_tpu``'s ``_network_layers(P)``: p2p
    exchanges, sends, receives and all_gathers."""
    per_sort = sum(1 for part, _ in jax_dsa._network_layers(P)
                   if part[me] != me)
    c = dict(p2p=0, sends=0, recvs=0, all_gathers=0)

    def perm(pairs):
        s = any(a == me for a, _ in pairs)
        r = any(b == me for _, b in pairs)
        c["p2p"] += s or r
        c["sends"] += s
        c["recvs"] += r

    def net_sort():
        for k in ("p2p", "sends", "recvs"):
            c[k] += per_sort

    def from_ahead(q):
        if 0 < q < P:
            perm([(j, j - q) for j in range(q, P)])

    def prev_halo():
        perm([(j, j + 1) for j in range(P - 1)])

    def doubling_round(lev):
        q, o = divmod(1 << lev, sh)
        from_ahead(q)
        if o:
            from_ahead(q + 1)
        net_sort()
        prev_halo()
        c["all_gathers"] += 1
        net_sort()

    for lev in range(rounds):
        doubling_round(lev)
    net_sort()  # SAi
    prev_halo()  # the descent's first suffixes
    regenerated = set()
    for lev in range(rounds, -1, -1):
        if stride and lev % stride:
            base = lev - lev % stride
            if base not in regenerated:
                regenerated.add(base)
                for j in range(base, lev):
                    doubling_round(j)
        net_sort()
        net_sort()
        c["all_gathers"] += 1
    c["all_gathers"] += 1  # the cap's carry
    net_sort()
    prev_halo()
    c["all_gathers"] += 1  # the shards to every rank
    return c


@pytest.mark.parametrize("P,stride", [(8, None), (6, None), (8, 3),
                                      (4, 100)])
def test_dsa_counts_its_collectives(world, P, stride):
    """Every rank posted the exchanges and all_gathers reckoned from the
    network's layers and the rounds run, and no array it exchanged was
    wider than 3 * sh (the gather's 3 * sh-wide blocks), so no rank ever
    holds the whole text."""
    T = _mktext(np.random.default_rng(40 + P), 3000, 3)
    got, st = _build(world, T, P, lcp_ckpt_stride=stride)
    _hold(T, got, P, jax=False)
    for me, s in enumerate(st):
        want = _reckon(P, me, s["sh"], s["rounds"], s["nlev"], stride)
        assert {k: s[k] for k in want} == want, me
        assert s["widest"] == 3 * s["sh"] < s["npad"]


@pytest.mark.parametrize("P", list(range(1, 17)) + [256])
def test_network_layers_equal_reference(P):
    assert dsa._network_layers(P) == jax_dsa._network_layers(P)


def test_network_layers_shapes():
    """Bitonic depth for power-of-two meshes, odd-even otherwise."""
    assert len(dsa._network_layers(8)) == 6
    assert len(dsa._network_layers(256)) == 36
    assert len(dsa._network_layers(6)) == 6
    for part, keep_low in dsa._network_layers(8):
        for i, p in enumerate(part):
            assert part[p] == i
            if p != i:
                assert keep_low[i] != keep_low[p]


def test_world_of_one_and_the_sharded_build():
    """In this process: ``make_mesh`` makes a gloo world of one, and
    ``build_esa_sharded`` (the distributed build: torch has no GSPMD)
    gives the arrays of ``reveal_tpu``'s GSPMD build on 8 devices."""
    from reveal_tpu.index.suffix import build_esa_sharded as jax_sharded

    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
    with pytest.raises(ValueError, match="a mesh of 2 ranks"):
        make_mesh(2, device="cpu")
    T = _mktext(np.random.default_rng(3), 1500, 3)
    got = suffix.build_esa_sharded(T, mesh)
    assert dsa.LAST_STATS["p2p"] == 0 and dsa.LAST_STATS["P"] == 1
    want = jax_sharded(T, _JAX["meshes"].setdefault(8, jax_make_mesh(8)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("env", [None, "2", "sqrt"])
def test_jax_dist_backend_reads_the_stride(monkeypatch, env):
    """``build_esa(T, "jax-dist", device="cpu")``: a world of one with the
    stride of ``REVEAL_TPU_DSA_LCP_STRIDE`` (as the reference reads it),
    the arrays of the native build; without a card and without a device
    named it raises, as the card is the default."""
    if env is None:
        monkeypatch.delenv("REVEAL_TPU_DSA_LCP_STRIDE", raising=False)
    else:
        monkeypatch.setenv("REVEAL_TPU_DSA_LCP_STRIDE", env)
    T = _mktext(np.random.default_rng(11), 2000, 2)
    got = suffix.build_esa(T, "jax-dist", device="cpu")
    nlev = dsa.LAST_STATS["nlev"]
    assert dsa.LAST_STATS["stride"] == {None: None, "2": 2}.get(
        env, max(1, round(math.sqrt(nlev))))
    for a, b in zip(got, suffix.build_esa(T, "native")):
        np.testing.assert_array_equal(a, b)
    with suffix.build_device("cpu"):
        for a, b in zip(suffix.build_esa(T, "jax-dist"), got):
            np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        suffix.build_esa(T, "jax-dist")
