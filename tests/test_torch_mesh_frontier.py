"""The port's mesh frontier (``reveal_tpu_torch/index/devfrontier.py``
with ``mesh=``) in a gloo world of 8 ranks on the CPU.

(a) Stage by stage: the port's single-device frontier runs an input on
the CPU while every call of its stages is recorded with the layout before
and after it (the root's enumeration at three (minlength, minn) of
``tests/test_mesh.py:154``'s four genomes, every later level, every
apply and every repair).  Each call is replayed on the same layout by the
JAX package's ``DeviceFrontier`` on its 8-virtual-device mesh (its mesh
functions, or the GSPMD ones where it takes those) and by the port's mesh
frontier on meshes of 1, 2, 3, 4 and 8 ranks (subgroups of the world):
the candidate rows in order, the counts, the next T/SA/LCP/SEG (the
shards gathered) and the repaired rows must equal the single-device
stage's bit for bit.  P = 3 pads the layout to a multiple of the ranks;
the tiny case (nine genomes of 6 bp) has shards narrower than the multi
enumeration's radius at P = 8.

(b) End to end: ``align_genomes(..., mesh=)`` on every rank of the world
(``rem_on_world``) on ``tests/test_mesh.py``'s pair (:115) and four
genomes (:197): every rank's node state and text equal to the JAX mesh
route on 8 virtual devices and to the JAX host engine, its GFA bytes to
the port's single-device per-level frontier's; ``align_seqs(..., mesh=)``
on the dry run's synthetic pair and three genomes, every rank's node
state and text equal to the port's single-device frontier's and the JAX
host engine's.

One world of 8 processes serves the module (a ``file://`` store in a
temporary directory, a time limit on every call).  The functions the
world runs are this module's (its ranks import it by name; nothing of the
JAX package is imported at module level).
"""

import copy

import numpy as np
import pytest
import torch

from reveal_tpu_torch.align import rem as port_rem
from reveal_tpu_torch.core.io_fasta import fasta_writer
from reveal_tpu_torch.index import devfrontier
from reveal_tpu_torch.parallel import dryrun
from reveal_tpu_torch.parallel.distributed import World
import torch_support  # noqa: F401  (the thread budget)

CPU = torch.device("cpu")
WORLD = 8
MESHES = (1, 2, 3, 4, 8)
STAGES = ("enumerate_pairwise", "enumerate_multi", "apply_level",
          "repair_children")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_frontier_world")
    w = World(WORLD, "file://%s" % (d / "store"), device="cpu",
              timeout=120)
    yield w
    w.close()


def _random(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def _write(d, seqs, stem):
    fas = []
    for k, seq in enumerate(seqs):
        fa = str(d / ("%s%d.fa" % (stem, k)))
        fasta_writer(fa, [("%s%d" % (stem, k), seq)])
        fas.append(fa)
    return fas


def four_genomes_47(d):
    """``tests/test_mesh.py:154``'s four genomes of 1.5 kbp (seed 47)."""
    rng = np.random.default_rng(47)
    base = _random(rng, 1500)
    seqs = []
    for _ in range(4):
        seq = list(base)
        for _ in range(12):
            i = int(rng.integers(0, len(seq)))
            r = rng.random()
            if r < 0.6:
                seq[i] = "ACGT"[int(rng.integers(0, 4))]
            elif r < 0.8:
                del seq[i]
            else:
                seq.insert(i, "ACGT"[int(rng.integers(0, 4))])
        seqs.append("".join(seq))
    return _write(d, seqs, "s")


def pair_31(d):
    """``tests/test_mesh.py:115``'s pair of 5 kbp (seed 31)."""
    rng = np.random.default_rng(31)
    base = _random(rng, 5000)
    mut = list(base)
    for _ in range(40):
        i = int(rng.integers(0, len(mut)))
        if rng.random() < 0.5:
            mut[i] = "ACGT"[int(rng.integers(0, 4))]
        else:
            del mut[i]
    return _write(d, [base, "".join(mut)], "p")


def four_genomes_53(d):
    """``tests/test_mesh.py:197``'s four genomes of 2.5 kbp (seed 53)."""
    rng = np.random.default_rng(53)
    base = _random(rng, 2500)
    seqs = []
    for _ in range(4):
        seq = list(base)
        for _ in range(15):
            i = int(rng.integers(0, len(seq)))
            if rng.random() < 0.5:
                seq[i] = "ACGT"[int(rng.integers(0, 4))]
            else:
                del seq[i]
        seqs.append("".join(seq))
    return _write(d, seqs, "m")


def nine_tiny(d):
    """Nine genomes of 6 bp (seed 61): 63 slots in 64, so a mesh of 8 has
    shards of 8 slots, narrower than the multi enumeration's radius 9."""
    rng = np.random.default_rng(61)
    base = list(_random(rng, 6))
    seqs = []
    for _ in range(9):
        seq = list(base)
        seq[int(rng.integers(0, 6))] = "ACGT"[int(rng.integers(0, 4))]
        seqs.append("".join(seq))
    return _write(d, seqs, "t")


# case: (input, the frontier's options)
CASES = {
    "four-20-2": (four_genomes_47, dict(minlength=20, minn=2)),
    "four-10-3": (four_genomes_47, dict(minlength=10, minn=3)),
    "four-8-4": (four_genomes_47, dict(minlength=8, minn=4)),
    "pair": (pair_31, {}),
    "tiny": (nine_tiny, dict(minlength=2)),
}


def _single_frontier(fastas, **cfg):
    """``fastas`` through the port's per-level frontier on the CPU: (G,
    idx, node state, GFA bytes)."""
    ts, t, G, root_nodes = port_rem._read_inputs(fastas)
    idx = port_rem.ESAIndex.construct(ts, backend="native")
    idx.nodes = root_nodes
    port_rem._align_loop_frontier(G, t, idx, port_rem.PickerConfig(**cfg),
                                  CPU)
    state = port_rem.node_state(G)
    gfa = port_rem.write_rem_gfa(G, idx, fastas[0] + ".frontier.gfa")
    return G, idx, state, gfa


def _record(fastas, **cfg):
    """Run the port's single-device frontier on ``fastas`` and record its
    root arrays and every stage call: (stage, layout before, arguments,
    result, layout after)."""
    F = devfrontier.DeviceFrontier
    orig = {name: getattr(F, name) for name in STAGES + ("__init__",)}
    root, calls = {}, []

    def init(self, T, SA, LCP, SO, nsep0, nsamples, device, stats=None):
        root.update(args=tuple(np.array(x) for x in (T, SA, LCP, SO))
                    + (nsep0, nsamples))
        orig["__init__"](self, T, SA, LCP, SO, nsep0, nsamples, device,
                         stats)

    def recorder(name):
        def stage(self, *args):
            before = self.state()
            args = copy.deepcopy(args)
            out = orig[name](self, *copy.deepcopy(args))
            calls.append((name, before, args, copy.deepcopy(out),
                          self.state()))
            return out
        return stage

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "__init__", init)
        for name in STAGES:
            mp.setattr(F, name, recorder(name))
        _G, idx, _state, _gfa = _single_frontier(fastas, **cfg)
    root["nsep"] = np.array(idx.main.nsep)
    return root, calls


def replay_on_mesh(P, root, calls):
    """This rank's replay of ``calls`` on a mesh frontier of the first P
    ranks (None on the others): each call's result and the gathered
    layout after it, and the frontier's stats."""
    from reveal_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(P, "cpu")
    if mesh is None:
        return None
    f = devfrontier.DeviceFrontier(*root["args"], None, mesh=mesh,
                                   nsep=root["nsep"])
    outs = []
    for name, before, args, _out, _after in calls:
        f.load(*before)
        outs.append((getattr(f, name)(*copy.deepcopy(args)), f.state()))
    return outs, dict(f.stats)


def _jax_replay(root, calls):
    """The same calls on the JAX package's ``DeviceFrontier`` over its
    8-virtual-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    import reveal_tpu.index.devfrontier as jax_df
    from reveal_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    shard = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
    jf = jax_df.DeviceFrontier(*root["args"], mesh=mesh, nsep=root["nsep"])
    outs = []
    for name, before, args, _out, _after in calls:
        jf.T, jf.SA, jf.LCP, jf.SEG = (
            jax.device_put(jnp.asarray(x), shard) for x in before)
        out = getattr(jf, name)(*copy.deepcopy(args))
        outs.append((out, [np.asarray(x) for x in (jf.T, jf.SA, jf.LCP,
                                                   jf.SEG)]))
    return outs


def _assert_call_equal(name, got, want, what):
    (g_out, g_state), (w_out, w_state) = got, want
    if name.startswith("enumerate"):
        assert len(g_out) == len(w_out), what
        for k, (g, w) in enumerate(zip(g_out, w_out)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg="%s output %d" % (what, k))
    elif name == "apply_level":
        # per child id; the tables' padding counts nothing
        for k, (g, w) in enumerate(zip(g_out, w_out)):
            m = min(len(g), len(w))
            np.testing.assert_array_equal(g[:m], w[:m],
                                          err_msg="%s output %d" % (what, k))
            assert not np.any(g[m:]) and not np.any(w[m:]), what
    for k, (g, w) in enumerate(zip(g_state, w_state)):
        np.testing.assert_array_equal(g, w, err_msg="%s %s" % (
            what, ("T", "SA", "LCP", "SEG")[k]))


_CACHE = {}


def _recorded(case, tmp_path_factory):
    """(root, calls, the JAX replay) of a case, made once a module."""
    if case not in _CACHE:
        make, cfg = CASES[case]
        d = tmp_path_factory.mktemp("case_" + case)
        root, calls = _record(make(d), **cfg)
        _CACHE[case] = (root, calls, _jax_replay(root, calls))
    return _CACHE[case]


@pytest.mark.parametrize("P", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_stages_equal_single_device_and_jax(world, case, P,
                                                  tmp_path_factory):
    root, calls, jax_outs = _recorded(case, tmp_path_factory)
    kinds = [c[0] for c in calls]
    enum = "enumerate_pairwise" if case == "pair" else "enumerate_multi"
    assert kinds.count(enum) >= 2 and kinds.count("apply_level") >= 2
    if case != "tiny":
        assert kinds.count("repair_children") >= 1
    res = world.run(replay_on_mesh, P, root, calls)
    assert all(r is None for r in res[P:])
    for rank, (outs, stats) in enumerate(res[:P]):
        assert len(outs) == len(calls)
        for k, (call, got, jx) in enumerate(zip(calls, outs, jax_outs)):
            name, _before, _args, out, after = call
            want = (out, after)
            what = "%s P=%d rank %d call %d %s" % (case, P, rank, k, name)
            _assert_call_equal(name, got, want, what)
            _assert_call_equal(name, jx, want, what + " (JAX mesh)")
        assert stats["mesh_P"] == P and stats["mesh_replicated"] == 0
        assert stats["mesh_padded"] == P * stats["mesh_sh"] - len(
            calls[0][1][1])
        if P == 1:
            assert stats["p2p"] == 0
        else:
            assert stats["p2p"] > 0 and stats["all_reduces"] > 0
    if case == "tiny" and P == 8:
        # shards of 8 slots padded to the radius: 9 slots a rank
        assert res[0][1]["mesh_sh"] == 9


def test_mesh_multi_without_sentinel_table(world, tmp_path_factory):
    """Without ``nsep`` every multi enumeration gathers the layout and
    runs the single-device stage on every rank (counted): the same
    rows."""
    root, calls, _jx = _recorded("four-10-3", tmp_path_factory)
    root = dict(root, nsep=None)
    calls = [c for c in calls if c[0] == "enumerate_multi"]
    res = world.run(replay_on_mesh, 4, root, calls)
    for outs, stats in res[:4]:
        for call, got in zip(calls, outs):
            _assert_call_equal(call[0], got, (call[3], call[4]), "no nsep")
        assert stats["mesh_replicated"] == len(calls)


# ----------------------------------------------------------------------
# (b) end to end
# ----------------------------------------------------------------------

def _jax_state(G):
    return sorted(
        (n, tuple(sorted((int(k), int(v)) for k, v in
                         G.nodes[n]["offsets"].items())),
         int(G.nodes[n].get("aligned", 0)))
        for n in G.nodes if isinstance(n, tuple))


@pytest.mark.parametrize("make", [pair_31, four_genomes_53],
                         ids=["pair-31", "four-53"])
def test_mesh_align_genomes(world, make, tmp_path):
    from reveal_tpu.align.rem import align_genomes as jax_align
    from reveal_tpu.parallel.mesh import make_mesh as jax_make_mesh

    fas = make(tmp_path)
    res = world.run(port_rem.rem_on_world, fas, device="cpu")
    _G, idx, state, gfa = _single_frontier(fas)
    Gm, im = jax_align(fas, backend="np", mesh=jax_make_mesh(8))
    Gh, ih = jax_align(fas, backend="np")
    assert _jax_state(Gm) == _jax_state(Gh) == state
    for T in (im.main.T, ih.main.T):
        np.testing.assert_array_equal(T, idx.main.T)
    for rank, r in enumerate(res):
        assert r["state"] == state, rank
        np.testing.assert_array_equal(r["T"], idx.main.T)
        assert r["gfa"] == gfa, rank
        st = r["stats"]
        assert st["mesh_P"] == WORLD and st["levels"] > 1 and st["p2p"] > 0


def seqs_on_mesh(aobjs, cfg):
    """``align_seqs(aobjs, mesh=make_mesh(device="cpu"), **cfg)`` on this
    rank: (node state, text)."""
    from reveal_tpu_torch.parallel.mesh import make_mesh

    G, idx = port_rem.align_seqs(aobjs, mesh=make_mesh(device="cpu"), **cfg)
    return port_rem.node_state(G), idx.main.T


@pytest.mark.parametrize("which", ["synthetic-pair", "three-genomes"])
def test_mesh_align_seqs(world, which):
    from reveal_tpu.align.rem import align_seqs as jax_align_seqs

    if which == "synthetic-pair":
        aobjs, cfg = dryrun.synthetic_pair(WORLD), dict(minlength=8)
    else:
        aobjs, cfg = dryrun.three_genomes(), dict(minlength=15)
    res = world.run(seqs_on_mesh, aobjs, cfg)
    state, T = dryrun._seqs_frontier(aobjs, CPU, **cfg)
    Gh, ih = jax_align_seqs(aobjs, backend="np", **cfg)
    assert _jax_state(Gh) == state
    np.testing.assert_array_equal(ih.main.T, T)
    for rank, (got, got_T) in enumerate(res):
        assert got == state, rank
        np.testing.assert_array_equal(got_T, T)
