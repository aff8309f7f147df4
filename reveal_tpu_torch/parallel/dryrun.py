"""The multi-device dry run.

Port of ``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:37-
217``): every rank of a mesh runs ``dryrun_multichip(mesh)``, which checks
five things and returns one line:

1. the sharded build (``index/suffix.build_esa_sharded``) against the
   single-device build on the mesh's device and the numpy oracle;
2. ``build_esa_distributed`` against the native build (SA, LCP, SAi);
3. the sharded pipeline step (``mesh.build_pipeline_step``): its
   candidate count against the host scans of the segments
   (``index/mums.pairwise_mums``), ``cells`` against the sum of lx * ly;
4. a pairwise mesh ``rem`` (``align_seqs(..., mesh=)``) on a synthetic
   pair of 64 * P bp at ``minlength=8`` against the single-device
   per-level frontier: node state and text;
5. a three-genome mesh ``rem`` (3 x 2 kbp from seed 5, ``minlength=15``)
   against the single-device per-level frontier.

The reference's fixture branch (a pairwise ``rem`` of ``tests/1a.fa`` and
``tests/1b.fa`` read from outside the repository, :167-175) is left out:
those files are not in the repository, so the synthetic pair of step 4,
the reference's own stand-in for them, always runs.

    python -m reveal_tpu_torch.parallel.dryrun [--ranks N] [--device cpu]

runs it in a world of one in this process (N = 1, the default) or in a
local world of N processes (``distributed.World``: gloo on the CPU, one
card a rank under NCCL), and prints every rank's line.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np


def _random(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def synthetic_pair(P: int):
    """The reference's synthetic pair (__graft_entry__.py:177-190): 64 * P
    random bases from seed 1 and a copy with 2 * P substitutions."""
    rng = np.random.default_rng(1)
    base = _random(rng, 64 * P)
    mut = list(base)
    for _ in range(2 * P):
        mut[int(rng.integers(0, len(mut)))] = "ACGT"[int(rng.integers(0, 4))]
    return [("a", base), ("b", "".join(mut))]


def three_genomes():
    """The reference's three genomes (__graft_entry__.py:194-205): 2 kbp
    from seed 5, each copy with 12 substitutions or deletions."""
    rng = np.random.default_rng(5)
    base = _random(rng, 2000)
    aobjs = []
    for s in range(3):
        seq = list(base)
        for _ in range(12):
            i = int(rng.integers(0, len(seq)))
            if rng.random() < 0.5:
                seq[i] = "ACGT"[int(rng.integers(0, 4))]
            else:
                del seq[i]
        aobjs.append(("g%d" % s, "".join(seq)))
    return aobjs


def _seqs_frontier(aobjs, device, **cfg):
    """``align_seqs(aobjs, **cfg)`` with the per-level frontier forced on
    ``device`` (the route a mesh takes, on one device): (node state,
    text)."""
    from ..align import rem
    from ..align.graphops import prune_nodes

    G, t, idx, start, end = rem._seqs_graph(aobjs, "auto", device)
    rem._align_loop_frontier(G, t, idx, rem.PickerConfig(**cfg), device)
    prune_nodes(G, T=idx.main.T)
    G.remove_node(start)
    G.remove_node(end)
    return rem.node_state(G), idx.main.T


def _mesh_rem(aobjs, mesh, what, **cfg):
    """``align_seqs(aobjs, mesh=mesh, **cfg)`` held against the
    single-device per-level frontier: node state and text."""
    from ..align import rem

    want, want_T = _seqs_frontier(aobjs, mesh.device, **cfg)
    G, idx = rem.align_seqs(aobjs, mesh=mesh, **cfg)
    if rem.node_state(G) != want:
        raise AssertionError("%s: the mesh rem's node state differs from "
                             "the single-device frontier's" % what)
    if not np.array_equal(idx.main.T, want_T):
        raise AssertionError("%s: the mesh rem's text differs from the "
                             "single-device frontier's" % what)


def dryrun_multichip(mesh) -> str:
    """The five checks on ``mesh`` (every rank of it calls this with the
    same mesh); raises on a mismatch, else returns the line the
    reference prints."""
    from ..core.textstore import TextStore
    from ..hmm.pairhmm import _pad_with_dummy
    from ..index import suffix
    from ..index.frontier import pack_segments
    from ..index.mums import pairwise_mums
    from .dsa import build_esa_distributed
    from .mesh import build_pipeline_step

    P, dev = mesh.size, mesh.device
    rng = np.random.default_rng(0)
    base = _random(rng, 48 * P)
    mut = list(base)
    for _ in range(P):
        mut[int(rng.integers(0, len(mut)))] = "ACGT"[int(rng.integers(0, 4))]
    ts = TextStore()
    ts.add_sample("a")
    ts.add_sequence(base)
    ts.add_sample("b")
    ts.add_sequence("".join(mut))
    T, _SO, nsep = ts.build()

    # 1-2: the sharded and the distributed builds
    sa_full = suffix.suffix_array_np(T)
    lcp_full = suffix.lcp_from_sa_np(T, sa_full)
    sa_sh, lcp_sh, _sai = suffix.build_esa_sharded(T, mesh)
    sa_1, lcp_1, _sai1 = suffix.build_esa_device(T, dev)
    for got, want, what in ((sa_sh, sa_full, "sharded SA"),
                            (lcp_sh, lcp_full, "sharded LCP"),
                            (sa_1, sa_sh, "single-device SA"),
                            (lcp_1, lcp_sh, "single-device LCP")):
        if not np.array_equal(got, want):
            raise AssertionError("%s mismatch" % what)
    sa_d, lcp_d, sai_d = build_esa_distributed(T, mesh)
    native = suffix.build_esa(T, "native")
    for got, want, what in zip((sa_d, lcp_d, sai_d), native,
                               ("SA", "LCP", "SAi")):
        if not np.array_equal(got, want):
            raise AssertionError("distributed %s mismatch against the "
                                 "native build" % what)

    # 3: the pipeline step on 2 * P pseudo-segments in P groups
    nseg = 2 * P
    segs = []
    for s in range(nseg):
        pos = np.arange(s, len(sa_full), nseg)
        csa = sa_full[pos]
        clcp = np.zeros(len(pos), dtype=np.int64)
        for j in range(1, len(pos)):
            clcp[j] = lcp_full[pos[j - 1] + 1: pos[j] + 1].min()
        segs.append((csa.astype(np.int32), clcp.astype(np.int32)))
    SA, LCP, SEG = pack_segments(segs, n_groups=P)
    want_count = sum(
        len(pairwise_mums(T, csa.astype(np.int64), clcp.astype(np.int64),
                          int(nsep[0]), minl=1))
        for csa, clcp in segs)
    B, L = P, 32  # one pair a rank
    seqs1 = [_random(rng, 24) for _ in range(B)]
    seqs2 = [_random(rng, 28) for _ in range(B)]
    xb = np.stack([_pad_with_dummy(s.encode(), L) for s in seqs1])
    yb = np.stack([_pad_with_dummy(s.encode(), L) for s in seqs2])
    lx = np.array([len(s) for s in seqs1], dtype=np.int32)
    ly = np.array([len(s) for s in seqs2], dtype=np.int32)
    count, _cl, _cp, cells, logprob = build_pipeline_step(
        mesh, nsep0=int(nsep[0]))(T, SA, LCP, SEG, xb, yb, lx, ly)
    if int(count) != want_count:
        raise AssertionError("pipeline step: %d candidates, the host scans "
                             "%d" % (int(count), want_count))
    if int(cells) != int(np.sum(lx.astype(np.int64) * ly)):
        raise AssertionError("pipeline step: cell count")

    # 4-5: the pairwise and the three-genome mesh rem
    _mesh_rem(synthetic_pair(P), mesh, "pairwise mesh rem", minlength=8)
    _mesh_rem(three_genomes(), mesh, "three-genome mesh rem", minlength=15)

    return ("dryrun_multichip ok: ranks=%d mums=%d cells=%d logprob=%.2f "
            "sharded-rem-graph=match(synthetic) multi3-mesh-rem=match"
            % (P, int(count), int(cells), float(logprob)))


def dryrun_on_world(n_devices=None, device="cuda"):
    """``dryrun_multichip(make_mesh(n_devices, device))`` on this rank of
    the running group (None on a rank outside the mesh): the call a
    ``World`` sends its ranks."""
    from .mesh import make_mesh

    mesh = make_mesh(n_devices, device)
    return None if mesh is None else dryrun_multichip(mesh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks of the mesh: 1 runs in this process, more "
                         "start a local world of that many processes")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.ranks == 1:
        lines = [dryrun_on_world(1, args.device)]
    else:
        from .distributed import World

        with tempfile.TemporaryDirectory(prefix="dryrun_") as wd:
            with World(args.ranks, "file://%s/store" % wd,
                       device=args.device) as world:
                lines = world.run(dryrun_on_world, device=args.device)
    for rank, line in enumerate(lines):
        print("rank %d: %s" % (rank, line))


if __name__ == "__main__":
    main()
