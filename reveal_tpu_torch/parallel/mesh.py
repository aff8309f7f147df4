"""The mesh of ranks, and the sharded pipeline step.

Port of ``reveal_tpu/parallel/mesh.py``.  A JAX ``Mesh`` is a 1-D array
of devices that one program spans; here a ``Mesh`` is this process's view
of a process group: the group, the global ranks in it, this rank's place
in it and its device.  ``make_mesh`` makes a world of one (a
``HashStore``, no address) when no group is up, so that the multi-device
routes run in one process as the reference's do on all local devices.

``build_pipeline_step`` is the sharded step of the reference
(mesh.py:34-122): each rank scores the candidate MUMs of its packed
segment group (``index/frontier.pack_segments``; the reveal.c:119-180
conditions, ``index/devfrontier.pair_mask``), the count is all-reduced
and every rank's top-k lengths with their SA positions all-gathered; the
rank's shard of a pair-HMM batch goes through
``hmm/pairhmm_dp.posterior_batch`` (the forward and backward DP kernels
of ``csrc/pairhmm_dp.cu`` on a card), and the cells and log-probability
sums are all-reduced.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
import torch.distributed as dist

from ..core.torchconfig import resolve_device
from .distributed import backend_for, rank_device

# the subgroups make_mesh made, {n: (the world's group, the subgroup of
# its first n ranks)}
_SUBGROUPS = {}


@dataclass
class Mesh:
    """This rank's view of a 1-D mesh: the process group, the global
    ranks of the mesh in mesh order, this rank's index in the mesh and
    its device."""

    group: object
    ranks: List[int]
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)


def _world_of_one(dev):
    dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                            rank=0, world_size=1)
    _SUBGROUPS.clear()


def make_mesh(n_devices=None, device="cuda"):
    """The mesh of the first ``n_devices`` ranks of the process group (all
    of them by default) on ``device``; None on a rank outside it.

    With no group up, a world of one on ``device``'s backend.  A group
    that is up, whoever made it, must have ``device``'s backend, or this
    raises.  Every rank of the group must make the same calls (a subgroup
    is a collective)."""
    dev = resolve_device(device)
    want = backend_for(dev)
    if not dist.is_initialized():
        _world_of_one(dev)
    have = str(dist.get_backend())
    if want not in have:
        raise ValueError("the process group's backend is %s; a %s mesh "
                         "needs %s" % (have, dev.type, want))
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError("a mesh of %d ranks in a world of %d" % (n, world))
    group = dist.group.WORLD
    if n < world:
        held = _SUBGROUPS.get(n)
        if held is None or held[0] is not group:
            held = _SUBGROUPS[n] = (group, dist.new_group(list(range(n))))
        group = held[1]
    me = dist.get_rank()
    if me >= n:
        return None
    return Mesh(group, list(range(n)), me, rank_device(dev))


# --------------------------------------------------------------------------
# the sharded pipeline step
# --------------------------------------------------------------------------

def _all_gather(x, mesh):
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(out, x.contiguous(), group=mesh.group)
    return torch.cat(out)


def _columns4(y):
    """Pad the columns of a pair batch with '~' to a multiple of 4 (the
    DP kernels' row width); the DP reads nothing past a pair's length."""
    pad = -y.shape[1] % 4
    if not pad:
        return y
    return torch.cat([y, y.new_full((y.shape[0], pad), ord("~"))], 1)


def build_pipeline_step(mesh: Mesh, nsep0: int, topk: int = 64):
    """The sharded pipeline step of ``mesh``'s ranks (mesh.py:34-122).

    step(T, SA, LCP, SEG, xb, yb, lx, ly) ->
        (mum_count, cand_lengths, cand_positions, cells, logprob_sum)

    Every rank passes the same global arrays (numpy or CPU tensors) and
    moves only its own shard to its device, as a sharded JAX array holds
    it: T whole (replicated: the maximality reads go by suffix position);
    SA/LCP/SEG (P, Lp) int32 packed segment groups
    (``index/frontier.pack_segments`` with ``n_groups`` = P: whole
    segments a rank, so the adjacent-pair conditions stay on the rank),
    row ``rank``; xb (B, L1p) / yb (B, L2p) uint8 pair batch (dummy at
    column 0, '~' padding) and lx/ly (B,) int32, rows ``rank * B / P`` on.

    The count is the number of valid candidates (every length >= 1).
    ``cand_lengths``/``cand_positions`` (P * topk,) are each rank's topk
    longest candidate lengths, the lower slot first among equal lengths
    as ``jax.lax.top_k`` takes them (a stable descending sort), with the
    SA positions of their slots, in rank order.  ``cells`` is
    sum(lx * ly) as an int64 (JAX sums it in float32, exact below 2^24);
    ``logprob_sum`` the float32 sum of the pairs' total log-probabilities,
    summed a rank and then across ranks (JAX's psum adds in another order:
    the two agree within float32 rounding).  All five come back on every
    rank, on its device."""
    from ..hmm.pairhmm_dp import posterior_batch
    from ..index.devfrontier import pair_mask

    P, me, dev = mesh.size, mesh.rank, mesh.device

    def on_dev(x, rows=None):
        x = torch.as_tensor(x)
        return (x if rows is None else x[rows]).contiguous().to(dev)

    def step(T, SA, LCP, SEG, xb, yb, lx, ly):
        if len(SA) != P:
            raise ValueError("%d segment groups for a mesh of %d"
                             % (len(SA), P))
        B = len(lx)
        if B % P:
            raise ValueError("a batch of %d pairs over %d ranks" % (B, P))
        b = B // P
        rows = slice(me * b, (me + 1) * b)
        Td = on_dev(T)
        sa, lcp, seg = (on_dev(x, me) for x in (SA, LCP, SEG))
        if topk > sa.shape[0]:
            raise ValueError("topk %d over a group of %d slots"
                             % (topk, sa.shape[0]))
        # --- candidate MUM scoring on this rank's segment group ---------
        valid, _a, _b = pair_mask(Td, sa, lcp, int(nsep0), 1, seg)
        lengths = torch.where(valid, lcp, torch.zeros_like(lcp))
        count = valid.sum(dtype=torch.int64).reshape(1)
        dist.all_reduce(count, group=mesh.group)
        top = torch.sort(lengths, descending=True, stable=True).indices[:topk]
        cand = _all_gather(torch.stack([lengths[top], sa[top]]), mesh)
        cand = cand.reshape(P, 2, topk)
        # --- pair-HMM on this rank's shard of the batch -----------------
        x, y = on_dev(xb, rows), _columns4(on_dev(yb, rows))
        lxs, lys = on_dev(lx, rows), on_dev(ly, rows)
        _, tots = posterior_batch(x, y, lxs, lys)
        cells = (lxs.to(torch.int64) * lys.to(torch.int64)).sum().reshape(1)
        logprob = tots.sum().reshape(1)
        dist.all_reduce(cells, group=mesh.group)
        dist.all_reduce(logprob, group=mesh.group)
        return (count[0], cand[:, 0].reshape(-1), cand[:, 1].reshape(-1),
                cells[0], logprob[0])

    return step


def run_pipeline_step(T, SA, LCP, SEG, xb, yb, lx, ly, nsep0: int,
                      topk: int = 64, n_devices=None, device="cuda"):
    """One step of ``build_pipeline_step`` over ``make_mesh(n_devices,
    device)`` of the running group, its results as Python numbers and
    CPU tensors (None on a rank outside the mesh): the call a ``World``
    sends its ranks."""
    mesh = make_mesh(n_devices, device)
    if mesh is None:
        return None
    out = build_pipeline_step(mesh, nsep0, topk)(T, SA, LCP, SEG, xb, yb,
                                                  lx, ly)
    count, cl, cp, cells, logprob = out
    return int(count), cl.cpu(), cp.cpu(), int(cells), float(logprob)
