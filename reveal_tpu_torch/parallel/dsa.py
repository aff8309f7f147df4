"""Distributed suffix-array construction over a process group.

Port of ``reveal_tpu/parallel/dsa.py``: prefix doubling where every
array a rank touches is O(n/P), written with explicit collectives.  The
JAX module is one ``shard_map`` program over a mesh; here every rank of a
``Mesh`` (``parallel/mesh.py``) runs ``dsa_shard`` on its own shard of
the text.  ``ppermute`` becomes paired ``batch_isend_irecv`` (a rank that
only sends or only receives posts only that; a rank past the end of a
shift receives nothing and reads zeros, as in JAX), ``all_gather`` and
``psum`` become their ``torch.distributed`` calls.

Per doubling round (prefix length 2^lev):

1. rank2 halo shift      rank2[i] = rank[i + 2^lev]: one or two whole-
                         shard moves from the ranks ahead and a local
                         concat; past the end zeros, the pad byte 0 that
                         sorts below every real byte.
2. distributed sort      a comparator network over shard-sized blocks:
                         a local stable sort, then per network layer one
                         exchange of all the arrays stacked in one tensor
                         with the partner and a merge-split (bitonic
                         layers for a power-of-two P, odd-even
                         transposition otherwise).
3. dense re-rank         neighbour-equality flags with a one-element halo,
                         a local cumsum, shard offsets from one all_gather
                         of the shard totals.
4. scatter back          a second network sort keyed on the suffix index
                         puts the ranks back in text order.

SA is the last round's sorted indices; SAi comes from one more
index-keyed sort.  LCP descends the kept rank levels as the single-device
build does (``index/suffix._lcp_descent``), each level's reads
rank_k[a], rank_k[b] answered by ``dist_gather2``, a sort-based gather of
3 * sh-wide blocks; the $/N cap takes a reverse min-scan with one
all_gather for the cross-shard carry and one index-keyed sort.
``lcp_ckpt_stride = s`` keeps every s-th level only and regenerates the
others on the descent (O(n/P * (log n / s + s)) per rank).

Port choices (the output is the same arrays): every rank knows its own
index, so a network layer is a Python branch on the rank's partner where
JAX selects with ``where`` over every rank, and an idle rank posts
nothing.  ``after`` (an ``optimization_barrier`` that orders XLA's
collectives) is dropped: eager torch posts collectives in program order,
and every rank makes the same calls in the same order; the arrays of one
exchange are stacked in one tensor of one dtype, as in JAX.  The rounds
stop at the first round that tells every real suffix apart (every rank
reads the same all-gathered totals, so all stop together) where JAX runs
all ``nlev - 1``: the pad suffixes read zeros for ever, so they stay one
class, and the real suffixes are all apart when the classes number n + 1
(n when n = npad).  At a later level no pair of real suffixes agrees, so
the descent advances none, and the sort keeps their order, so the
stripped arrays are equal; the checkpoint levels are those of the rounds
run.  Two-key sorts sort one packed int64 key
(``k1 << 32 | k2 + 2^31``) stably for int32 keys, or two stable sorts for
int64 ones: the order of ``jnp.lexsort``.

Replaces: divsufsort (reveal/divsufsort/divsufsort.c:332) at multi-device
scale; the reference has no distributed analog.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.encoding import N_BYTE, SENTINEL

# the last build's counters on this rank: n, npad, P, sh, nlev, rounds
# (doubling rounds run), int64, stride; the collectives it posted: p2p
# (exchanges in which it sent or received), sends, recvs, all_gathers
# (the last gather of the shards included), widest (most slots of one
# array in one exchange); rounds_seconds, lcp_seconds,
# copy_seconds (a synchronised clock)
LAST_STATS = {}


def _partners(P: int, phase: int):
    """Partner table for odd-even transposition phase; self at borders."""
    out = list(range(P))
    for a in range(phase % 2, P - 1, 2):
        out[a], out[a + 1] = a + 1, a
    return out


def _network_layers(P: int):
    """Comparator layers of the block-sort network as
    ``(partner[P], keep_low[P])`` tuples (partner == self means idle).

    Power-of-two P: the bitonic network, log2(P)(log2(P)+1)/2 layers —
    the schedule that scales to pod meshes (36 layers at P=256 vs 256
    odd-even phases).  Other P: odd-even transposition, P layers.
    Either network sorts all 0-1 inputs, so replacing every
    compare-exchange with a merge-split of two sorted shard blocks
    sorts the blocked array (Knuth TAOCP 5.3.4 ex. 38); a descending
    comparator is simply a merge-split that keeps the high half on the
    lower-indexed side.
    """
    layers = []
    if P > 1 and (P & (P - 1)) == 0:
        k = 2
        while k <= P:
            j = k >> 1
            while j >= 1:
                part = list(range(P))
                keep_low = [True] * P
                for i in range(P):
                    p = i ^ j
                    if p > i:
                        asc = (i & k) == 0
                        part[i], part[p] = p, i
                        keep_low[i] = asc
                        keep_low[p] = not asc
                layers.append((part, keep_low))
                j >>= 1
            k <<= 1
    else:
        for phase in range(P):
            part = _partners(P, phase)
            keep_low = [i <= part[i] for i in range(P)]
            layers.append((part, keep_low))
    return layers


def _sort_order(keys):
    """Stable lexicographic order of equal-length integer keys (the first
    the major), as ``jnp.lexsort(reversed(keys))`` gives it."""
    if len(keys) == 1:
        return torch.sort(keys[0], stable=True).indices
    k1, k2 = keys
    if k1.dtype == torch.int32:
        packed = (k1.to(torch.int64) << 32) + (k2.to(torch.int64) + 2**31)
        return torch.sort(packed, stable=True).indices
    order = torch.sort(k2, stable=True).indices
    return order[torch.sort(k1[order], stable=True).indices]


class CollectiveKit:
    """``collective_kit`` (dsa.py:142-334) over ``mesh`` with shard width
    ``sh`` and index dtype ``idt``: the halo moves, the comparator-network
    sort and the sort-based gather, with this rank's counts of what it
    posted."""

    def __init__(self, mesh, sh: int, idt=torch.int32):
        self.mesh, self.sh, self.idt = mesh, sh, idt
        self.P, self.me = mesh.size, mesh.rank
        self.npad_c = sh * self.P
        self.layers = _network_layers(self.P)
        self.stats = dict(p2p=0, sends=0, recvs=0, all_gathers=0,
                          widest=0)

    def ppermute(self, x, perm):
        """``jax.lax.ppermute``: ``x`` goes from src to dst for each (src,
        dst) of ``perm``; a rank that is no dst gets zeros."""
        me, ranks = self.me, self.mesh.ranks
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        out = torch.zeros_like(x)
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[dst[0]],
                                  self.mesh.group))
        if src:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src[0]],
                                  self.mesh.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            st = self.stats
            st["p2p"] += 1
            st["sends"] += len(dst)
            st["recvs"] += len(src)
            st["widest"] = max(st["widest"], x.shape[0])
        return out

    def all_gather(self, x):
        """(P, *x.shape): every rank's ``x`` in rank order."""
        out = [torch.empty_like(x) for _ in range(self.P)]
        dist.all_gather(out, x.contiguous(), group=self.mesh.group)
        self.stats["all_gathers"] += 1
        return torch.stack(out)

    def from_ahead(self, x, q):
        """Local block of the shard q places ahead (zero-fill past end)."""
        if q == 0:
            return x
        if q >= self.P:
            return torch.zeros_like(x)
        return self.ppermute(x, [(j, j - q) for j in range(q, self.P)])

    def shift_left(self, x, s):
        """Global left shift by s: out[i] = global_x[i + s], 0 past end."""
        q, o = divmod(s, self.sh)
        a = self.from_ahead(x, q)
        if o == 0:
            return a
        b = self.from_ahead(x, q + 1)
        return torch.cat([a[o:], b[:o]])

    @staticmethod
    def local_sort(arrs, nkeys):
        order = _sort_order(arrs[:nkeys])
        return tuple(torch.index_select(a, 0, order) for a in arrs)

    def make_net_sort(self, width):
        """Global sort of width-``width`` shard-blocked arrays by the
        first nkeys (lexicographic); the remaining arrays are carried
        values.  One merge-split exchange per layer of the comparator
        network, every array of it stacked in one tensor."""

        def net_sort(arrs, nkeys):
            if any(a.shape != (width,) for a in arrs):
                raise ValueError("net_sort of width %d got %s"
                                 % (width, [tuple(a.shape) for a in arrs]))
            arrs = self.local_sort(arrs, nkeys)
            me = self.me
            for part, keep_low in self.layers:
                p = part[me]
                if p == me:
                    continue
                recv = self.ppermute(torch.stack(arrs, 1),
                                     [(j, part[j]) for j in range(self.P)
                                      if part[j] != j])
                # the lower-indexed block first on both sides: both
                # partners sort the same sequence, so the stable sort's
                # ties fall alike and every element is kept exactly once
                lo, hi = (arrs, recv.unbind(1)) if me < p else (
                    recv.unbind(1), arrs)
                merged = self.local_sort(
                    [torch.cat([a, b]) for a, b in zip(lo, hi)], nkeys)
                arrs = tuple(m[:width] if keep_low[me] else m[width:]
                             for m in merged)
            return arrs

        return net_sort

    def prev_halo(self, x):
        """Last element of the previous shard (zero-fill on shard 0)."""
        return self.ppermute(x[-1:], [(j, j + 1) for j in range(self.P - 1)])

    def next_halo(self, x):
        """First element of the next shard (zero-fill on shard P-1)."""
        return self.ppermute(x[:1], [(j, j - 1) for j in range(1, self.P)])

    def dist_gather2(self, val, qa, qb, iar_g):
        """(val_global[qa[j]], val_global[qb[j]]) in one sort pass
        (dsa.py:251-316): the sh value entries (key = position, payload =
        value) and 2 * sh query entries (key = q, payload = query id)
        network-sort together by (key, tag), so that each query's nearest
        preceding value entry is its answer; values are carried forward
        (a local max-scan and one all_gather for the cross-shard carry),
        then a network sort keyed on each answer's destination slot puts
        the a-answers in the first block of every shard and the b-answers
        in the second."""
        sh, idt, npad_c = self.sh, self.idt, self.npad_c
        net3 = self.make_net_sort(3 * sh)
        key = torch.cat([iar_g, qa, qb])
        tag = torch.cat([torch.zeros(sh, dtype=idt, device=val.device),
                         torch.ones(2 * sh, dtype=idt, device=val.device)])
        pay = torch.cat([val, iar_g, iar_g + npad_c])
        k_s, t_s, p_s = net3((key, tag, pay), 2)
        isval = t_s == 0
        pos = torch.arange(3 * sh, device=val.device)
        lastidx = torch.cummax(torch.where(isval, pos, -1), 0).values
        li = lastidx[-1:]
        shard_last = p_s[li.clamp(min=0)]
        has = (li >= 0).to(idt)
        gathered = self.all_gather(torch.cat([shard_last, has]))  # (P, 2)
        pidx = torch.arange(self.P, device=val.device)
        score = torch.where((gathered[:, 1] > 0) & (pidx < self.me), pidx, -1)
        j = torch.argmax(score)
        carry = torch.where(score[j] >= 0, gathered[j, 0],
                            torch.zeros((), dtype=idt, device=val.device))
        localval = torch.where(lastidx >= 0, p_s[lastidx.clamp(min=0)], carry)
        big = p_s >= npad_c
        g = torch.where(isval, k_s, torch.where(big, p_s - npad_c, p_s))
        block = torch.div(g, sh, rounding_mode="floor")
        offs = torch.where(isval, 2 * sh, torch.where(big, sh, 0)).to(idt)
        backkey = g + 2 * block * sh + offs
        _, ansq = net3((backkey, localval), 1)
        return ansq[:sh], ansq[sh:2 * sh]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dsa_shard(T_local, mesh, sh: int, nlev: int, use64: bool,
              ckpt_stride=None, kit=None, n=None):
    """This rank's (SA, SAi, LCP) shards of the text whose shard is
    ``T_local`` (uint8, sh slots, on the rank's device): the shard body
    of ``_get_dsa_fn`` (dsa.py:373-509).  ``nlev`` = ceil(log2(sh * P))
    + 1; ``ckpt_stride`` None keeps every rank level for the descent, an
    int s every s-th.  ``n``: the real text's length (the rest is pad
    byte 0), which lets the rounds stop once the real suffixes are all
    apart; None stops only when every slot is.  ``kit`` (a
    ``CollectiveKit``) keeps the counts; the rounds run and the stage
    seconds go into ``LAST_STATS``."""
    idt = torch.int64 if use64 else torch.int32
    kit = kit or CollectiveKit(mesh, sh, idt)
    me, P, dev = mesh.rank, mesh.size, T_local.device
    npad_c = kit.npad_c
    # the last dense rank once the real suffixes are all apart
    last = npad_c - 1 if n is None or n >= npad_c else n
    net = kit.make_net_sort(sh)
    iar_l = torch.arange(sh, dtype=idt, device=dev)
    iar_g = iar_l + me * sh
    rank = T_local.to(idt)
    # ranks are < npad: below 2^31 the kept levels narrow to int32
    store_dt = torch.int32 if npad_c < 2**31 else idt
    t0 = time.perf_counter()

    def doubling_round(rank, lev):
        """One prefix-doubling round: (new text-order rank, the round's
        SA-order suffix indices, the all-gathered shard totals)."""
        key2 = kit.shift_left(rank, 1 << lev)
        k1, k2, sa = net((rank, key2, iar_g), 2)
        halos = kit.prev_halo(torch.stack([k1, k2], 1))
        p1 = torch.cat([halos[:, 0], k1[:-1]])
        p2 = torch.cat([halos[:, 1], k2[:-1]])
        neq = ((k1 != p1) | (k2 != p2)).to(idt)
        if me == 0:
            neq[:1].fill_(0)
        loc = torch.cumsum(neq, 0, dtype=idt)
        tots = kit.all_gather(loc[-1:])[:, 0]
        rankval = loc + tots[:me].sum(dtype=idt)
        _, rank = net((sa, rankval), 1)
        return rank, sa, tots

    ranks_hist = [rank] if ckpt_stride is None else None
    ckpts = None if ckpt_stride is None else {0: rank.to(store_dt)}
    rounds = 0
    for lev in range(nlev - 1):
        rank, sa, tots = doubling_round(rank, lev)
        rounds += 1
        if ckpt_stride is None:
            ranks_hist.append(rank.to(store_dt))
        elif (lev + 1) % ckpt_stride == 0:
            ckpts[lev + 1] = rank.to(store_dt)
        # every rank reads the same totals
        if int(tots.sum()) == last:
            break
    _, sai = net((sa, iar_g), 1)
    _sync(dev)
    t1 = time.perf_counter()

    # ---- LCP: rank descent over the kept levels -----------------------
    top = rounds
    a = torch.cat([kit.prev_halo(sa), sa[:-1]])
    b = sa
    h = torch.zeros_like(sa)

    def descend_level(a, b, h, k, rk):
        ok = (a + k <= npad_c) & (b + k <= npad_c)
        qa, qb = kit.dist_gather2(rk, a.clamp(max=npad_c - 1),
                                  b.clamp(max=npad_c - 1), iar_g)
        step = (ok & (qa == qb)).to(idt) * k
        return a + step, b + step, h + step

    seg = {}
    for lev in range(top, -1, -1):
        if ckpt_stride is None:
            rk = ranks_hist[lev]
        elif lev % ckpt_stride == 0:
            rk = ckpts[lev]
        else:
            # regenerate the levels of this checkpoint segment once, on
            # first (highest) use, then walk down them
            base = lev - lev % ckpt_stride
            if lev not in seg:
                seg = {}
                r = ckpts[base].to(idt)
                for j in range(base, lev):
                    r, _, _ = doubling_round(r, j)
                    seg[j + 1] = r
            rk = seg[lev]
        a, b, h = descend_level(a, b, h, 1 << lev, rk.to(idt))
    del ranks_hist, ckpts, seg
    # $/N cap: stop distances by a reverse min-scan, in SA order by one
    # index-keyed sort
    stop = torch.where((T_local == SENTINEL) | (T_local == N_BYTE), iar_g,
                       torch.full_like(iar_g, npad_c))
    sufmin = torch.cummin(stop.flip(0), 0).values.flip(0)
    mins = kit.all_gather(sufmin[:1])[:, 0]
    carry_in = mins[me + 1:].min() if me + 1 < P else npad_c
    d_loc = torch.clamp(sufmin, max=carry_in) - iar_g
    _, d_sa = net((sai, d_loc), 1)
    d_prev = torch.cat([kit.prev_halo(d_sa), d_sa[:-1]])
    lcp = torch.minimum(h, torch.minimum(d_prev, d_sa))
    if me == 0:
        lcp[:1].fill_(0)
    _sync(dev)
    LAST_STATS.update(rounds=rounds, rounds_seconds=t1 - t0,
                      lcp_seconds=time.perf_counter() - t1)
    return sa, sai, lcp


def build_esa_distributed(T_np: np.ndarray, mesh, force64: bool = False,
                          host_lcp: bool = False, lcp_ckpt_stride=None):
    """(SA, LCP, SAi) as numpy int64 with the suffix sort and the LCP
    descent distributed over ``mesh``'s ranks (dsa.py:522-601).

    Every rank of the mesh calls it with the same text and moves only its
    own shard to its device; every rank gets the whole arrays back from
    one all_gather of the shards.  Real text bytes must be nonzero (byte 0
    is the pad).  ``host_lcp=True`` recomputes the LCP on the host
    (``suffix.lcp_from_sa_np``).  ``lcp_ckpt_stride``: None keeps every
    doubling level for the LCP descent; an int s >= 1 keeps every s-th
    and regenerates in between; ``"sqrt"`` takes s = round(sqrt(#levels)).
    """
    from ..index.suffix import lcp_from_sa_np

    n = int(len(T_np))
    if n == 0:
        z = np.empty(0, np.int64)
        return z, z, z
    if T_np.min() == 0:
        raise ValueError("text contains byte 0 (reserved pad sentinel)")
    P = mesh.size
    npad = 1 << max(1, int(math.ceil(math.log2(max(n, P)))))
    npad = ((npad + P - 1) // P) * P  # meshes of any size
    sh = npad // P
    nlev = int(math.ceil(math.log2(npad))) + 1
    if lcp_ckpt_stride == "sqrt":
        lcp_ckpt_stride = max(1, round(math.sqrt(nlev)))
    if lcp_ckpt_stride is not None:
        lcp_ckpt_stride = int(lcp_ckpt_stride)
        if lcp_ckpt_stride < 1:
            raise ValueError("lcp_ckpt_stride must be >= 1")
    # the gather's sort-back key reaches 3 * npad: int32 needs 3 npad < 2^31
    use64 = force64 or npad >= 2**29
    T_padded = np.zeros(npad, dtype=np.uint8)
    T_padded[:n] = T_np
    dev = mesh.device
    LAST_STATS.clear()
    LAST_STATS.update(n=n, npad=npad, P=P, sh=sh, nlev=nlev, int64=use64,
                      stride=lcp_ckpt_stride)
    T_local = torch.from_numpy(T_padded[mesh.rank * sh:
                                        (mesh.rank + 1) * sh]).to(dev)
    kit = CollectiveKit(mesh, sh, torch.int64 if use64 else torch.int32)
    sa, sai, lcp = dsa_shard(T_local, mesh, sh, nlev, use64,
                             lcp_ckpt_stride, kit, n)
    t0 = time.perf_counter()
    full = kit.all_gather(torch.stack([sa, sai, lcp]))  # (P, 3, sh)
    sa, sai, lcp = (full[:, i].reshape(-1).to(torch.int64).cpu().numpy()
                    for i in range(3))
    LAST_STATS.update(kit.stats, copy_seconds=time.perf_counter() - t0)
    off = npad - n
    if off:
        sa = sa[off:]
        sai = sai[:n] - off
        lcp = lcp[off:].copy()
        lcp[0] = 0  # pad-vs-real boundary pair
    if host_lcp:
        lcp = lcp_from_sa_np(np.asarray(T_np, dtype=np.uint8),
                             sa).astype(np.int64)
    return sa, lcp, sai


def build_on_world(T_np, n_devices=None, device="cuda", **kw):
    """``build_esa_distributed`` over ``make_mesh(n_devices, device)`` of
    the running group: ((SA, LCP, SAi), LAST_STATS), or None on a rank
    outside the mesh.  The call a ``World`` sends its ranks."""
    from .mesh import make_mesh

    mesh = make_mesh(n_devices, device)
    if mesh is None:
        return None
    out = build_esa_distributed(T_np, mesh, **kw)
    return out, dict(LAST_STATS)
