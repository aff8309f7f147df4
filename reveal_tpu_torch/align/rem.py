"""``rem`` on a torch device, with the host engine beside it.

Counterpart of ``reveal_tpu/align/rem.py``.  The host half is this
package's own copy of the reference's host code: fasta reading
(``read_fasta_into``), the native whole-recursion engine
(``_rem2_native_loop``), the anchor replays (``_rem2_replay``,
``_rem2_replay_native``, ``_rem_multi_replay``), the multi loop's
eligibility (``_multi_fast_eligible``) and the serial host engine
(``_align_loop`` with ``graphalign`` and ``_enum_pick``).
``align_genomes`` and ``align_seqs`` route ``rem --frontier``
(``_align_frontier``, the routes of the reference's
``_align_loop_frontier`` on one device): three or more samples (up to 8
contig paths) take the multi-genome loop on the device given
(``index/devloop_multi.rem_device_multi`` through
``_rem_device_multi_loop``); a pairwise fasta input of one sequence a
sample, trimmed, at an integral ``--wpen`` and ``minlength >= 1`` takes
``_rem_device_loop``: the native host prefix ``rem2_defer_native`` for
the big segments and the deferred forest on the device
(``index/devloop.rem_device_forest``), and for an input they decline (a
host prefix that cannot defer; a kernel abort code such as
``ABORT_DUP_REF``, which needs the host's dict-aliasing) the single-root
loop, the whole recursion on the device (``index/devloop.rem_device_loop``;
``REVEAL_TPU_DEVLOOP_MODE=full`` runs it alone).  Every other input
(graph inputs, multi-contig pairs, ``--notrim``, seeding, size gates,
non-default picking) and every input the loops decline (a kernel abort
code such as ``ABORT_MAXMUMS`` or ``ABORT_CHAIN_ROUNDS``; more than 8
paths; capacity retries that run out; a text of 2^30 bytes or more) runs
the per-level frontier on the same device (``_align_loop_frontier`` over
``index/devfrontier.DeviceFrontier``), as the reference routes it; a
decline is logged and recorded in ``LAST_STATS["fallback"]`` of
``devloop``, ``devloop_multi`` and ``devfrontier``.  No route falls back
to the serial host engine or to the CPU.  ``align_genomes_host`` and
``align_seqs_host`` run the serial host engine alone: the reference the
device paths are held to, and ``refine --method reveal_rem``'s aligner.
``align_genomes(..., frontier=False)`` runs the reference's host drivers
when asked for: the serial LIFO loop, the level-synchronous
``_align_loop_levels`` (``threads > 0``) and, with ``checkpoint``, the
LIFO loop logging its picks to an ``align/anchorlog.AnchorLog``.
``backend="jax"`` builds the root's suffix array on the route's own
device (``index/suffix.build_esa_device``), ``"jax-dist"`` over the ranks
of a mesh on it (``parallel/dsa.build_esa_distributed``; a world of one
unless the caller set up a process group).
"""

from __future__ import annotations

import logging
import os
import time
import uuid
from typing import List, Optional, Tuple

import numpy as np

from ..core import trace
from ..core.io_fasta import fasta_reader
from ..core.io_gfa import read_gfa_into
from ..core.textstore import TextStore
from ..core.torchconfig import resolve_device
from ..graph.pangraph import MultiPanGraph, PanGraph
from ..index import devfrontier, devloop, devloop_multi
from ..index.esa_index import ESAIndex
from .graphops import (
    IntervalIndex,
    breaknode,
    mergenodes,
    prune_nodes,
    segmentgraph,
)
from .picker import MumPicker, PickerConfig

log = logging.getLogger(__name__)

# segments with at most this many enumerated candidates are deferred to
# the device forest (the reference's measured default)
DEFER_MAX = 16


def graphalign(G: PanGraph, t: IntervalIndex, idx: ESAIndex, mum):
    """Port of rem.graphalign (rem.py:318-377)."""
    l, n, spd = mum
    nodes = idx.nodes
    mns = []
    sp = [p for gid, p in spd]
    matching = set()
    for pos in sp:
        matching.add((pos, pos + l))
        old = t.lookup(pos)
        assert old[1] - old[0] >= l
        mn, other = breaknode(G, t, old, pos, l)
        mns.append(mn)
        nodes.discard(old)
        for node in other:
            nodes.add(node)

    mn = mergenodes(G, mns)
    msamples = set(G.nodes[mn]["offsets"].keys())

    leading, trailing, rest = segmentgraph(G, mn, nodes)

    newleftnode = mn
    newrightnode = mn
    for intv in leading:
        if not set(G.nodes[intv]["offsets"].keys()) <= msamples:
            newrightnode = idx.right_node
            break
    for intv in trailing:
        if not set(G.nodes[intv]["offsets"].keys()) <= msamples:
            newleftnode = idx.left_node
            break

    return leading, trailing, matching, rest, mn, newleftnode, newrightnode


def _enum_pick(picker: MumPicker, idx: ESAIndex, cfg: PickerConfig):
    """Enumerate + pick for one segment: the read-only half of the LIFO
    body (reveal.c:809-837 enumeration + the mumpicker callback).  Safe
    to run concurrently for disjoint segments: only reads the shared
    T/SA/LCP/SO arrays and stable graph boundary nodes."""
    mums = None
    pick = None
    if len(idx.skipmums) == 0:
        precomputed = False
        if idx.main.nsamples > 2:
            if picker.fastmap is not None:
                arrs = idx.getmultimums_arrays(
                    minlength=cfg.minlength, minn=cfg.minn
                )
                if arrs is not None:
                    pick = picker.pick_multi(
                        *arrs, idx, minlength=cfg.minlength
                    )
                    if pick is None:  # defer to the generic path
                        from ..index.mums import tuples_from_arrays

                        mums = tuples_from_arrays(*arrs, idx.main.SO)
            if pick is None and mums is None:
                mums = idx.getmultimums(
                    minlength=cfg.minlength, minn=cfg.minn
                )
        else:
            if picker.fastmap is not None:
                arrs = getattr(idx, "_premums", None)
                if arrs is None:
                    arrs = idx.getmums_rem_arrays(cfg.minlength)
                if arrs is not None:
                    pick = picker.pick_pairwise(
                        *arrs, idx, minlength=cfg.minlength
                    )
                    if pick is None:  # defer to the generic path
                        ls, aas, bbs = arrs
                        mums = [
                            (li, 2, ((0, ai), (1, bi)))
                            for li, ai, bi in zip(
                                ls.tolist(), aas.tolist(), bbs.tolist()
                            )
                        ]
            if pick is None and mums is None:
                mums = idx.getmums_rem(cfg.minlength)
    else:
        precomputed = True
        mums = idx.skipmums

    if pick is None:
        pick = picker(
            mums, idx, precomputed=precomputed, minlength=cfg.minlength
        )
    return pick


def _pairwise_fast_eligible(
    G: PanGraph, root: ESAIndex, cfg: PickerConfig
) -> bool:
    """Shared eligibility for the whole-recursion fast paths (native
    rem2 loop and the device loop): pairwise fasta roots, default
    largest/sumofpairs picking, no seeding/size gates."""
    main = root.main
    if (
        getattr(G, "multi", False)
        or main.nsamples != 2
        or os.environ.get("REVEAL_TPU_DISABLE_FASTPICK")
        or cfg.splitchain != "largest"
        or cfg.gcmodel != "sumofpairs"
        or not float(cfg.wscore).is_integer()
        or cfg.seedsize
        or cfg.maxdepth is not None
        or cfg.maxsize is not None
    ):
        return False
    nsep0 = int(main.nsep[0])
    n = int(root.n)
    # fasta pairwise roots only: one whole sequence per sample
    if root.nodes != {(0, nsep0), (nsep0 + 1, n - 1)}:
        return False
    pid = G.graph.get("path2id")
    if pid is None or sorted(pid.values()) != [0, 1]:
        return False
    return True


def _rem2_native_loop(
    G: PanGraph, t: IntervalIndex, root: ESAIndex, cfg: PickerConfig
):
    """Whole-recursion native fast path for the pairwise fasta case.

    The complete LIFO recursion (enumerate/pick/split) runs in ONE
    native call (rem2_loop, native/esa.cpp) — the picker's boundary
    offsets are pure anchor arithmetic in this case, so no graph state
    is needed mid-recursion.  The returned anchor records are then
    replayed through breaknode/mergenodes in pop order, reproducing the
    per-step engine's graph mutation sequence byte-for-byte while
    skipping its segmentgraph/BFS bookkeeping entirely (the recursion
    already happened).  Returns the step count, or None when the case
    is not eligible / the native pick deferred (caller runs the
    per-step loop; T/SAi are restored from snapshots first).
    """
    main = root.main
    if not _pairwise_fast_eligible(G, root, cfg):
        return None
    nsep0 = int(main.nsep[0])
    try:
        from ..native import rem2_loop_native
    except Exception:
        return None
    T = main.T
    SAi = main.SAi
    t_snap = T.copy()
    sai_snap = SAi.copy()
    anchors = rem2_loop_native(
        T,
        root.SA,
        root.LCP,
        SAi,
        nsep0,
        cfg.minlength,
        cfg.trim,
        cfg.maxmums,
        int(cfg.wscore),
        float(cfg.wpen),
        cfg.pcutoff,
    )
    if anchors is None:
        T[:] = t_snap
        SAi[:] = sai_snap
        return None
    _rem2_replay(G, anchors)
    log.debug(
        "rem2 native loop: %d anchors, graph replayed", len(anchors)
    )
    return len(anchors)


def _rem2_replay_native(G: PanGraph, anchors):
    """C-simulated graph replay (native.replay_pairwise_native): the
    exact brk/brk/merge operation sequence of _rem2_replay runs in C
    over interval nodes with order-preserving adjacency, and the
    PanGraph dicts are bulk-rebuilt from the returned flat arrays —
    node/edge dict insertion order is operation-for-operation
    identical, so the GFA stays byte-identical (~5 ms vs ~230 ms of
    Python dict micro-ops on 2a2b).  Returns False when ineligible
    (caller runs the Python replay)."""
    try:
        from ..native import replay_pairwise_native
    except Exception:
        return False

    # serialize the initial graph: markers (string nodes) get unique
    # negative sentinels; interval nodes must be the plain pairwise
    # shape ({0: off} / {1: off} offsets, '+'/'+' edges, paths <= {0,1})
    keys = list(G.nodes)
    kidx = {k: i for i, k in enumerate(keys)}
    N = len(keys)
    import numpy as _np

    ns0 = _np.empty(N, _np.int64)
    ne0 = _np.empty(N, _np.int64)
    o0 = _np.zeros(N, _np.int64)
    o1 = _np.zeros(N, _np.int64)
    nf = _np.zeros(N, _np.uint8)
    nmark = 0
    for i, k in enumerate(keys):
        if isinstance(k, tuple):
            att = G.nodes[k]
            offs = att.get("offsets")
            if offs is None or not set(offs) <= {0, 1}:
                return False
            ns0[i], ne0[i] = k
            f = 0
            if 0 in offs:
                f |= 1
                o0[i] = offs[0]
            if 1 in offs:
                f |= 2
                o1[i] = offs[1]
            if att.get("aligned", 0):
                f |= 4
            nf[i] = f
        elif isinstance(k, str):
            nmark += 1
            ns0[i] = ne0[i] = -nmark
        else:
            return False

    sc = _np.empty(N, _np.int64)
    pc = _np.empty(N, _np.int64)
    sn_, sm, pn_ = [], [], []
    for i, k in enumerate(keys):
        su = G.succ[k]
        sc[i] = len(su)
        for v, d in su.items():
            if d.get("ofrom") != "+" or d.get("oto") != "+":
                return False
            pth = d["paths"]
            if not pth <= {0, 1}:
                return False
            sn_.append(kidx[v])
            sm.append((1 if 0 in pth else 0) | (2 if 1 in pth else 0))
        pr = G.pred[k]
        pc[i] = len(pr)
        for u in pr:
            pn_.append(kidx[u])

    out = replay_pairwise_native(
        anchors,
        (ns0, ne0, o0, o1, nf),
        (sc, _np.asarray(sn_, _np.int64), _np.asarray(sm, _np.uint8)),
        (pc, _np.asarray(pn_, _np.int64)),
    )
    if out is None:
        return False
    (rns, rne, roff0, roff1, rflags, rsc, rpc,
     rsn, rse, rpn, rpe, emask) = out

    sentinel2key = {}
    j = 0
    for k in keys:
        if isinstance(k, str):
            j += 1
            sentinel2key[-j] = k

    rns_l = rns.tolist()
    rne_l = rne.tolist()
    ro0_l = roff0.tolist()
    ro1_l = roff1.tolist()
    rf_l = rflags.tolist()
    names = []
    nodes = {}
    for i, s in enumerate(rns_l):
        if s < 0:
            k = sentinel2key[s]
            att = G.nodes[k]
        else:
            k = (s, rne_l[i])
            f = rf_l[i]
            if f & 3 == 3:
                offs = {0: ro0_l[i], 1: ro1_l[i]}
            elif f & 1:
                offs = {0: ro0_l[i]}
            elif f & 2:
                offs = {1: ro1_l[i]}
            else:
                offs = {}
            att = {"offsets": offs, "aligned": (f >> 2) & 1}
        names.append(k)
        nodes[k] = att

    # shared edge-attribute dicts keyed by edge id (succ and pred views
    # of one edge share the same dict, as in the incremental surgery)
    edges = [None] * len(emask)
    em_l = emask.tolist()
    rsc_l = rsc.tolist()
    rpc_l = rpc.tolist()
    rsn_l = rsn.tolist()
    rse_l = rse.tolist()
    rpn_l = rpn.tolist()
    rpe_l = rpe.tolist()

    succ = {}
    pred = {}
    si = pi = 0
    for i, k in enumerate(names):
        c = rsc_l[i]
        d = {}
        for j in range(si, si + c):
            eid = rse_l[j]
            e = edges[eid]
            if e is None:
                m = em_l[eid]
                e = {
                    "paths": (
                        {0, 1} if m == 3 else {0} if m == 1
                        else {1} if m == 2 else set()
                    ),
                    "ofrom": "+",
                    "oto": "+",
                }
                edges[eid] = e
            d[names[rsn_l[j]]] = e
        succ[k] = d
        si += c
        c = rpc_l[i]
        d = {}
        for j in range(pi, pi + c):
            eid = rpe_l[j]
            e = edges[eid]
            if e is None:
                m = em_l[eid]
                e = {
                    "paths": (
                        {0, 1} if m == 3 else {0} if m == 1
                        else {1} if m == 2 else set()
                    ),
                    "ofrom": "+",
                    "oto": "+",
                }
                edges[eid] = e
            d[names[rpn_l[j]]] = e
        pred[k] = d
        pi += c

    G.nodes = nodes
    G.succ = succ
    G.pred = pred
    return True


def _rem2_replay(G: PanGraph, anchors):
    """Graph surgery replay for the native-loop anchors: per record, the
    exact mutation sequence of breaknode(A) + breaknode(B) + mergenodes
    (graphops.py:83-207), inlined for the fasta pairwise case (all
    edges '+'/'+', so the negstrand branches vanish) and without the
    IntervalIndex bookkeeping (the recursion already happened; nothing
    downstream reads it).  Node/edge dict insertion order is preserved
    operation for operation — the output graph is byte-identical to the
    per-step engine's, GFA topological numbering included.

    The whole replay runs in C when eligible (_rem2_replay_native);
    this Python loop is the reference implementation and fallback."""
    if _rem2_replay_native(G, anchors):
        return
    nodes = G.nodes
    succ = G.succ
    pred = G.pred

    def brk(node, pos, l):
        att = nodes[node]
        mn = (pos, pos + l)
        if mn == node:
            return node
        offs = att["offsets"]
        in_items = list(pred[node].items())
        out_items = list(succ[node].items())
        if in_items or out_items:
            pospaths = set()
            for _, d in in_items:
                pospaths |= d["paths"]
            for _, d in out_items:
                pospaths |= d["paths"]
        else:
            pospaths = set(offs.keys())

        # add mn (aligned set by the merge below, 0 until then)
        nodes[mn] = {
            "offsets": {s: o + (pos - node[0]) for s, o in offs.items()},
            "aligned": 0,
        }
        succ[mn] = {}
        pred[mn] = {}

        if node[0] != pos:
            pn = (node[0], pos)
            nodes[pn] = {"offsets": dict(offs), "aligned": 0}
            succ[pn] = {}
            pred[pn] = {}
            d = {"paths": set(pospaths), "ofrom": "+", "oto": "+"}
            succ[pn][mn] = d
            pred[mn][pn] = d
        else:
            pn = mn
        if node[1] != pos + l:
            sn = (pos + l, node[1])
            nodes[sn] = {
                "offsets": {
                    s: o + (pos + l - node[0]) for s, o in offs.items()
                },
                "aligned": 0,
            }
            succ[sn] = {}
            pred[sn] = {}
            d = {"paths": set(pospaths), "ofrom": "+", "oto": "+"}
            succ[mn][sn] = d
            pred[sn][mn] = d
        else:
            sn = mn

        # remove the original node, reattach its edges (all '+'/'+')
        for to in succ[node]:
            del pred[to][node]
        for fr in pred[node]:
            del succ[fr][node]
        del succ[node]
        del pred[node]
        del nodes[node]
        for fro, d in in_items:
            nd = dict(d)
            succ[fro][pn] = nd
            pred[pn][fro] = nd
        for to, d in out_items:
            nd = dict(d)
            succ[sn][to] = nd
            pred[to][sn] = nd
        return mn

    for ma, mb, l, a_beg, a_end, b_beg, b_end in anchors.tolist():
        mn_a = brk((a_beg, a_end), ma, l)
        mn_b = brk((b_beg, b_end), mb, l)
        # mergenodes([mn_a, mn_b]) (graphops.py:161-207, DiGraph branch)
        da = nodes[mn_a]
        newoffsets = dict(da["offsets"])
        newoffsets.update(nodes[mn_b]["offsets"])
        da["offsets"] = newoffsets
        da["aligned"] = 1
        sa_ = succ[mn_a]
        pa_ = pred[mn_a]
        for u, d in pred[mn_b].items():
            if u in pa_:
                pa_[u]["paths"] |= d["paths"]
            else:
                nd = dict(d)
                succ[u][mn_a] = nd
                pa_[u] = nd
            del succ[u][mn_b]
        for v, d in succ[mn_b].items():
            if v in sa_:
                sa_[v]["paths"] |= d["paths"]
            else:
                nd = dict(d)
                sa_[v] = nd
                pred[v][mn_a] = nd
            del pred[v][mn_b]
        del succ[mn_b]
        del pred[mn_b]
        del nodes[mn_b]


def _align_loop(
    G: PanGraph,
    t: IntervalIndex,
    root: ESAIndex,
    cfg: PickerConfig,
    anchor_log=None,
):
    """LIFO worklist replicating aligner()'s threads=0 order.

    ``anchor_log`` (align/anchorlog.py) enables checkpoint/resume: the
    deterministic pop order means replaying the logged picks — graph
    surgery + SA split only, no enumeration, no pick DP — rebuilds the
    exact state, after which live picking continues and keeps logging.
    """
    if anchor_log is None:
        steps = _rem2_native_loop(G, t, root, cfg)
        if steps is not None:
            return steps
    picker = MumPicker(G, t, cfg)
    if not os.environ.get("REVEAL_TPU_DISABLE_FASTPICK"):
        picker.set_fastmap(root.nodes)
    replay = anchor_log.replay if anchor_log is not None else []
    queue = [root]
    steps = 0
    popcount = 0  # one log record per popped segment, incl. stops
    while queue:
        idx = queue.pop()  # LIFO (reveal.c:21-27)
        if popcount < len(replay):
            replaying = True
            pick = replay[popcount]
        else:
            replaying = False
            pick = _enum_pick(picker, idx, cfg)
            if anchor_log is not None:
                anchor_log.append(pick)
        popcount += 1
        if not pick:
            continue
        splitmum, skipleft, skipright = pick

        l, n, spd = splitmum
        result = graphalign(G, t, idx, splitmum)
        leading, trailing, matching, rest, merged, newleft, newright = result

        sp_positions = [p for gid, p in spd]
        lead_idx, trail_idx, par_idx = idx.split_segments(
            leading,
            trailing,
            matching,
            rest,
            sp_positions,
            l,
            newleft,
            newright,
            skipleft=skipleft,
            skipright=skipright,
            enum_minl=(
                None
                if replaying
                else cfg.minlength
                if picker.fastmap is not None
                and idx.main.nsamples == 2
                else None
            ),
        )
        steps += 1
        # push order parallel, leading, trailing (reveal.c:1295-1324)
        if par_idx is not None:
            queue.append(par_idx)
        if lead_idx is not None:
            queue.append(lead_idx)
        if trail_idx is not None:
            queue.append(trail_idx)
    log.debug("alignment finished after %d anchor steps", steps)
    return steps


def _align_loop_levels(
    G: PanGraph,
    t: IntervalIndex,
    root: ESAIndex,
    cfg: PickerConfig,
    threads: int,
):
    """Host level-synchronous parallel recursion (the reference's
    `rem -t/--threads`, reveal.py:76 / interface.c:338-359 — but
    deterministic: its pthread pool races on queue order, so node ids
    vary run to run; here the output is independent of thread count).

    Each level runs three phases, exactly the device frontier's
    semantics (_align_loop_frontier):

    1. enumerate + pick for every segment — parallel, read-only (the
       native scans and pick DPs release the GIL);
    2. graph surgery per picked segment — serial, in level order;
    3. 3-way split + matched-text lowercase + boundary repair —
       parallel: each job mutates only its own SA/LCP slices, its own
       suffixes' SAi entries and its own matched text intervals, all
       disjoint across same-level segments.

    Phase 1 runs before any phase-3 lowercase of the same level, so
    every segment's enumeration sees the text state of the previous
    level boundary — the property the frontier equivalence tests pin
    down (tests/test_frontier.py).

    Throughput note: the per-segment native kernels scale ~3x across 4
    threads in isolation, but each carries Python marshalling that
    serializes on the GIL, and the level layout forgoes the serial
    loop's fused cache-hot child enumeration (split3_repair_enum) — on
    the 4-vCPU image this nets out to roughly break-even with the
    serial LIFO loop.  The flag exists for reference CLI parity and for
    wider hosts where the native fraction amortizes the glue."""
    from concurrent.futures import ThreadPoolExecutor

    picker = MumPicker(G, t, cfg)
    if not os.environ.get("REVEAL_TPU_DISABLE_FASTPICK"):
        picker.set_fastmap(root.nodes)
        if picker.fastmap is not None:
            # warm the picker's lazy caches (_nsid/_id2end_arr) before
            # concurrent picking starts
            picker._boundary_arrays(root)

    def do_split(job):
        idx, splitmum, result, skipleft, skipright = job
        leading, trailing, matching, rest, merged, newleft, newright = result
        l, n, spd = splitmum
        sp_positions = [p for gid, p in spd]
        return idx.split_segments(
            leading,
            trailing,
            matching,
            rest,
            sp_positions,
            l,
            newleft,
            newright,
            skipleft=skipleft,
            skipright=skipright,
        )

    def run_sliced(ex, fn, items, nworkers):
        """Apply fn to items in order, splitting the level into at most
        nworkers contiguous slices (one future per slice: per-item
        futures cost more in scheduling than the native work saves).
        Narrow levels run inline."""
        n = len(items)
        out = [None] * n
        if n < 2 * nworkers:
            for i, it in enumerate(items):
                out[i] = fn(it)
            return out
        step = (n + nworkers - 1) // nworkers

        def run_slice(lo):
            hi = min(lo + step, n)
            for i in range(lo, hi):
                out[i] = fn(items[i])

        futs = [
            ex.submit(run_slice, lo) for lo in range(0, n, step)
        ]
        for f in futs:
            f.result()
        return out

    level = [root]
    steps = 0
    levels = 0
    with ThreadPoolExecutor(max_workers=max(threads, 1)) as ex:
        while level:
            levels += 1
            picks = run_sliced(
                ex,
                lambda idx: _enum_pick(picker, idx, cfg),
                level,
                threads,
            )
            jobs = []
            for idx, pick in zip(level, picks):
                if not pick:
                    continue
                splitmum, skipleft, skipright = pick
                result = graphalign(G, t, idx, splitmum)
                jobs.append((idx, splitmum, result, skipleft, skipright))
                steps += 1
            level = []
            for lead_idx, trail_idx, par_idx in run_sliced(
                ex, do_split, jobs, threads
            ):
                # child order mirrors the push order parallel, leading,
                # trailing (reveal.c:1295-1324)
                if par_idx is not None:
                    level.append(par_idx)
                if lead_idx is not None:
                    level.append(lead_idx)
                if trail_idx is not None:
                    level.append(trail_idx)
    log.debug(
        "threaded alignment: %d anchor steps in %d levels (threads=%d)",
        steps,
        levels,
        threads,
    )
    return steps


def read_fasta_into(
    fasta: str,
    ts: TextStore,
    t: IntervalIndex,
    G: PanGraph,
    root_nodes: set,
    contigs: bool = True,
    toupper: bool = True,
):
    """Port of utils.read_fasta (utils.py:304-375): per-sequence start/end
    endpoint markers, per-path registry entries."""
    if contigs:
        ts.add_sample(os.path.basename(fasta))
    for name, seq in fasta_reader(fasta, toupper=toupper):
        if not contigs:
            ts.add_sample(name)
        name = name.replace(":", "").replace(";", "")
        if name in G.graph["paths"]:
            raise ValueError(
                "duplicate sequence name in graph: %r" % name
            )
        sid = len(G.graph["paths"])
        G.graph["paths"].append(name)
        G.graph["path2id"][name] = sid
        G.graph["id2path"][sid] = name
        G.graph["id2end"][sid] = len(seq)

        iv = ts.add_sequence(seq)
        t.add(iv)
        startnode = uuid.uuid4().hex
        endnode = uuid.uuid4().hex
        G.add_node(startnode, offsets={sid: 0}, endpoint=True)
        G.graph["startnodes"].append(startnode)
        G.add_node(iv, offsets={sid: 0}, aligned=0)
        G.add_node(endnode, offsets={sid: len(seq)}, endpoint=True)
        G.graph["endnodes"].append(endnode)
        G.add_edge(startnode, iv, paths={sid}, ofrom="+", oto="+")
        G.add_edge(iv, endnode, paths={sid}, ofrom="+", oto="+")
        root_nodes.add(iv)


def _rem_device_hybrid(
    G: PanGraph, t: IntervalIndex, root: ESAIndex, cfg: PickerConfig,
    device,
):
    """Host prefix + device forest split of the pairwise recursion.

    The native engine runs every segment with more than ``DEFER_MAX``
    candidates and freezes each smaller one at its serial pop position;
    the residual forest then runs on ``device``, and its subtrees are
    spliced back at their placeholders, so the replayed anchor stream
    (and the GFA) is byte-identical to the serial engine's.  Returns
    the anchor count, or None when the prefix cannot defer or the forest
    declines (the text and inverse SA restored, the reason in
    ``devloop.LAST_STATS["fallback"]``)."""
    from ..native import get_lib, rem2_defer_native

    if get_lib() is None:
        raise RuntimeError("the native host engine "
                           "(reveal_tpu_torch/native) failed to build or "
                           "load")
    main = root.main
    nsep0 = int(main.nsep[0])
    defer_max = DEFER_MAX
    if cfg.maxmums > 0:
        defer_max = min(defer_max, int(cfg.maxmums))
    T = main.T
    SAi = main.SAi
    t_snap = T.copy()
    sai_snap = SAi.copy()
    t0 = time.perf_counter()
    with trace.span("rem.host_prefix"):
        res = rem2_defer_native(
            T, root.SA, root.LCP, SAi, nsep0, cfg.minlength, cfg.trim,
            cfg.maxmums, int(cfg.wscore), float(cfg.wpen), cfg.pcutoff,
            defer_max, threads=min(os.cpu_count() or 1, 8),
        )
    t_host = time.perf_counter() - t0
    if res is None:
        T[:] = t_snap
        SAi[:] = sai_snap
        devloop.LAST_STATS.clear()
        devloop.LAST_STATS.update(host_prefix_seconds=t_host,
                                  fallback="host prefix pick deferred")
        return None
    anchors, defers = res
    t0 = time.perf_counter()
    with trace.span("rem.forest"):
        dres = devloop.rem_device_forest(
            T, defers, nsep0, cfg.minlength, cfg.maxmums,
            int(cfg.wscore), int(cfg.wpen), device=device,
        )
    devloop.LAST_STATS.update(
        host_prefix_seconds=t_host,
        forest_seconds=time.perf_counter() - t0,
        defer_max=defer_max,
        fallback=None,
    )
    if dres is None:
        T[:] = t_snap
        SAi[:] = sai_snap
        devloop.LAST_STATS["fallback"] = _decline_reason(devloop.LAST_STATS,
                                                         len(T))
        return None
    subtrees, T_out, levels = dres
    T[: len(T_out)] = T_out  # device lowercase additions
    parts = []
    for row in anchors:
        if row[1] == -1 and row[2] == -1:
            sub = subtrees.get(int(row[0]))
            if sub is not None and len(sub):
                parts.append(sub)
        else:
            parts.append(row[None, :])
    allanch = np.concatenate(parts) if parts else np.zeros((0, 7), np.int64)
    with trace.span("rem.replay"):
        _rem2_replay(G, allanch)
    log.debug(
        "device hybrid: %d host + %d device anchors (%d deferred "
        "segments, %d device levels), graph replayed",
        len(anchors) - len(defers),
        len(allanch) - (len(anchors) - len(defers)),
        len(defers), levels,
    )
    return len(allanch)


def _abort_name(code):
    names = [k for k, v in vars(devloop).items()
             if k.startswith("ABORT_") and v == code]
    return names[0] if names else "unknown"


def _decline_reason(stats, n):
    """Why a device loop returned None, from its ``LAST_STATS``."""
    if stats.get("abort"):
        return "kernel abort code %d (%s)" % (stats["abort"],
                                              _abort_name(stats["abort"]))
    return "text of %d bytes, at or above 2^30" % n


def _rem_device_loop(
    G: PanGraph, t: IntervalIndex, root: ESAIndex, cfg: PickerConfig,
    device,
):
    """Whole-recursion DEVICE fast path (index/devloop.py): the complete
    pairwise recursion — enumerate, trim+chain+largest pick, split,
    lowercase, boundary repair — runs on ``device``; the logged anchors
    are replayed through the exact graph surgery in serial LIFO pop
    order, so the GFA is byte-identical to the per-step engine's.
    Returns the anchor count, or None when the input is not eligible or
    every route declined it (the caller runs the per-level frontier).

    ``REVEAL_TPU_DEVLOOP_MODE`` is ``hybrid`` (the default: the host
    prefix and device forest first, the single-root loop for what they
    decline) or ``full`` (the single-root loop alone).  A ``--notrim``
    input is not taken: the loop always trims (the port's frontier
    honours it).  ``devloop.LAST_STATS["fallback"]`` names every route
    that declined, ``loop_seconds`` the single-root loop's time."""
    devloop.LAST_STATS.clear()
    if not _pairwise_fast_eligible(G, root, cfg):
        return None
    if not cfg.trim:
        return None
    if not float(cfg.wpen).is_integer():
        return None  # device chain arithmetic is int32-exact
    if cfg.minlength < 1:
        return None  # p-value stop needs the host picker
    declined = []
    mode = os.environ.get("REVEAL_TPU_DEVLOOP_MODE", "hybrid")
    if mode == "hybrid":
        steps = _rem_device_hybrid(G, t, root, cfg, device)
        if steps is not None:
            return steps
        declined.append("forest: " + devloop.LAST_STATS["fallback"])
        log.info("device forest declined (%s): single-root loop on %s",
                 declined[-1], device)

    main = root.main
    t0 = time.perf_counter()
    with trace.span("rem.single_root"):
        res = devloop.rem_device_loop(
            main.T,
            root.SA,
            root.LCP,
            int(main.nsep[0]),
            cfg.minlength,
            cfg.maxmums,
            int(cfg.wscore),
            int(cfg.wpen),
            device=device,
        )
    st = devloop.LAST_STATS
    st["loop_seconds"] = time.perf_counter() - t0
    if res is None:
        declined.append("single-root loop: "
                        + _decline_reason(st, len(main.T)))
        st["fallback"] = "; ".join(declined)
        return None
    st["fallback"] = "; ".join(declined) or None
    anchors, T_out, levels = res
    main.T[:] = T_out  # device lowercased text -> host mirror
    with trace.span("rem.replay"):
        _rem2_replay(G, anchors)
    log.debug(
        "device loop: %d anchors in %d levels, graph replayed",
        len(anchors),
        levels,
    )
    return len(anchors)


def _rem_multi(G: PanGraph, t: IntervalIndex, root: ESAIndex,
               cfg: PickerConfig, device):
    """Three or more samples: the whole recursion on ``device`` through
    ``_rem_device_multi_loop``.  A decline (the loop leaves the text as
    it was) runs the per-level frontier on the same device, the
    reference's route for it.  Returns the anchor count."""
    st = devloop_multi.LAST_STATS
    st.clear()
    steps = _rem_device_multi_loop(G, t, root, cfg, device)
    if steps is not None:
        st["fallback"] = None
        return steps
    if not st:
        why = ("not eligible for the multi loop (more than 8 contig paths, "
               "graph input, non-default picking, seeding, size or depth "
               "gates)")
    elif st.get("pop_order_mismatch"):
        why = "anchor pop order does not cover the log"
    else:
        why = _decline_reason(st, len(root.main.T))
    st["fallback"] = why
    log.info("multi loop declined (%s): per-level frontier on %s", why,
             device)
    with trace.span("rem.frontier"):
        return _align_loop_frontier(G, t, root, cfg, device, declined=why)


def _align_frontier(G: PanGraph, t: IntervalIndex, root: ESAIndex,
                    cfg: PickerConfig, device, mesh=None):
    """The routes of ``_align_loop_frontier`` (reference rem.py:895-903),
    all on ``device``: three or more samples take the multi-genome loop;
    a pairwise fasta input of one sequence a sample (trimmed, an integral
    ``--wpen``, ``minlength >= 1``) the host prefix and device forest,
    what they decline the single-root loop (``_rem_device_loop``); every
    other input, and every decline of the loops, the per-level frontier.
    With ``mesh`` the loops are skipped, as in the reference: the
    per-level frontier runs sharded over the mesh's ranks."""
    if mesh is not None:
        with trace.span("rem.frontier"):
            return _align_loop_frontier(G, t, root, cfg, device, mesh=mesh)
    if root.main.nsamples > 2:
        return _rem_multi(G, t, root, cfg, device)
    steps = _rem_device_loop(G, t, root, cfg, device)
    if steps is not None:
        return steps
    why = devloop.LAST_STATS.get("fallback")
    if why:
        log.info("device loops declined (%s): per-level frontier on %s",
                 why, device)
    with trace.span("rem.frontier"):
        return _align_loop_frontier(G, t, root, cfg, device, declined=why)


def _align_loop_frontier(
    G: PanGraph, t: IntervalIndex, root: ESAIndex, cfg: PickerConfig,
    device, declined=None, mesh=None,
):
    """Device-resident level-synchronous recursion: T/SA/LCP/segment-ids
    live on ``device`` across levels (index/devfrontier.py).  Each level =
    one batched enumerate (pairwise conditions, or the PSV/NSV multiMUM
    formulation when >2 samples) + host picking / graph surgery + one
    batched apply (classification, segmented running-min LCP split,
    stable partition, text lowercase).  Boundary repairs (bubble_sort,
    reveal.c:666-727) are detected on device and fixed by fetching only
    the affected leading children.

    Per-segment decisions are independent (each segment owns disjoint
    text and graph regions), so the result is semantically identical to
    the LIFO loop; only GFA node numbering may differ.  ``declined``: why
    the device loops did not take this input, recorded as
    ``devfrontier.LAST_STATS["fallback"]``.

    With ``mesh`` (``parallel/mesh.Mesh``; ``device`` is its device) the
    frontier's slots are sharded over the mesh's ranks (reference
    rem.py:903-915): every rank runs this loop on the same host state,
    and every branch below reads values that are the same on every rank
    (the candidates, the counts, the host's own decisions), so the ranks
    post the same collectives in the same order."""
    import numpy as _np

    from ..index.devfrontier import DeviceFrontier, SegDesc

    stats = devfrontier.LAST_STATS
    stats.clear()
    stats.update(fallback=declined, levels=0, steps=0, applies=0,
                 enumerate_seconds=0.0, pick_seconds=0.0,
                 apply_seconds=0.0, repair_seconds=0.0)
    t_start = time.perf_counter()
    main = root.main
    picker = MumPicker(G, t, cfg)
    dev = DeviceFrontier(
        main.T,
        root.SA,
        root.LCP,
        main.SO if main.SO is not None and len(main.SO) else
        _np.zeros(len(main.T), _np.uint16),
        int(main.nsep[0]),
        main.nsamples,
        device,
        stats,
        **({} if mesh is None else dict(mesh=mesh, nsep=main.nsep)),
    )
    multi_mode = main.nsamples > 2

    segs = {
        0: SegDesc(
            sid=0,
            start=0,
            n=dev.n,
            depth=0,
            nsamples=main.nsamples,
            nodes=root.nodes,
            left_node=root.left_node,
            right_node=root.right_node,
            skipmums=list(root.skipmums),
        )
    }
    steps = 0
    levels = 0
    while segs:
        levels += 1
        sids = sorted(segs)
        starts = _np.array([segs[s].start for s in sids])

        # ---- enumerate all segments in one dispatch -------------------
        with trace.span("frontier.enumerate", stats, "enumerate_seconds"):
            mums_for = {}
            need = any(not segs[s].skipmums for s in sids)
            if need and multi_mode:
                ls, lbs, ubs, sa_rows, so_rows = dev.enumerate_multi(
                    cfg.minlength, cfg.minn
                )
                if len(ls):
                    trip = _np.stack([ls, lbs, ubs], axis=1)
                    _, uniq = _np.unique(trip, axis=0, return_index=True)
                    uniq = _np.sort(uniq)
                    order = uniq[
                        _np.lexsort(
                            (ubs[uniq], lbs[uniq], ls[uniq])
                        )
                    ]
                    owner = _np.searchsorted(
                        starts, lbs[order], side="right"
                    ) - 1
                    for k, oi in zip(order.tolist(), owner.tolist()):
                        w = int(ubs[k] - lbs[k] + 1)
                        coords = tuple(
                            (int(so_rows[k, c]), int(sa_rows[k, c]))
                            for c in range(w)
                        )
                        mums_for.setdefault(sids[oi], []).append(
                            (int(ls[k]), w, coords)
                        )
            elif need:
                slots, l, a, b = dev.enumerate_pairwise(cfg.minlength)
                owner = _np.searchsorted(starts, slots, side="right") - 1
                for k in range(len(slots)):
                    mums_for.setdefault(sids[int(owner[k])], []).append(
                        (int(l[k]), 2, ((0, int(a[k])), (1, int(b[k]))))
                    )

        # ---- pick + graph surgery per segment in level order ----------
        with trace.span("frontier.pick", stats, "pick_seconds"):
            S = len(sids)
            seg_map = _np.full((S, 5), -1, dtype=_np.int32)
            sid_index = {s: i for i, s in enumerate(sids)}
            intervals = []
            matches_all = []
            repair_jobs = []  # (lead_sid, sorted own match begins)
            child_descs = {}
            next_sid = 0

            for s in sids:
                seg = segs[s]
                if seg.skipmums:
                    precomputed = True
                    mums = seg.skipmums
                else:
                    precomputed = False
                    mums = mums_for.get(s, [])

                pick = picker(
                    mums, seg, precomputed=precomputed, minlength=cfg.minlength
                )
                if not pick:
                    continue
                splitmum, skipleft, skipright = pick
                ml, mn, spd = splitmum
                (
                    leading,
                    trailing,
                    matching,
                    rest,
                    merged,
                    newleft,
                    newright,
                ) = graphalign(G, t, seg, splitmum)
                steps += 1
                sp_positions = [p for gid, p in spd]
                own_matches = sorted(matching)
                matches_all.extend(own_matches)
                for bgn, end in matching:
                    intervals.append((bgn, end, 3))

                def _mk(desc_nodes, cls, left, right, skip):
                    nonlocal next_sid
                    for bgn, end in desc_nodes:
                        intervals.append((bgn, end, cls))
                    if not desc_nodes:
                        return None
                    sid = next_sid
                    next_sid += 1
                    seg_map[sid_index[s], cls] = sid
                    seen = {int(main.SO[bgn]) for bgn, _e in desc_nodes}
                    child_descs[sid] = SegDesc(
                        sid=sid,
                        start=0,
                        n=0,
                        depth=seg.depth + 1,
                        nsamples=len(seen),
                        nodes=set(desc_nodes),
                        left_node=left,
                        right_node=right,
                        skipmums=list(skip or []),
                    )
                    return sid

                # child creation order mirrors the push order parallel,
                # leading, trailing (reveal.c:1295-1324)
                _mk(rest, 4, seg.left_node, seg.right_node, [])
                lead_sid = _mk(leading, 1, seg.left_node, newright, skipleft)
                _mk(trailing, 2, newleft, seg.right_node, skipright)
                if lead_sid is not None:
                    repair_jobs.append(
                        (lead_sid, [bgn for bgn, _e in own_matches])
                    )

            # host text mirror follows the device lowercase (prune_nodes and
            # later library use read main.T); matched regions lowercase even
            # when no child segments remain (reveal.c:1230-1234 runs
            # unconditionally)
            for bgn, end in matches_all:
                tt = main.T[bgn:end]
                low = (tt >= ord("A")) & (tt <= ord("Z"))
                tt[low] += 32

        if next_sid == 0:
            break

        # ---- apply split + lowercase on device ------------------------
        with trace.span("frontier.apply", stats, "apply_seconds"):
            counts, rcount = dev.apply_level(
                intervals, seg_map, matches_all, repair_jobs
            )
            stats["applies"] += 1

        with trace.span("frontier.repair", stats, "repair_seconds"):
            offsets = _np.zeros(len(counts) + 1, dtype=_np.int64)
            offsets[1:] = _np.cumsum(counts)
            nxt = {}
            for sid, desc in child_descs.items():
                cnt = int(counts[sid])
                if cnt == 0:
                    continue
                desc.start = int(offsets[sid])
                desc.n = cnt
                nxt[sid] = desc

            # ---- boundary repair on affected leading children (batched:
            # one gather + scatter per level) ----------------------------
            dev.repair_children(
                [
                    (nxt[lead_sid].start, nxt[lead_sid].n, begins)
                    for lead_sid, begins in repair_jobs
                    if lead_sid in nxt and begins and int(rcount[lead_sid]) > 0
                ]
            )

        segs = nxt

    stats.update(levels=levels, steps=steps,
                 seconds=time.perf_counter() - t_start)
    log.debug(
        "device frontier: %d anchor steps in %d levels", steps, levels
    )
    return steps


def _read_inputs(inputfiles: List[str], multi: bool = False,
                 contigs: bool = True):
    """Fasta and ``.gfa``/``.gfa.gz`` inputs -> (text store, interval
    index, graph, root nodes), as ``reveal_tpu.align.rem.align_genomes``
    reads them (rem.py:1197-1217): a ``MultiPanGraph`` with ``multi``;
    ``contigs=False`` makes every fasta record a sample of its own."""
    ts = TextStore()
    t = IntervalIndex()
    G = MultiPanGraph() if multi else PanGraph()
    root_nodes = set()
    for sample in inputfiles:
        if sample.endswith(".gfa") or sample.endswith(".gfa.gz"):
            ts.add_sample(os.path.basename(sample))
            read_gfa_into(sample, ts, t, G, root_nodes)
        else:
            read_fasta_into(sample, ts, t, G, root_nodes, contigs=contigs)
    if ts.nsamples <= 1:
        raise ValueError(
            "Specify at least 2 targets to construct an alignment."
        )
    return ts, t, G, root_nodes


def _run_device(device, mesh):
    """The device of a ``rem`` entry point: ``mesh.device`` with a mesh
    (a ``device`` that names another one raises), else ``device`` (the
    card unless the caller names the CPU)."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    if device is not None and not devfrontier.same_device(device,
                                                           mesh.device):
        raise ValueError("device %s contradicts the mesh's device %s"
                         % (device, mesh.device))
    return mesh.device


def align_genomes(
    inputfiles: List[str],
    device=None,
    contigs: bool = True,
    backend: str = "native",
    safile=None,
    lcpfile=None,
    cache: bool = False,
    multi: bool = False,
    frontier: bool = True,
    threads: int = 0,
    checkpoint: Optional[str] = None,
    mesh=None,
    **cfgkw,
):
    """Alignment of two or more fasta or ``.gfa`` files -> (G, idx).
    Mirrors ``reveal_tpu.align.rem.align_genomes`` (rem.py:1174-1244).
    With ``frontier`` (the default here, and the CLI's route) the
    recursion runs on ``device``: three or more samples take the
    multi-genome device loop, a plain pair the host prefix and device
    forest, every other input (and every decline of the multi loop) the
    per-level device frontier.  ``frontier=False`` runs the reference's
    host drivers on the host: ``threads > 0`` the level-synchronous
    ``_align_loop_levels``, else the serial LIFO ``_align_loop``;
    ``checkpoint`` (which needs ``frontier=False`` and no threads, as in
    the reference) logs every pick of the LIFO loop to that file and
    resumes from it.  ``device`` (None: the card) is checked on every
    route.  ``mesh`` (``parallel/mesh.make_mesh``; Python API only, as in
    the reference) runs the per-level frontier sharded over its ranks on
    its device, whatever ``frontier`` says: every rank of the mesh calls
    this with the same arguments and gets the same graph.  ``backend``
    is the suffix-array build (``build_esa``; ``"jax"`` builds on
    ``device``), ``safile``/
    ``lcpfile`` load one and ``cache`` writes it; ``multi`` builds the
    parallel-edge graph (``MultiPanGraph``); ``cfgkw`` are
    ``PickerConfig`` fields."""
    dev = _run_device(device, mesh)
    with trace.span("rem.read"):
        ts, t, G, root_nodes = _read_inputs(inputfiles, multi, contigs)
    with trace.span("rem.esa"):
        idx = ESAIndex.construct(ts, backend=backend, safile=safile,
                                 lcpfile=lcpfile, cache=cache, device=dev)
    idx.nodes = root_nodes
    cfg = PickerConfig(**cfgkw)
    if checkpoint:
        if frontier or mesh is not None or (threads and threads > 0):
            raise ValueError(
                "checkpoint/resume requires the serial LIFO driver "
                "(drop --frontier/--threads)"
            )
        from .anchorlog import AnchorLog, text_fingerprint

        log.info("checkpoint %s: the serial LIFO host engine, the one "
                 "route that can resume", checkpoint)
        alog = AnchorLog(checkpoint, text_fingerprint(idx.main.T), cfg)
        try:
            _align_loop(G, t, idx, cfg, anchor_log=alog)
        finally:
            alog.close()
    elif frontier or mesh is not None:
        _align_frontier(G, t, idx, cfg, dev, mesh)
    elif threads and threads > 0:
        _align_loop_levels(G, t, idx, cfg, threads)
    else:
        _align_loop(G, t, idx, cfg)
    return G, idx


def align_genomes_host(inputfiles: List[str], multi: bool = False,
                       **cfgkw):
    """Alignment of fasta or ``.gfa`` files by the serial host engine
    alone (``_align_loop``: the native whole-recursion loop where
    eligible, else the per-step LIFO loop) -> (G, idx).  The reference
    the device path is held to; not an entry point of the CLI."""
    ts, t, G, root_nodes = _read_inputs(inputfiles, multi)
    idx = ESAIndex.construct(ts, backend="native")
    idx.nodes = root_nodes
    _align_loop(G, t, idx, PickerConfig(**cfgkw))
    return G, idx


def node_state(G):
    """The aligned node set of a graph: every interval node with its
    offsets and aligned flag, sorted.  Every route of ``rem`` builds the
    same one for an input; only the GFA's node numbering may differ."""
    return sorted(
        (n, tuple(sorted(G.nodes[n]["offsets"].items())),
         G.nodes[n].get("aligned", 0))
        for n in G.nodes if isinstance(n, tuple))


def write_rem_gfa(G, idx, out) -> bytes:
    """Write the graph of ``align_genomes`` to ``out`` as ``cli rem``
    writes it (pruned when it has more than two paths, the node
    sequences attached); returns the file's bytes."""
    from ..core.io_gfa import seq2node, write_gfa

    if len(G.graph["paths"]) > 2:
        prune_nodes(G, T=idx.main.T)
    seq2node(G, idx.main.T)
    out = write_gfa(G, idx.main.T, outputfile=out)
    with open(out, "rb") as fh:
        return fh.read()


def rem_on_world(inputfiles: List[str], n_devices=None, device="cuda",
                 **kw):
    """``align_genomes(inputfiles, mesh=make_mesh(n_devices, device),
    **kw)`` on this rank of the running process group, the GFA written as
    ``cli rem`` writes it into a temporary directory: a dict of the node
    state (``node_state``), the text, the GFA's bytes and
    ``devfrontier.LAST_STATS``, or None on a rank outside the mesh.  The
    call a ``parallel.distributed.World`` sends its ranks; every rank of
    the group must make it."""
    import tempfile

    from ..parallel.mesh import make_mesh

    mesh = make_mesh(n_devices, device)
    if mesh is None:
        return None
    G, idx = align_genomes(inputfiles, mesh=mesh, **kw)
    state, T = node_state(G), idx.main.T.copy()
    with tempfile.TemporaryDirectory(prefix="rem_on_world_") as wd:
        gfa = write_rem_gfa(G, idx, os.path.join(wd, "rem.gfa"))
    return dict(state=state, T=T, gfa=gfa, stats=dict(devfrontier.LAST_STATS))


def _multi_fast_eligible(
    G: PanGraph, root: ESAIndex, cfg: PickerConfig
):
    """Eligibility for the whole-recursion multi device loop: plain
    multi-fasta roots (whole contig-paths at offset 0, up to 8 paths,
    >=3 samples), default largest/sumofpairs picking, no seeding/size
    gates.  Returns (path_ivs, path_samples) or None."""
    main = root.main
    DS = main.nsamples
    if (
        getattr(G, "multi", False)
        or DS < 3
        or os.environ.get("REVEAL_TPU_DISABLE_FASTPICK")
        or cfg.splitchain != "largest"
        or cfg.gcmodel != "sumofpairs"
        or not float(cfg.wscore).is_integer()
        or not float(cfg.wpen).is_integer()
        or cfg.seedsize
        or cfg.maxdepth is not None
        or cfg.maxsize is not None
        or not cfg.trim
        or cfg.minlength < 1
        or root.skipmums
    ):
        return None
    nodes = sorted(
        iv for iv in root.nodes if not isinstance(iv, str)
    )
    if len(nodes) > 8:
        return None
    path_ivs = []
    path_samples = []
    for iv in nodes:
        offs = G.nodes[iv]["offsets"]
        if len(offs) != 1:
            return None
        (pid, off), = offs.items()
        if off != 0 and True:
            # non-zero offsets appear for graph inputs only
            return None
        path_ivs.append((int(iv[0]), int(iv[1])))
        path_samples.append(int(main.SO[iv[0]]))
    # path dim order must equal path id order for the replay's
    # node-offset arithmetic; require path ids == sorted position order
    pid_of = []
    for iv in nodes:
        (pid, _), = G.nodes[iv]["offsets"].items()
        pid_of.append(pid)
    if pid_of != sorted(pid_of):
        return None
    pidvals = sorted(G.graph.get("path2id", {}).values())
    if pidvals != list(range(len(pidvals))):
        return None
    return path_ivs, path_samples


def _rem_multi_replay(G: PanGraph, anchors, D: int):
    """Graph surgery replay for multi anchors (records in serial pop
    order): per record, breaknode per subset sample ascending
    (graphalign hit order = spd order, rem.py:332-345) then mergenodes
    into the first match node (graphops.mergenodes DiGraph branch,
    rem.py:131-201).  Same inlined mutation sequence as _rem2_replay."""
    nodes = G.nodes
    succ = G.succ
    pred = G.pred

    def brk(node, pos, l):
        att = nodes[node]
        mn = (pos, pos + l)
        if mn == node:
            return node
        offs = att["offsets"]
        in_items = list(pred[node].items())
        out_items = list(succ[node].items())
        if in_items or out_items:
            pospaths = set()
            for _, d in in_items:
                pospaths |= d["paths"]
            for _, d in out_items:
                pospaths |= d["paths"]
        else:
            pospaths = set(offs.keys())
        nodes[mn] = {
            "offsets": {s: o + (pos - node[0]) for s, o in offs.items()},
            "aligned": 0,
        }
        succ[mn] = {}
        pred[mn] = {}
        if node[0] != pos:
            pn = (node[0], pos)
            nodes[pn] = {"offsets": dict(offs), "aligned": 0}
            succ[pn] = {}
            pred[pn] = {}
            d = {"paths": set(pospaths), "ofrom": "+", "oto": "+"}
            succ[pn][mn] = d
            pred[mn][pn] = d
        else:
            pn = mn
        if node[1] != pos + l:
            sn = (pos + l, node[1])
            nodes[sn] = {
                "offsets": {
                    s: o + (pos + l - node[0]) for s, o in offs.items()
                },
                "aligned": 0,
            }
            succ[sn] = {}
            pred[sn] = {}
            d = {"paths": set(pospaths), "ofrom": "+", "oto": "+"}
            succ[mn][sn] = d
            pred[sn][mn] = d
        else:
            sn = mn
        for to in succ[node]:
            del pred[to][node]
        for fr in pred[node]:
            del succ[fr][node]
        del succ[node]
        del pred[node]
        del nodes[node]
        for fro, d in in_items:
            nd = dict(d)
            succ[fro][pn] = nd
            pred[pn][fro] = nd
        for to, d in out_items:
            nd = dict(d)
            succ[sn][to] = nd
            pred[to][sn] = nd
        return mn

    for rec in anchors.tolist():
        l = rec[0]
        w = rec[1]
        ordp = rec[4]
        pos = rec[5:5 + D]
        beg = rec[5 + D:5 + 2 * D]
        end = rec[5 + 2 * D:5 + 3 * D]
        # break order = the pick's coord order (SA-window order, packed
        # 4 bits per sample in ordpack) — graphalign's hit order
        mns = []
        for j in range(w):
            d = (ordp >> (4 * j)) & 15
            mns.append(brk((beg[d], end[d]), pos[d], l))
        refnode = mns[0]
        da = nodes[refnode]
        newoffsets = dict(da["offsets"])
        for mn in mns[1:]:
            newoffsets.update(nodes[mn]["offsets"])
        da["offsets"] = newoffsets
        da["aligned"] = 1
        sa_ = succ[refnode]
        pa_ = pred[refnode]
        for mn in mns[1:]:
            for u, d in pred[mn].items():
                if u in pa_:
                    pa_[u]["paths"] |= d["paths"]
                else:
                    nd = dict(d)
                    succ[u][refnode] = nd
                    pa_[u] = nd
                del succ[u][mn]
            for v, d in succ[mn].items():
                if v in sa_:
                    sa_[v]["paths"] |= d["paths"]
                else:
                    nd = dict(d)
                    sa_[v] = nd
                    pred[v][refnode] = nd
                del pred[v][mn]
            del succ[mn]
            del pred[mn]
            del nodes[mn]


def _rem_device_multi_loop(
    G: PanGraph, t: IntervalIndex, root: ESAIndex, cfg: PickerConfig,
    device,
):
    """Whole-recursion multi device fast path (devloop_multi.rem_device_multi):
    the complete multi-genome recursion as one level loop on ``device``,
    then the anchor-replay graph surgery in serial LIFO pop order — GFA
    byte-identical to the per-step engine's.  Returns the anchor count,
    or None when ineligible/aborted (the caller declines the input)."""
    elig = _multi_fast_eligible(G, root, cfg)
    if elig is None:
        return None
    path_ivs, path_samples = elig

    main = root.main
    # the root's multiMUM count sizes the candidate and chain capacities
    arrs = root.getmultimums_arrays(minlength=cfg.minlength, minn=cfg.minn)
    if arrs is None:
        raise RuntimeError("the native multiMUM enumeration "
                           "(reveal_tpu_torch/native) failed to load")
    nroot = len(arrs[0])
    with trace.span("rem.multi_loop"):
        res = devloop_multi.rem_device_multi(
            main.T,
            root.SA,
            root.LCP,
            path_ivs,
            path_samples,
            cfg.minlength,
            cfg.minn,
            cfg.maxmums,
            int(cfg.wscore),
            int(cfg.wpen),
            root_mums=max(64, int(nroot)),
            device=device,
        )
    if res is None:
        return None
    anchors, T_out, levels = res
    main.T[:] = T_out
    with trace.span("rem.replay"):
        _rem_multi_replay(G, anchors, len(path_ivs))
    log.debug(
        "device multi loop: %d anchors in %d levels, graph replayed",
        len(anchors),
        levels,
    )
    return len(anchors)


def _seqs_graph(aobjs: List[Tuple[str, str]], backend: str, device=None):
    """The in-memory input of ``align_seqs``: (G, t, idx, startnode,
    endnode) with one shared start/end marker node (rem.py:616-712);
    ``device`` is where ``backend="jax"`` builds the suffix array."""
    ts = TextStore()
    t = IntervalIndex()
    G = PanGraph()

    startnode = uuid.uuid4().hex
    endnode = uuid.uuid4().hex
    G.add_node(startnode)
    G.add_node(endnode)

    root_nodes = set()
    for name, seq in aobjs:
        ts.add_sample(name)
        iv = ts.add_sequence(seq.upper())
        if iv[1] - iv[0] > 0:
            t.add(iv)
            sid = len(G.graph["paths"])
            G.graph["path2id"][name] = sid
            G.graph["id2path"][sid] = name
            G.graph["id2end"][sid] = len(seq)
            G.graph["paths"].append(name)
            G.add_node(iv, offsets={sid: 0}, aligned=0)
            G.add_edge(startnode, iv, paths={sid}, ofrom="+", oto="+")
            G.add_edge(iv, endnode, paths={sid}, ofrom="+", oto="+")
            root_nodes.add(iv)

    idx = ESAIndex.construct(ts, backend=backend, device=device)
    idx.nodes = root_nodes
    return G, t, idx, startnode, endnode


def align_seqs(
    aobjs: List[Tuple[str, str]],
    minlength: int = 20,
    minn: int = 2,
    seedsize: int = 0,
    maxmums: int = 10000,
    wpen: float = 1,
    wscore: float = 1,
    pcutoff: float = 1e-8,
    gcmodel: str = "sumofpairs",
    maxsize: Optional[int] = None,
    trim: bool = True,
    backend: str = "auto",
    device=None,
    mesh=None,
):
    """In-memory multi-alignment of (name, seq) tuples -> (G, idx).

    Mirrors rem.align (rem.py:616-712): one shared start/end marker node,
    prune_nodes afterwards, markers removed before returning.

    The recursion runs on ``device`` (None: the card) as
    ``align_seqs(..., frontier=True)`` of the reference routes it
    (``_align_frontier``): the multi-genome loop for three or more
    sequences, the host prefix and device forest (then the single-root
    loop) for a plain pair, the per-level frontier for the rest and for
    every decline of the loops.  With ``mesh`` the per-level frontier
    runs sharded over the mesh's ranks on its device (reference
    rem.py:1160-1161); every rank calls this with the same sequences.
    """
    dev = _run_device(device, mesh)
    G, t, idx, startnode, endnode = _seqs_graph(aobjs, backend, dev)

    cfg = PickerConfig(
        minlength=minlength,
        minn=minn,
        maxmums=maxmums,
        wpen=wpen,
        wscore=wscore,
        seedsize=seedsize,
        pcutoff=pcutoff,
        gcmodel=gcmodel,
        maxsize=maxsize,
        trim=trim,
    )
    _align_frontier(G, t, idx, cfg, dev, mesh)

    prune_nodes(G, T=idx.main.T)

    G.remove_node(startnode)
    G.remove_node(endnode)
    return G, idx


def align_seqs_host(aobjs: List[Tuple[str, str]], backend: str = "auto",
                    **cfgkw):
    """``align_seqs`` by the serial host engine alone (``_align_loop``:
    the native whole-recursion loop where eligible, else the per-step
    LIFO loop), as the reference's ``align_seqs(..., frontier=False)``
    runs it; ``cfgkw`` are ``PickerConfig`` fields.  The aligner of
    ``refine --method reveal_rem`` on every device."""
    G, t, idx, startnode, endnode = _seqs_graph(aobjs, backend)
    _align_loop(G, t, idx, PickerConfig(**cfgkw))
    prune_nodes(G, T=idx.main.T)
    G.remove_node(startnode)
    G.remove_node(endnode)
    return G, idx
