"""Routing of pairwise ``rem --frontier`` on a torch device.

Counterpart of ``reveal_tpu/align/rem.py``: ``align_genomes`` (:1174) and
``_rem_device_hybrid`` (:215).  The host half is imported from
``reveal_tpu`` unchanged: fasta reading, the native ESA, the native host
prefix ``rem2_defer_native``, the anchor replay ``_rem2_replay`` and the
serial host engine ``_align_loop``.  Only the deferred forest runs here,
on the device given (``index/devloop.rem_device_forest``).

Inputs the slice does not cover raise ``NotImplementedError``; they are
never routed to another engine.  When the forest declines an input (a
kernel abort code such as ``ABORT_DUP_REF``, which needs the host's
dict-aliasing, capacity retries that run out, the level cap, a text of
2^30 bytes or more, or a host prefix that cannot defer), a run on a
CUDA device raises, so that no run on the card finishes on the host
engine unseen.  On the CPU device it falls back to the serial host
engine as the reference does; the fallback is logged and recorded in
``devloop.LAST_STATS["fallback"]``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List

import numpy as np

from reveal_tpu.align.graphops import IntervalIndex
from reveal_tpu.align.picker import PickerConfig
from reveal_tpu.align.rem import (
    _align_loop,
    _pairwise_fast_eligible,
    _rem2_replay,
    read_fasta_into,
)
from reveal_tpu.core.textstore import TextStore
from reveal_tpu.graph.pangraph import PanGraph
from reveal_tpu.index.esa_index import ESAIndex

from ..core.torchconfig import resolve_device
from ..index import devloop

log = logging.getLogger(__name__)

# segments with at most this many enumerated candidates are deferred to
# the device forest (the reference's measured default)
DEFER_MAX = 16


def _not_covered(what: str, item: str):
    return NotImplementedError(
        "%s is not covered by reveal_tpu_torch yet (ROADMAP queue 1 "
        "item %s); run reveal_tpu for it" % (what, item)
    )


def _declined(G, t, root, cfg, T, SAi, t_snap, sai_snap, device, why):
    """The forest declined this input: restore the text and inverse SA;
    raise on a CUDA device, run the serial host engine on the CPU."""
    T[:] = t_snap
    SAi[:] = sai_snap
    devloop.LAST_STATS["fallback"] = why
    if device.type != "cpu":
        raise RuntimeError(
            "the device forest declined this input (%s) on %s; such "
            "inputs are not covered by reveal_tpu_torch yet (ROADMAP "
            "queue 1 item 2); run reveal_tpu for it" % (why, device)
        )
    log.warning("device forest declined (%s): host engine fallback", why)
    return _align_loop(G, t, root, cfg)


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
    the anchor count."""
    from reveal_tpu.native import get_lib, rem2_defer_native

    if get_lib() is None:
        raise RuntimeError("the native host engine (reveal_tpu/native) "
                           "failed to build or load")
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
    res = rem2_defer_native(
        T, root.SA, root.LCP, SAi, nsep0, cfg.minlength, cfg.trim,
        cfg.maxmums, int(cfg.wscore), float(cfg.wpen), cfg.pcutoff,
        defer_max, threads=min(os.cpu_count() or 1, 8),
    )
    t_host = time.perf_counter() - t0
    if res is None:
        devloop.LAST_STATS.clear()
        devloop.LAST_STATS.update(host_prefix_seconds=t_host)
        return _declined(G, t, root, cfg, T, SAi, t_snap, sai_snap, device,
                         "host prefix pick deferred")
    anchors, defers = res
    t0 = time.perf_counter()
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
        code = devloop.LAST_STATS.get("abort")
        why = ("kernel abort code %d" % code if code
               else "text of %d bytes, at or above 2^30" % len(T))
        return _declined(G, t, root, cfg, T, SAi, t_snap, sai_snap, device,
                         why)
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
    _rem2_replay(G, allanch)
    log.debug(
        "device hybrid: %d host + %d device anchors (%d deferred "
        "segments, %d device levels), graph replayed",
        len(anchors) - len(defers),
        len(allanch) - (len(anchors) - len(defers)),
        len(defers), levels,
    )
    return len(allanch)


def align_genomes(
    inputfiles: List[str],
    device="cuda",
    frontier: bool = True,
    **cfgkw,
):
    """Pairwise alignment of two fasta files -> (G, idx), the residual
    recursion on ``device``.  Mirrors ``reveal_tpu.align.rem.
    align_genomes(inputfiles, frontier=True)`` for the pairwise case;
    ``cfgkw`` are ``PickerConfig`` fields."""
    dev = resolve_device(device)
    if not frontier:
        raise _not_covered("the serial LIFO engine (no --frontier)", "10")
    for f in inputfiles:
        if f.endswith(".gfa") or f.endswith(".gfa.gz"):
            raise _not_covered("graph (.gfa) input", "6")
    if len(inputfiles) > 2:
        raise _not_covered("multi-genome alignment", "6")

    ts = TextStore()
    t = IntervalIndex()
    G = PanGraph()
    root_nodes = set()
    for sample in inputfiles:
        read_fasta_into(sample, ts, t, G, root_nodes)
    if ts.nsamples <= 1:
        raise ValueError(
            "Specify at least 2 targets to construct an alignment."
        )

    # "native", not "auto": a failed native build raises instead of
    # quietly switching to the numpy suffix sort
    idx = ESAIndex.construct(ts, backend="native")
    idx.nodes = root_nodes
    cfg = PickerConfig(**cfgkw)
    if not cfg.trim:
        raise _not_covered("--notrim", "8")
    if not _pairwise_fast_eligible(G, idx, cfg):
        raise _not_covered(
            "this input or configuration (multi-contig, seeding, size or "
            "depth gates, non-default picking)", "8",
        )
    if not float(cfg.wpen).is_integer() or cfg.minlength < 1:
        raise _not_covered("a fractional --wpen or minlength < 1", "8")
    _rem_device_hybrid(G, t, idx, cfg, dev)
    return G, idx
