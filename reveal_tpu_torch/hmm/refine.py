"""Bubble refinement: realign bubble alleles with the pair-HMM MSA and
splice the refined subgraph back into the variation graph.

Counterpart of ``reveal_tpu/hmm/refine.py`` (port of reveal/refine.py):

* ``refine_all``: bubble selection (simple/complex/size/diff/cumsize
  windows, gap filter), drop-nested selection, per-bubble realignment
  (refine.py:377-525);
* ``refine_bubble``: extract per-path allele sequences, run the
  consistency MSA, rebuild a column graph (refine.py:149-273);
* ``msa_to_graph``: MSA columns -> DAG honoring per-column confidence —
  low-confidence columns become per-sample nodes (refine.py:640-830);
* ``replace_bubble``: splice the refined subgraph between source and sink
  (refine.py:90-147).

``refine_all`` takes the reference's two routes.  On a CUDA device
every bubble whose chain tensor fits under ``msa.CHAIN_BYTES_CAP`` goes
through the fused stage-1+2 chain (``msa.batch_stage12_device``:
posteriors, MEA distances and the consistency transform on the card),
and the host runs only the rest of its MSA (``msa.probcons_align`` with
``precomputed_mats`` and ``precomputed_dist``).  The bubbles over the cap,
and on the CPU every bubble unless the caller names the chain
(``route="chain"``), take the two-phase route: the pair posteriors run as
a few large batches on the device (``msa.batch_posteriors_cut``), then
each bubble's MSA, consistency transform included, runs on the host.  The
reference's small-workload routes to the native host code and its full
two-phase recompute when a bubble is over the cap are not part of the
port, and a kernel, build or launch failure raises: only the size cap
sends a bubble to the two-phase route.  In compat mode
(``msa.set_logadd_compat``, ``refine --logadd-compat``) every bubble takes
the two-phase route with its posteriors from the LOG_ADD table twin on
the host, never the chain.  ``--method`` muscle, probcons, msaprobs or
pecan runs that aligner from ``$PATH`` (``_external_msa``) and
``reveal_rem`` the serial host anchor aligner on each bubble's alleles;
neither has a device stage, on any device, as in the reference.
``--nproc`` forks a process pool after the device stages: its workers
get host data only (numpy arrays and the host MSA), never a card tensor.
"""

from __future__ import annotations

import logging
import time
from collections import Counter
from typing import Dict, Optional

import torch

from . import msa as _msa
from .msa import probcons_align
from .pairhmm_dp import bucket_key
from ..graph.bubbles import Bubble, bubbles
from ..graph.extract import extract
from ..graph.pangraph import PanGraph

log = logging.getLogger(__name__)

# stats of the most recent refine_all call: bubbles, pairs, posterior
# cells, the route, the method, compat mode, the processes of the MSA
# pool (0: serial), the bubbles the chain took and their (N, Lq) shapes,
# its chunks and DP batches, the two-phase pairs per padded DP shape, a
# digest of every refined bubble's subgraph in splice order, and the
# seconds of its stages
LAST_STATS = {}

# (run_closure, jobs) installed right before a fork-based refine pool
# spawns; workers inherit it copy-on-write and receive only job indices
_mp_state = None


def _subgraph_digest(ng: PanGraph) -> str:
    """Digest of a refined bubble's column graph (node sequences, path
    offsets, edges with their paths): equal digests mean equal MSAs as
    far as the graph can tell."""
    import hashlib

    nodes = sorted(
        (n, d["seq"], sorted(d["offsets"].items()))
        for n, d in ng.nodes.items()
    )
    edges = sorted((u, v, sorted(d["paths"])) for u, v, d in
                   ng.edges(data=True))
    return hashlib.sha1(repr((nodes, edges)).encode()).hexdigest()


def _mp_run_job(i):
    run, jobs = _mp_state
    return run(jobs[i])


def _external_msa(aobjs, method: str, parameters: str = ""):
    """Run an external multiple-sequence aligner from $PATH and return
    (aligned_rows_in_path2id_order, confidence) — the same tool command
    lines as the reference (refine.msa2graph, refine.py:586-640)."""
    import os
    import subprocess
    import uuid as uuidmod

    from ..core.io_fasta import fasta_writer

    uid = uuidmod.uuid4().hex
    tempfiles = []
    if method == "muscle":
        cmd = "muscle -in %s.fasta -quiet" % uid
        fasta_writer(uid + ".fasta", aobjs)
        tempfiles.append("%s.fasta" % uid)
    elif method == "probcons":
        cmd = "probcons %s.fasta -annot %s.conf %s" % (uid, uid, parameters)
        fasta_writer(uid + ".fasta", aobjs)
        tempfiles += ["%s.fasta" % uid, "%s.conf" % uid]
    elif method == "msaprobs":
        cmd = "msaprobs %s.fasta -annot %s.conf %s" % (uid, uid, parameters)
        fasta_writer(uid + ".fasta", aobjs)
        tempfiles += ["%s.fasta" % uid, "%s.conf" % uid]
    elif method == "pecan":
        cmd = "pecan -G %s.fasta -F %s.*.fasta -l -p %s.conf %s && cat %s.fasta" % (
            uid, uid, uid, parameters, uid,
        )
        for i, (name, seq) in enumerate(aobjs):
            fasta_writer("%s.%d.fasta" % (uid, i), [(name, seq)])
            tempfiles.append("%s.%d.fasta" % (uid, i))
        tempfiles += ["%s.fasta" % uid, "%s.conf" % uid]
    else:
        raise ValueError("unknown msa method: %s" % method)

    try:
        out = subprocess.check_output(
            [cmd], shell=True, stderr=subprocess.DEVNULL, text=True
        )
        name2seq = {}
        for rec in out.split(">")[1:]:
            x = rec.find("\n")
            name2seq[rec[:x]] = rec[x + 1 :].replace("\n", "")
        ncols = len(next(iter(name2seq.values())))
        confidence = [100.0] * ncols
        if os.path.exists("%s.conf" % uid):
            with open("%s.conf" % uid) as annot:
                for i, line in enumerate(annot):
                    c = float(line.strip())
                    confidence[i] = c * 100 if c < 1 else c
        return name2seq, confidence
    finally:
        for f in tempfiles:
            if os.path.exists(f):
                os.remove(f)


def msa_to_graph(
    aobjs,
    idoffset: int = 0,
    minconf: int = 0,
    constrans: int = 2,
    consgap: bool = True,
    nrefinements: int = 100,
    precomputed=None,
    precomputed_scores=None,
    precomputed_mats=None,
    precomputed_dist=None,
    method: str = "reveal_probcons",
    parameters: str = "",
) -> Optional[PanGraph]:
    """MSA + column-graph construction (refine.msa2graph): the built-in
    pair-HMM consistency MSA (reveal_probcons), or an external aligner
    from $PATH (muscle/probcons/msaprobs/pecan, refine.py:586-640)."""
    nn = idoffset
    ng = PanGraph()
    for name, seq in aobjs:
        sid = len(ng.graph["paths"])
        ng.graph["path2id"][name] = sid
        ng.graph["id2path"][sid] = name
        ng.graph["id2end"][sid] = len(seq)
        ng.graph["paths"].append(name)

    if method in ("muscle", "probcons", "msaprobs", "pecan"):
        try:
            name2seq, confidence = _external_msa(
                aobjs, method, parameters
            )
        except Exception as e:
            log.error("MSA with %s failed: %s", method, e)
            return None
        seqs = [""] * len(aobjs)
        for name, seq in name2seq.items():
            seqs[ng.graph["path2id"][name]] = seq
    else:
        aln, confidence = probcons_align(
            aobjs,
            consistency=constrans,
            refinement=nrefinements,
            consgap=consgap,
            precomputed=precomputed,
            precomputed_scores=precomputed_scores,
            precomputed_mats=precomputed_mats,
            precomputed_dist=precomputed_dist,
        )
        seqs = [""] * len(aobjs)
        for name, seq in aln:
            seqs[ng.graph["path2id"][name]] = seq

    build_column_graph(ng, seqs, confidence, minconf=minconf, idoffset=nn)
    return ng


def build_column_graph(ng, seqs, confidence, minconf=0, idoffset=0):
    """MSA columns -> DAG (shared with convert's aligned-fasta input;
    utils.aln2graph is the reference's duplicate of this logic)."""
    nn = idoffset
    ncols = len(seqs[0])
    offsets = {o: -1 for o in range(len(seqs))}
    nid = nn
    sid2pnode: Dict[int, int] = {}
    pbase2node = {}
    pcol = {}
    pp = None

    for i in range(ncols):
        col = {}
        base2node = {}
        sid2node = {}
        p = confidence[i]

        for j in range(len(seqs)):
            col.setdefault(seqs[j][i], set()).add(j)
            if seqs[j][i] != "-":
                offsets[j] += 1

        for base in col:
            if i == 0:
                if p >= minconf:
                    ng.add_node(
                        nid,
                        seq=base,
                        offsets={
                            sid: offsets[sid]
                            for sid in offsets
                            if sid in col[base]
                        },
                        p=[p],
                    )
                    base2node[base] = nid
                    for sid in col[base]:
                        sid2node[sid] = nid
                    nid += 1
                else:  # new node per sequence
                    for sid in col[base]:
                        ng.add_node(
                            nid, seq=base, offsets={sid: offsets[sid]}, p=[p]
                        )
                        sid2node[sid] = nid
                        if base in base2node:
                            base2node[base].append(nid)
                        else:
                            base2node[base] = [nid]
                        nid += 1
            else:
                if p >= minconf and pp >= minconf:
                    for pbase in pcol:
                        overlap = pcol[pbase] & col[base]
                        if len(overlap) == 0:
                            continue
                        elif len(overlap) == len(col[base]) == len(
                            pcol[pbase]
                        ):  # append to previous column's node
                            ng.nodes[pbase2node[pbase]]["seq"] += base
                            ng.nodes[pbase2node[pbase]]["p"].append(p)
                            base2node[base] = pbase2node[pbase]
                            for sid in overlap:
                                sid2node[sid] = sid2pnode[sid]
                        else:
                            if base not in base2node:
                                ng.add_node(
                                    nid, seq=base, offsets=dict(), p=[p]
                                )
                                base2node[base] = nid
                                for sid in col[base]:
                                    sid2node[sid] = nid
                                nid += 1
                            for sid in overlap:
                                ng.nodes[base2node[base]]["offsets"][sid] = (
                                    offsets[sid]
                                )
                            ng.add_edge(
                                pbase2node[pbase],
                                base2node[base],
                                paths=set(overlap),
                                oto="+",
                                ofrom="+",
                            )
                elif p < minconf and pp >= minconf:
                    for sid in col[base]:
                        ng.add_node(
                            nid, seq=base, offsets={sid: offsets[sid]}, p=[p]
                        )
                        ng.add_edge(
                            sid2pnode[sid], nid, paths={sid}, oto="+",
                            ofrom="+",
                        )
                        sid2node[sid] = nid
                        if base in base2node:
                            base2node[base].append(nid)
                        else:
                            base2node[base] = [nid]
                        nid += 1
                elif p >= minconf and pp < minconf:
                    ng.add_node(nid, seq=base, offsets=dict(), p=[p])
                    for sid in col[base]:
                        ng.nodes[nid]["offsets"][sid] = offsets[sid]
                        if not ng.has_edge(sid2pnode[sid], nid):
                            ng.add_edge(
                                sid2pnode[sid],
                                nid,
                                paths={sid},
                                oto="+",
                                ofrom="+",
                            )
                        else:
                            ng.edge(sid2pnode[sid], nid)["paths"].add(sid)
                        sid2node[sid] = nid
                        base2node[base] = nid
                    nid += 1
                else:  # both below minconf: extend per-sample nodes
                    for sid in col[base]:
                        ng.nodes[sid2pnode[sid]]["seq"] += base
                        ng.nodes[sid2pnode[sid]]["p"].append(p)
                    sid2node = sid2pnode

        assert len(sid2node) == len(seqs)
        sid2pnode = sid2node
        pbase2node = base2node
        pcol = col
        pp = p

    # remove gap placeholders (refine.py:777-806)
    remove = []
    for node in list(ng.nodes):
        data = ng.nodes[node]
        incroffset = data["seq"][0] == "-"
        data["seq"] = data["seq"].replace("-", "")
        if data["seq"] == "":
            remove.append(node)
        elif incroffset:
            for sid in data["offsets"]:
                data["offsets"][sid] += 1
        data["aligned"] = 1 if len(data["offsets"]) > 1 else 0

    for node in remove:
        ine = list(ng.in_edges(node, data=True))
        oute = list(ng.out_edges(node, data=True))
        for in1, _, ind in ine:
            for _, out2, outd in oute:
                overlap = ind["paths"] & outd["paths"]
                if len(overlap) >= 1:
                    if ng.has_edge(in1, out2):
                        ng.edge(in1, out2)["paths"] |= overlap
                    else:
                        ng.add_edge(
                            in1, out2, paths=set(overlap), ofrom="+", oto="+"
                        )
    for node in remove:
        ng.remove_node(node)

    # contract unary chains with identical path sets (refine.py:808-819)
    updated = True
    while updated:
        updated = False
        for v, t in list(ng.edges()):
            if (
                len(ng.succ[v]) == 1
                and len(ng.pred[t]) == 1
                and ng.nodes[v]["offsets"].keys()
                == ng.nodes[t]["offsets"].keys()
            ):
                ng.nodes[v]["seq"] += ng.nodes[t]["seq"]
                for suc in list(ng.successors(t)):
                    ng.add_edge(v, suc, **ng.edge(t, suc))
                ng.remove_node(t)
                updated = True
                break

    return ng


def prepare_bubble_alleles(sg, bubble, paths, uniqueonly=False):
    """Extract the per-path allele sequences for a bubble (the aobjs of
    refine.py:158-196); None when there is nothing to refine."""
    if len(bubble.nodes) == 3:
        return None
    aobjs = []
    if uniqueonly:
        d = {}
        for sid in sorted(paths):
            seq = extract(sg, sg.graph["id2path"][sid])
            if len(seq) > 0:
                d.setdefault(seq, []).append(str(sid))
        if len(d) <= 1:
            return None
        aobjs = [(",".join(d[seq]), seq) for seq in d]
    else:
        for sid in sorted(paths):
            seq = extract(sg, sg.graph["id2path"][sid])
            if len(seq) > 0:
                aobjs.append((str(sid), seq))
        if len(aobjs) <= 1:
            return None
    return aobjs


def refine_bubble(
    sg: PanGraph,
    bubble: Bubble,
    offsets: Dict[int, int],
    paths,
    minconf: int = 0,
    constrans: int = 2,
    consgap: bool = True,
    nrefinements: int = 100,
    uniqueonly: bool = False,
    aobjs=None,
    precomputed=None,
    precomputed_scores=None,
    precomputed_mats=None,
    precomputed_dist=None,
    method: str = "reveal_probcons",
    parameters: str = "",
    minlength: int = 20,
    wpen: float = 1,
    wscore: float = 1,
    **_,
):
    """refine.py:149-273: reveal_probcons / external MSA methods, or
    reveal_rem (re-run the anchor aligner on the alleles,
    refine.py:219-231).  reveal_rem runs the serial host engine
    (``align.rem.align_seqs_host``) on every device, as the reference
    runs it."""
    if aobjs is None:
        aobjs = prepare_bubble_alleles(
            sg, bubble, paths, uniqueonly=uniqueonly
        )
    if aobjs is None:
        return None

    if method == "reveal_rem":
        from ..align.rem import align_seqs_host
        from ..core.io_gfa import seq2node

        try:
            ng, idx = align_seqs_host(
                aobjs,
                minlength=minlength,
                wpen=wpen,
                wscore=wscore,
                backend="np",
            )
        except Exception as e:
            log.error("reveal_rem realign failed: %s", e)
            return None
        seq2node(ng, idx.main.T)
    else:
        ng = msa_to_graph(
            aobjs,
            minconf=minconf,
            constrans=constrans,
            consgap=consgap,
            nrefinements=nrefinements,
            precomputed=precomputed,
            precomputed_scores=precomputed_scores,
            precomputed_mats=precomputed_mats,
            precomputed_dist=precomputed_dist,
            method=method,
            parameters=parameters,
        )
    if ng is None:
        return None

    # map path ids back to the original graph's id space
    for _, _, data in ng.edges(data=True):
        newpaths = set()
        for p in data["paths"]:
            for x in ng.graph["id2path"][p].split(","):
                newpaths.add(int(x))
        data["paths"] = newpaths
    for node in ng.nodes:
        data = ng.nodes[node]
        newoffsets = {}
        for sid in data["offsets"]:
            for x in ng.graph["id2path"][sid].split(","):
                newoffsets[int(x)] = data["offsets"][sid]
        data["offsets"] = newoffsets

    ng.graph["paths"] = sg.graph["paths"]
    ng.graph["path2id"] = sg.graph["path2id"]
    ng.graph["id2path"] = sg.graph["id2path"]

    path2start = {}
    path2end = {}
    for node in ng.nodes:
        data = ng.nodes[node]
        for sid in data["offsets"]:
            if (
                sid not in path2start
                or data["offsets"][sid] < path2start[sid][1]
            ):
                path2start[sid] = (node, data["offsets"][sid])
            if sid not in path2end or data["offsets"][sid] > path2end[sid][1]:
                path2end[sid] = (node, data["offsets"][sid])
        corrected = {
            sid: data["offsets"][sid] + offsets[sid]
            for sid in data["offsets"]
        }
        data["offsets"] = corrected

    return bubble, ng, path2start, path2end


def replace_bubble(G: PanGraph, bubble, ng: PanGraph, path2start, path2end, nn):
    """refine.py:90-147."""
    assert nn not in G.nodes
    for node in bubble.nodes[1:-1]:
        G.remove_node(node)

    mapping = {}
    for node in ng.nodes:
        mapping[node] = nn
        nn += 1
    for node in ng.nodes:
        G.add_node(mapping[node], **ng.nodes[node])
    for u, v, d in ng.edges(data=True):
        G.add_edge(mapping[u], mapping[v], **d)

    for sid in path2start:
        startnode = mapping[path2start[sid][0]]
        if G.has_edge(bubble.source, startnode):
            G.edge(bubble.source, startnode)["paths"].add(sid)
        else:
            G.add_edge(
                bubble.source, startnode, ofrom="+", oto="+", paths={sid}
            )
    for sid in path2end:
        endnode = mapping[path2end[sid][0]]
        if G.has_edge(endnode, bubble.sink):
            G.edge(endnode, bubble.sink)["paths"].add(sid)
        else:
            G.add_edge(endnode, bubble.sink, ofrom="+", oto="+", paths={sid})
    return G, nn


def select_realign_bubbles(
    G: PanGraph,
    minsize: int = 20,
    mindiff: int = 0,
    maxdiff: Optional[int] = None,
    maxsize: int = 10000,
    maxcumsize: Optional[int] = None,
    mincumsize: int = 0,
    complex_only: bool = False,
    simple_only: bool = False,
    nogaps: bool = False,
):
    """Bubble selection of refine.py:377-450: filter, sort by source
    index, keep the first of every overlapping run.  Shared by
    refine_all and the bench's reference-workload extractor so both see
    the identical bubble set."""
    realignbubbles = []
    for b in bubbles(G):
        if complex_only and b.issimple():
            continue
        if simple_only and not b.issimple():
            continue
        if nogaps and any(
            "N" in G.nodes[n].get("seq", "") for n in b.nodes
        ):
            continue
        if b.maxsize - b.minsize < mindiff:
            continue
        if maxdiff is not None and b.maxsize - b.minsize > maxdiff:
            continue
        if b.minsize < minsize:
            continue
        if b.maxsize > maxsize:
            continue
        if maxcumsize is not None and b.cumsize > maxcumsize:
            continue
        if b.cumsize < mincumsize:
            continue
        if len(b.nodes) == 3:
            continue
        realignbubbles.append(b)

    if not realignbubbles:
        return []
    realignbubbles.sort(key=lambda b: b.source_idx)
    distinct = [realignbubbles[0]]
    p = 0
    for i in range(1, len(realignbubbles)):
        if realignbubbles[i].source_idx >= realignbubbles[p].sink_idx:
            distinct.append(realignbubbles[i])
            p = i
    return distinct


def collect_bubble_aobjs(G: PanGraph, uniqueonly: bool = False, **kw):
    """The (name, seq) allele lists of every distinct realignable
    bubble — the exact per-bubble MSA workload refine_all dispatches.
    Used by the bench to hand the identical problem set to the
    reference ProbCons engine (refbench/refprobcons)."""
    jobs = []
    for bubble in select_realign_bubbles(G, **kw):
        bnodes = list(set(bubble.nodes) - {bubble.source, bubble.sink})
        sg = G.subgraph(bnodes)
        paths = set(G.nodes[bubble.source]["offsets"]) & set(
            G.nodes[bubble.sink]["offsets"]
        )
        aobjs = prepare_bubble_alleles(
            sg, bubble, paths, uniqueonly=uniqueonly
        )
        if aobjs is not None:
            jobs.append(aobjs)
    return jobs


def refine_all(
    G: PanGraph,
    minlength: int = 20,
    minsize: Optional[int] = None,
    mindiff: int = 0,
    maxdiff: Optional[int] = None,
    maxsize: int = 10000,
    maxcumsize: Optional[int] = None,
    mincumsize: int = 0,
    complex_only: bool = False,
    simple_only: bool = False,
    nogaps: bool = False,
    checkpoint: Optional[str] = None,
    checkpoint_meta: Optional[dict] = None,
    device="cuda",
    stage1: str = "device",
    route: Optional[str] = None,
    **kwargs,
):
    """refine.py:377-525 with the routing of reveal_tpu/hmm/refine.py:
    699-892.  ``device`` is the torch device of stages 1 and 2.

    ``route`` "chain": every bubble under ``msa.CHAIN_BYTES_CAP`` takes
    ``msa.batch_stage12_device`` (posteriors, MEA distances and the
    consistency transform on the device), and only the bubbles it
    returns ``None`` for take the two-phase route.  "two-phase": stage 1
    of every bubble through ``msa.batch_posteriors_cut`` on the device,
    stage 2 on the host in ``probcons_align``.  The default is the chain
    on a CUDA device and the two-phase route elsewhere, as the reference
    takes its chain on an accelerator only.  ``stage1="native"`` computes
    stage 1 of the two-phase route with the native float64 host pair-HMM
    instead, as a reference for the device.  In compat mode the default
    is the two-phase route on every device, and the chain is refused.
    ``method`` (a keyword) other than reveal_probcons skips stages 1 and
    2: the external aligner or ``reveal_rem`` realigns each bubble.

    ``checkpoint`` logs every bubble's result as it completes
    (hmm/refinelog.py); a resumed run skips the logged bubbles' device
    and MSA work entirely and splices their stored results in the
    original order — byte-identical output.  ``checkpoint_meta`` is
    folded into the log header (callers pin the input file hash)."""
    if minsize is None:
        minsize = minlength
    t_begin = time.time()

    ck = None
    if checkpoint:
        from .refinelog import RefineLog

        meta = dict(checkpoint_meta or {})
        meta.update(
            minlength=minlength,
            minsize=minsize,
            mindiff=mindiff,
            maxdiff=maxdiff,
            maxsize=maxsize,
            maxcumsize=maxcumsize,
            mincumsize=mincumsize,
            complex_only=complex_only,
            simple_only=simple_only,
            nogaps=nogaps,
        )
        for k in (
            "minconf",
            "constrans",
            "consgap",
            "nrefinements",
            "uniqueonly",
            "method",
            "parameters",
            "wpen",
            "wscore",
        ):
            if k in kwargs:
                meta[k] = kwargs[k]
        ck = RefineLog(checkpoint, meta)

    distinct = select_realign_bubbles(
        G,
        minsize=minsize,
        mindiff=mindiff,
        maxdiff=maxdiff,
        maxsize=maxsize,
        maxcumsize=maxcumsize,
        mincumsize=mincumsize,
        complex_only=complex_only,
        simple_only=simple_only,
        nogaps=nogaps,
    )
    if not distinct:
        log.info("No bubbles qualify for realignment.")
        return G
    log.info("Realigning %d bubbles", len(distinct))

    nn = max((n for n in G.nodes if isinstance(n, int)), default=0) + 1

    # phase 1: extract every bubble's alleles, collect all posterior pairs
    # so the pair-HMM runs as a few large device batches instead of one
    # round-trip per bubble.  Checkpointed bubbles skip extraction and
    # never join the batch; their stored results fill their slot.
    work = []
    all_pairs = []
    pair_slices = []
    slots = []  # splice order: ("stored", res) | ("job", work index)
    for bubble in distinct:
        G.nodes[bubble.source]["aligned"] = 1
        G.nodes[bubble.sink]["aligned"] = 1
        if ck is not None:
            stored = ck.done.get((bubble.source, bubble.sink))
            if stored is not None:
                slots.append(("stored", stored))
                continue
        bnodes = list(set(bubble.nodes) - {bubble.source, bubble.sink})
        sg = G.subgraph(bnodes)
        offsets = {
            sid: G.nodes[bubble.source]["offsets"][sid]
            + len(G.nodes[bubble.source]["seq"])
            for sid in G.nodes[bubble.source]["offsets"]
        }
        paths = set(G.nodes[bubble.source]["offsets"]) & set(
            G.nodes[bubble.sink]["offsets"]
        )
        aobjs = prepare_bubble_alleles(
            sg, bubble, paths, uniqueonly=kwargs.get("uniqueonly", False)
        )
        if aobjs is None:
            continue
        seqs = [s for _, s in aobjs]
        start = len(all_pairs)
        for a in range(len(seqs)):
            for b in range(a + 1, len(seqs)):
                all_pairs.append((seqs[a], seqs[b]))
        pair_slices.append((start, len(all_pairs)))
        slots.append(("job", len(work)))
        work.append((bubble, sg, offsets, paths, aobjs))

    from .msa import (
        batch_posteriors_cut,
        batch_posteriors_cut_native,
        batch_stage12_device,
    )

    method = kwargs.get("method", "reveal_probcons")
    if stage1 not in ("device", "native"):
        raise ValueError("stage1 must be 'device' or 'native'")
    if route is None:
        route = ("chain" if stage1 == "device" and not _msa._logadd_compat
                 and torch.device(device).type == "cuda" else "two-phase")
    if route not in ("chain", "two-phase") or (
            route == "chain" and (stage1 != "device"
                                  or _msa._logadd_compat)):
        raise ValueError("route must be 'chain' (with stage1='device', not "
                         "in compat mode) or 'two-phase'")
    # stages 1 and 2 belong to the built-in MSA only
    probcons = method == "reveal_probcons"
    t_extract = time.time() - t_begin

    # phase 1 (chain): posterior -> distance -> consistency on the device
    # for every bubble under msa.CHAIN_BYTES_CAP (msa.batch_stage12_device);
    # only the transformed mats and the distances come back
    posteriors = []
    pair_scores = []
    mats_for = [None] * len(work)
    dist_for = [None] * len(work)
    chain = {}
    t0 = time.time()
    if all_pairs and probcons and route == "chain":
        stage12 = batch_stage12_device(
            [[sq for _n, sq in w[4]] for w in work],
            consistency=kwargs.get("constrans", 2),
            consgap=kwargs.get("consgap", True),
            device=device,
            stats=chain,
        )
        for i, md in enumerate(stage12):
            if md is not None:
                mats_for[i], dist_for[i] = md
        log.info(
            "device posterior+consistency chain for %d/%d bubbles in %.2fs",
            sum(m is not None for m in mats_for),
            len(work),
            time.time() - t0,
        )
    t_chain = time.time() - t0

    # phase 1 (two-phase): stage 1 of the remaining bubbles' MSAs in a
    # few large batches on the device: cutoff survivors + MEA scores come
    # back (msa.batch_posteriors_cut; SparseMatrix.h:14,54 semantics);
    # probcons_align runs their stage 2 on the host
    rem_idx = [i for i in range(len(work))
               if probcons and mats_for[i] is None]
    rem_pairs = []
    for i in rem_idx:
        s, e = pair_slices[i]
        rem_pairs.extend(all_pairs[s:e])
    t0 = time.time()
    if rem_pairs:
        if stage1 == "native":
            trip = batch_posteriors_cut_native(rem_pairs)
        else:
            trip = batch_posteriors_cut(rem_pairs, device=device)
        posteriors = [None] * len(all_pairs)
        pair_scores = [None] * len(all_pairs)
        k = 0
        for i in rem_idx:
            s, e = pair_slices[i]
            posteriors[s:e] = [(p, tot) for p, tot, _ in trip[k: k + e - s]]
            pair_scores[s:e] = [s_ for _, _, s_ in trip[k: k + e - s]]
            k += e - s
        log.info(
            "computed %d pair posteriors for %d bubbles in %.2fs",
            len(rem_pairs),
            len(rem_idx),
            time.time() - t0,
        )
    t_stage1 = time.time() - t0
    t0 = time.time()

    # phase 2: per-bubble MSA on worker threads (refine_bubble only
    # reads its own subgraph + precomputed mats; the native MEA DP
    # releases the GIL, so threads scale it — the reference used an mp
    # pool here, refine.py:459-525), then the graph splice serially in
    # input order so the result is identical to the sequential loop.
    jobs = list(zip(work, pair_slices, mats_for, dist_for))

    def _run(job):
        (bubble, sg, offsets, paths, aobjs), (s, e), pmats, pdist = job
        t0 = time.time()
        res = refine_bubble(
            sg,
            bubble,
            offsets,
            paths,
            aobjs=aobjs,
            precomputed=posteriors[s:e] if posteriors else None,
            precomputed_scores=(
                pair_scores[s:e] if pair_scores else None
            ),
            precomputed_mats=pmats,
            precomputed_dist=pdist,
            minlength=minlength,
            **kwargs,
        )
        log.debug(
            "refine bubble <%s,%s> took %.3fs",
            bubble.source,
            bubble.sink,
            time.time() - t0,
        )
        return res

    # default SERIAL: on small hosts the thread pool convoys on the GIL
    # between the (GIL-releasing) native DP calls and makes the MSA
    # phase ~40% slower (measured 43-50s serial vs 61-78s at nproc=4 on
    # a 4-cpu host, same 554-bubble workload, byte-identical output);
    # --nproc N opts in for many-core hosts where the native fraction
    # can actually scale
    nproc = int(kwargs.pop("nproc", 0) or 1)
    # bubbles without precomputed stage-1/2 data compute posteriors on
    # the device inside refine_bubble — keep those serial (one device
    # client at a time); everything else is pure host work
    parallel_ix = [
        i
        for i, (_w, _se, pm, _pd) in enumerate(jobs)
        if pm is not None or posteriors
    ]
    results = [None] * len(jobs)
    pool_processes = 0

    def _record(i, res):
        results[i] = res
        if ck is not None and res is not None:
            b = work[i][0]
            ck.append((b.source, b.sink), res)

    par_set = set(parallel_ix)
    for i in range(len(jobs)):
        if i not in par_set:
            _record(i, _run(jobs[i]))
    if parallel_ix:
        ran = False
        if nproc > 1 and len(parallel_ix) > 1:
            # PROCESS pool over fork (like the reference's mp pool,
            # refine.py:459-525): a thread pool convoys on the GIL
            # around the native DP calls (measured slower than serial).
            # fork shares jobs/posteriors copy-on-write, so only the
            # job index goes out and the (picklable) per-bubble result
            # comes back; children run pure host numpy+native — the
            # inherited device client is never touched.
            import multiprocessing as _mp

            try:
                ctx = _mp.get_context("fork")
            except ValueError:
                ctx = None
            if ctx is not None:
                global _mp_state
                _mp_state = (_run, jobs)
                try:
                    with ctx.Pool(processes=nproc) as pool:
                        # imap streams results back as chunks finish, so
                        # the checkpoint log fills during the run, not
                        # only at pool teardown
                        for i, res in zip(
                            parallel_ix,
                            pool.imap(
                                _mp_run_job,
                                parallel_ix,
                                chunksize=max(
                                    1, len(parallel_ix) // (nproc * 8)
                                ),
                            ),
                        ):
                            _record(i, res)
                    ran = True
                    pool_processes = nproc
                except Exception as e:
                    log.warning(
                        "refine process pool failed (%s); serial", e
                    )
                finally:
                    _mp_state = None
        if not ran:
            for i in parallel_ix:
                _record(i, _run(jobs[i]))

    t_msa = time.time() - t0
    t0 = time.time()
    # splice in the original bubble order (stored results interleave at
    # their positions), identical to an uninterrupted sequential run
    for kind, payload in slots:
        res = payload if kind == "stored" else results[payload]
        if res is None:
            continue
        bubble, ng, path2start, path2end = res
        G, nn = replace_bubble(G, bubble, ng, path2start, path2end, nn)
    if ck is not None:
        ck.close()
    digests = [_subgraph_digest(r[1]) for r in results if r is not None]
    LAST_STATS.clear()
    LAST_STATS.update(
        bubbles=len(work),
        pairs=len(all_pairs),
        cells=sum((len(a) + 1) * (len(b) + 1) for a, b in all_pairs),
        route=route,
        method=method,
        compat=_msa._logadd_compat,
        pool_processes=pool_processes,
        chain_bubbles=sum(m is not None for m in mats_for),
        chain_shapes=chain.get("shapes", {}),
        chain_batches=chain.get("batches", 0),
        chain_dp_batches=chain.get("dp_batches", 0),
        chain_seconds=t_chain,
        pair_shapes=dict(Counter(bucket_key(a, b) for a, b in rem_pairs)),
        stage1=stage1,
        refined=len(digests),
        aligned_bubbles=sum(
            G.nodes[w[0].source].get("aligned") == 1
            and G.nodes[w[0].sink].get("aligned") == 1
            for w in work
        ),
        digests=digests,
        extract_seconds=t_extract,
        stage1_seconds=t_stage1,
        msa_seconds=t_msa,
        splice_seconds=time.time() - t0,
    )
    return G
