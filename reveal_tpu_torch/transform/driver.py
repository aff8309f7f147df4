"""Transform: layout draft assemblies against a finished reference.

Port of transform()/transform_cmd (reveal/transform.py:
204-560): index reference + query contigs (optional N-splitting and
min-length filter), extract MUMs in both orientations, cluster on
(anti)diagonals into synteny blocks, iterate glocal chaining along the
reference then the query axis to a fixpoint, resolve overlaps, optionally
hill-climb (leave-one-out), then emit a breakpoint-graph GFA holding the
reference layout of the query (with 1bp N gap nodes) plus the original
contig paths prefixed '*', and optionally a BED of breakpoint regions.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional

from ..core.encoding import rc_str, to_str
from ..core.io_fasta import fasta_reader
from ..core.textstore import TextStore
from ..index.esa_index import ESAIndex
from .blocks import (
    addctginfo,
    chainscore,
    clustermumsbydiagonal,
    extendblocks,
    glocalchain,
    merge_consecutive,
    mums_to_blocks,
    optimise,
    remove_overlap_conservative_blocks,
    remove_overlap_greedy_blocks,
)

log = logging.getLogger(__name__)


@dataclass
class TransformConfig:
    minlength: int = 65
    minctglength: int = 1000
    cutn: int = 1000
    cluster: bool = True
    maxdist: int = 90
    mincluster: int = 65
    rearrangecost: int = 1000
    inversioncost: int = 1
    _lambda: float = 5
    eps: float = 1
    alfa: float = 1
    gapopen: int = 10
    useheap: bool = False
    lastn: int = 50
    lastbp: int = 10000
    greedy: bool = False
    minchainsum: int = 65
    optimise: bool = True
    outputbed: bool = True
    backend: str = "auto"


def transform(reference: str, qry: str, cfg: TransformConfig, output: Optional[str] = None):
    """Returns (gfa_path, bed_path or None)."""
    if output is None:
        prefix = os.path.splitext(os.path.basename(qry))[0]
    else:
        prefix = output
        for ext in (".gfa.gz", ".gfa"):
            if prefix.endswith(ext):
                prefix = prefix[: -len(ext)]

    refnames: List[str] = []
    ctgnames: List[str] = []
    ts = TextStore()
    ctg2range = []
    for sample in (reference, qry):
        ts.add_sample(os.path.basename(sample))
        for name, seq in fasta_reader(sample, cutN=cfg.cutn):
            if len(seq) < cfg.minctglength:
                continue
            iv = ts.add_sequence(seq)
            ctg2range.append(iv)
            if sample == reference:
                refnames.append(name)
            else:
                ctgnames.append(name)

    idx = ESAIndex.construct(ts, backend=cfg.backend)
    T = idx.main.T
    mums = addctginfo(idx.getmums(cfg.minlength), ctg2range)
    log.info("%d forward mums", len(mums))

    if cfg.cluster:
        blocks = clustermumsbydiagonal(
            mums, maxdist=cfg.maxdist, minclustsize=cfg.mincluster, rcmums=False
        ) if mums else []
    else:
        blocks = mums_to_blocks(mums)

    idx_rc = ESAIndex.construct(ts, backend=cfg.backend, rc=True)
    rcmums = addctginfo(idx_rc.getmums(cfg.minlength), ctg2range)
    log.info("%d rc mums", len(rcmums))

    sep = int(idx.nsep[0])
    idxn = idx.main.nT
    rlength = sep
    qlength = idxn - sep

    if cfg.cluster and rcmums:
        rcblocks = clustermumsbydiagonal(
            rcmums, maxdist=cfg.maxdist, minclustsize=cfg.mincluster, rcmums=True
        )
    else:
        rcblocks = mums_to_blocks(rcmums)
    blocks += rcblocks

    kw = dict(
        rearrangecost=cfg.rearrangecost,
        inversioncost=cfg.inversioncost,
        _lambda=cfg._lambda,
        eps=cfg.eps,
        alfa=cfg.alfa,
        gapopen=cfg.gapopen,
    )

    syntenyblocks = blocks
    for axis in (0, 1):
        nbefore, nafter = len(syntenyblocks), None
        while nbefore != nafter:
            nbefore = len(syntenyblocks)
            syntenyblocks = glocalchain(
                syntenyblocks,
                rlength,
                qlength,
                ctg2range,
                useheap=cfg.useheap,
                lastn=cfg.lastn,
                lastbp=cfg.lastbp,
                axis=axis,
                **kw,
            )
            nafter = len(syntenyblocks)
        log.info("%d anchors after glocal chaining (axis %d)", nafter, axis)

    syntenyblocks = merge_consecutive(syntenyblocks)
    if cfg.greedy:
        syntenyblocks = remove_overlap_greedy_blocks(syntenyblocks)
    else:
        syntenyblocks = remove_overlap_conservative_blocks(syntenyblocks)
    syntenyblocks = [b for b in syntenyblocks if b[5] >= cfg.minchainsum]
    syntenyblocks = merge_consecutive(syntenyblocks)

    if cfg.optimise and len(syntenyblocks) > 1:
        w, c, e = chainscore(syntenyblocks, rlength, qlength, ctg2range, **kw)
        score = w - c
        while True:
            tblocks, tw, tc, te = optimise(
                syntenyblocks, rlength, qlength, ctg2range, **kw
            )
            if tw - tc <= score:
                break
            score = tw - tc
            syntenyblocks = merge_consecutive(tblocks)

    syntenyblocks = merge_consecutive(syntenyblocks)
    w, c, edgecosts = chainscore(
        syntenyblocks, rlength, qlength, ctg2range, **kw
    )

    bedfile = None
    if cfg.outputbed and syntenyblocks:
        bedfile = prefix + ".bed"
        _write_bed(
            bedfile, syntenyblocks, edgecosts, ctg2range, refnames, ctgnames
        )

    extendblocks(syntenyblocks, ctg2range)

    mappablectgs = set()
    for b in syntenyblocks:
        mappablectgs.add(b[7])
        mappablectgs.add(b[6])
    if not mappablectgs:
        log.info("No mappable contigs.")
        return None, bedfile

    gfa = write_breakpointgraph(
        syntenyblocks, T, refnames, ctgnames, mappablectgs, prefix
    )
    return gfa, bedfile


def _write_bed(bedfile, syntenyblocks, edgecosts, ctg2range, refnames, ctgnames):
    """transform.py:437-523."""
    block2ctgidx = {}
    ctgid2lastblock = {}
    pctgid = None
    ci = 0
    syntenyblocks.sort(key=lambda b: b[2])
    for block in syntenyblocks:
        ctgid = block[7]
        if ctgid != pctgid:
            if pctgid is not None:
                ctgid2lastblock[pctgid] = ci
            ci = 0
        else:
            ci += 1
        block2ctgidx[block] = ci
        pctgid = ctgid
    ctgid2lastblock[pctgid] = ci

    syntenyblocks.sort(key=lambda b: b[0])
    with open(bedfile, "w") as bedout:
        bedout.write(
            "#reference\trefbegin\trefend\tcontig:segmentidx:lastsegmentidx:"
            "begin:end\tscore:cost\torientation\taln-start\taln-end\n"
        )
        pblock = None
        for i, block in enumerate(syntenyblocks):
            s1, e1, s2, e2, o, score, refid, ctgid = block
            if i == 0:
                pblock = None
            cost = edgecosts[i]
            # note: '- 2' (not '- 1') reproduces the reference's bound
            # (transform.py:477), which leaves the second-to-last block's
            # end unextended
            nblock = (
                syntenyblocks[i + 1] if i < len(syntenyblocks) - 2 else None
            )
            ctgoffsets = ctg2range[ctgid]
            refoffsets = ctg2range[refid]
            if pblock is not None and pblock[6] == refid:
                start = (s1 - refoffsets[0]) - ((s1 - pblock[1]) // 2)
            else:
                start = s1 - refoffsets[0]
            if nblock is not None and nblock[6] == refid:
                end = (e1 - refoffsets[0]) + ((nblock[0] - e1) // 2)
            else:
                end = e1 - refoffsets[0]
            qstart = s2 - ctgoffsets[0]
            qend = e2 - ctgoffsets[0]
            chromname = refnames[refid].split()[0]
            qi = block2ctgidx[block]
            bedout.write(
                "%s\t%d\t%d\t%s:%d:%d:%d:%d\t%d:%d\t%s\t%d\t%d\n"
                % (
                    chromname,
                    start,
                    end,
                    ctgnames[ctgid - len(refnames)].split()[0],
                    qi,
                    ctgid2lastblock[ctgid],
                    qstart,
                    qend,
                    score,
                    cost,
                    "+" if o == 0 else "-",
                    s1 - refoffsets[0],
                    e1 - refoffsets[0],
                )
            )
            pblock = block


def write_breakpointgraph(
    syntenyblocks, T, refnames, ctgnames, mappablectgs, outputprefix
):
    """transform.py:603-711, emitted directly as GFA: the reference layout
    of the query per reference contig (with 1bp N gap nodes between
    blocks), plus the original contig paths prefixed '*'."""
    import gzip

    out = (
        outputprefix
        if outputprefix.endswith(".gfa") or outputprefix.endswith(".gfa.gz")
        else outputprefix + ".gfa.gz"
    )
    opener = gzip.open if out.endswith(".gz") else open

    # path registry
    ref_paths = {}
    ctg_paths = {}
    pid = 0
    for name in refnames:
        if pid in mappablectgs:
            ref_paths[pid] = os.path.basename(outputprefix + "_" + name)
        else:
            log.info("No contigs were mapped to: %s", name)
        pid += 1
    for name in ctgnames:
        if pid in mappablectgs:
            ctg_paths[pid] = "*" + name
        else:
            log.info("Contig %s could not be placed on the reference", name)
        pid += 1

    # node table: one node per block (ref order), gap nodes between
    syntenyblocks.sort(key=lambda b: b[0])
    nid = 0
    nodes = []  # (nid, seq)
    mapping = {}
    ref_walk = {}  # refid -> [(nid, orient)]
    prefid = None
    gap_after = {}
    for i, block in enumerate(syntenyblocks):
        s1, e1, s2, e2, o, score, refid, ctgid = block
        mapping[(s2, e2)] = nid
        seq = to_str(T[s2:e2]).upper()
        if o != 0:
            seq = rc_str(seq)
        nodes.append((nid, seq))
        ref_walk.setdefault(refid, []).append(nid)
        prefid = refid
        nid += 1
        if i != len(syntenyblocks) - 1:
            nodes.append((nid, "N"))
            ref_walk[refid].append(nid)
            nid += 1

    # original layout walks
    syntenyblocks.sort(key=lambda b: b[2])
    ctg_walk = {}  # ctgid -> [(nid, orient)]
    for block in syntenyblocks:
        s1, e1, s2, e2, o, score, refid, ctgid = block
        ctg_walk.setdefault(ctgid, []).append(
            (mapping[(s2, e2)], "+" if o == 0 else "-")
        )

    with opener(out, "wt") as f:
        f.write("H\tVN:Z:1.0\tCL:Z:reveal_tpu transform\n")
        for nid_, seq in nodes:
            f.write("S\t%d\t%s\n" % (nid_ + 1, seq))
        links = set()
        for refid, walk in ref_walk.items():
            for a, b in zip(walk, walk[1:]):
                links.add((a + 1, "+", b + 1, "+"))
        for ctgid, walk in ctg_walk.items():
            for (a, ao), (b, bo) in zip(walk, walk[1:]):
                links.add((a + 1, ao, b + 1, bo))
        for a, ao, b, bo in sorted(links):
            f.write("L\t%d\t%s\t%d\t%s\t0M\n" % (a, ao, b, bo))
        for refid, name in ref_paths.items():
            walk = ref_walk.get(refid, [])
            f.write(
                "P\t%s\t%s\t%s\n"
                % (
                    name,
                    ",".join("%d+" % (n + 1) for n in walk),
                    ",".join(["0M"] * len(walk)),
                )
            )
        for ctgid, name in ctg_paths.items():
            walk = ctg_walk.get(ctgid, [])
            f.write(
                "P\t%s\t%s\t%s\n"
                % (
                    name,
                    ",".join("%d%s" % (n + 1, o) for n, o in walk),
                    ",".join(["0M"] * len(walk)),
                )
            )
    log.info("Breakpoint graph written to: %s", out)
    return out
