"""Dotplots: mumplot between two fastas, graph-based plot, bed plot.

Port of reveal/plot.py and utils.plotgraph
(utils.py:207-302): forward matches in red, reverse-complement matches in
green, contig boundaries as thin lines, N-runs as shaded rectangles.
"""

from __future__ import annotations

import logging

from .core.io_fasta import fasta_reader

log = logging.getLogger(__name__)


def _gap_runs(seq):
    gaps = []
    sizes = []
    pc = None
    gapsize = 0
    for i, c in enumerate(seq):
        if c == "N" and pc != "N":
            gaps.append(i)
            gapsize = 1
        elif c == "N" and pc == "N":
            gapsize += 1
        elif c != "N" and pc == "N":
            sizes.append(gapsize)
        pc = c
    if pc == "N":
        sizes.append(gapsize)
    return gaps, sizes


def mumplot(
    fastas,
    minlength: int = 20,
    rc: bool = True,
    maxmums: int = 10000,
    interactive: bool = False,
    output: str = None,
    endpoints: bool = False,
    showgaps: bool = False,
    backend: str = "auto",
    xregion: str = None,
    yregion: str = None,
    flanksize: str = None,
    extension: str = "png",
):
    """plot.py:67-304 for two fasta inputs; xregion/yregion zoom with
    optional flanks saves one image per region pair (plot.py:246-304)."""
    import matplotlib

    if not interactive:
        matplotlib.use("Agg")
    from matplotlib import patches, pyplot as plt

    from .core.textstore import TextStore
    from .index.esa_index import ESAIndex

    if len(fastas) != 2:
        raise ValueError("mumplot needs exactly 2 fasta files")

    ts = TextStore()
    horzgaps, horzgapsizes = [], []
    vertgaps, vertgapsizes = [], []
    refoffsets, ctgoffsets = [], []

    ts.add_sample(fastas[0])
    refoffset = 0
    for name, seq in fasta_reader(fastas[0]):
        g, s = _gap_runs(seq)
        horzgaps += [refoffset + x for x in g]
        horzgapsizes += s
        refoffset += len(seq) + 1
        refoffsets.append(refoffset)
        ts.add_sequence(seq.upper())

    ts.add_sample(fastas[1])
    qryoffset = 0
    for name, seq in fasta_reader(fastas[1]):
        g, s = _gap_runs(seq)
        vertgaps += [qryoffset + x for x in g]
        vertgapsizes += s
        qryoffset += len(seq) + 1
        ctgoffsets.append(qryoffset)
        ts.add_sequence(seq.upper())

    idx = ESAIndex.construct(ts, backend=backend)
    sep = int(idx.nsep[0])
    mmems = idx.getmums(minlength)
    if rc:
        idx2 = ESAIndex.construct(ts, backend=backend, rc=True)
        mmems += idx2.getmums(minlength)

    if len(mmems) > maxmums:
        mmems.sort(key=lambda m: m[0], reverse=True)
        mmems = mmems[:maxmums]

    ax = plt.axes()
    xlist, ylist, rcxlist, rcylist = [], [], [], []
    for l, (sp1, sp2), isrc in mmems:
        sp2 = sp2 - (sep + 1)
        ep1, ep2 = sp1 + l, sp2 + l
        if isrc == 0:
            xlist += [sp1, ep1, None]
            ylist += [sp2, ep2, None]
        else:
            rcxlist += [ep1, sp1, None]
            rcylist += [sp2, ep2, None]

    plt.plot(xlist, ylist, "r-")
    plt.plot(rcxlist, rcylist, "g-")
    if endpoints:
        plt.plot(xlist, ylist, "b*")
        plt.plot(rcxlist, rcylist, "y*")
    for p in ctgoffsets:
        plt.axhline(y=p, linewidth=0.5, color="black", linestyle="solid")
    for p in refoffsets:
        plt.axvline(x=p, linewidth=0.5, color="black", linestyle="solid")
    if showgaps:
        qrylength = qryoffset
        reflength = refoffset
        for p, l in zip(horzgaps, horzgapsizes):
            ax.add_patch(patches.Rectangle((p, 0), l, qrylength, alpha=0.1))
        for p, l in zip(vertgaps, vertgapsizes):
            ax.add_patch(patches.Rectangle((0, p), reflength, l, alpha=0.1))
    plt.xlabel(fastas[0])
    plt.ylabel(fastas[1])
    plt.title("reveal-tpu mumplot")

    def _parse_regions(spec):
        out = []
        for region in spec.split(","):
            if region.count("-") == 1:
                rstart, rend = region.split("-")
            elif region.count(":") == 1:
                rstart, rend = region.split(":")
            else:
                raise ValueError(
                    "invalid region %r, use <start>-<end>" % region
                )
            out.append((int(rstart), int(rend)))
        return out

    xregions = yregions = None
    if xregion:
        xregions = _parse_regions(xregion)
        for rs, re_ in xregions:
            plt.axvline(x=rs, linewidth=1, color="b", linestyle="dashed")
            plt.axvline(x=re_, linewidth=1, color="b", linestyle="dashed")
    if yregion:
        yregions = _parse_regions(yregion)
        for rs, re_ in yregions:
            plt.axhline(y=rs, linewidth=1, color="b", linestyle="dashed")
            plt.axhline(y=re_, linewidth=1, color="b", linestyle="dashed")

    if interactive:
        plt.show()
        return None
    if xregions and yregions:
        # one zoomed image per region pair (plot.py:291-302)
        if len(xregions) != len(yregions):
            raise ValueError("xregion/yregion counts differ")
        flanks = (
            [int(v) for v in flanksize.split(",")]
            if flanksize
            else [0] * len(xregions)
        )
        b1 = fastas[0].split("/")[-1].rsplit(".", 1)[0]
        b2 = fastas[1].split("/")[-1].rsplit(".", 1)[0]
        outs = []
        for (xs, xe), (ys, ye), fl in zip(xregions, yregions, flanks):
            plt.xlim(xs - fl, xe + fl)
            plt.ylim(ys - fl, ye + fl)
            fn = "%s_%d-%d_%s_%d-%d.%s" % (
                b1, xs, xe, b2, ys, ye, extension,
            )
            plt.savefig(fn)
            outs.append(fn)
        plt.close()
        return outs[-1] if outs else None
    out = output or "%s_%s.%s" % (
        fastas[0].split("/")[-1],
        fastas[1].split("/")[-1],
        extension,
    )
    plt.savefig(out)
    plt.close()
    return out


def plotgraph(G, s1, s2, interactive=False, region=None, minlength=1, output=None):
    """utils.plotgraph (utils.py:207-302): dotplot of shared graph nodes."""
    import matplotlib

    if not interactive:
        matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    sid1 = G.graph["path2id"][s1]
    sid2 = G.graph["path2id"][s2]
    xlist, ylist = [], []
    maxx = maxy = 0
    for node, data in G.nodes.items():
        if isinstance(node, str):
            continue
        if "seq" in data:
            l = len(data["seq"])
        elif isinstance(node, tuple):
            l = node[1] - node[0]
        else:
            continue
        if l < minlength:
            continue
        if sid1 in data["offsets"] and sid2 in data["offsets"]:
            x, y = data["offsets"][sid1], data["offsets"][sid2]
            xlist += [x, x + l, None]
            ylist += [y, y + l, None]
            maxx = max(maxx, x + l)
            maxy = max(maxy, y + l)
    plt.plot(xlist, ylist, "r-")
    plt.plot(0, 0, "bx")
    plt.plot(maxx, maxy, "bx")
    plt.xlabel(s1)
    plt.ylabel(s2)
    if region:
        rstart, rend = region.split(":")
        plt.axvline(x=int(rstart), linewidth=3, color="b", linestyle="dashed")
        plt.axvline(x=int(rend), linewidth=3, color="b", linestyle="dashed")
    if interactive:
        plt.show()
    else:
        out = output or "%s_%s.png" % (s1, s2)
        plt.savefig(out)
        plt.close()
        return out


def bedplot(bedfile, output=None, interactive=False):
    """Dotplot of a transform BED's alignment segments
    (plot.bedplot, plot.py:25-66 — broken in the reference; this is the
    working equivalent over the same 8-column BED)."""
    import matplotlib

    if not interactive:
        matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    xpoints, ypoints = [], []
    rcx, rcy = [], []
    with open(bedfile) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            cols = line.rstrip().split("\t")
            if len(cols) < 8:
                continue
            contig = cols[3]
            orientation = cols[5]
            alnstart, alnend = int(cols[6]), int(cols[7])
            parts = contig.split(":")
            ctgbegin, ctgend = int(parts[-2]), int(parts[-1])
            if orientation == "-":
                rcx += [alnstart, alnend, None]
                rcy += [ctgend, ctgbegin, None]
            else:
                xpoints += [alnstart, alnend, None]
                ypoints += [ctgbegin, ctgend, None]
    plt.plot(xpoints, ypoints, "r-")
    plt.plot(rcx, rcy, "g-")
    plt.xlabel("reference (aligned position)")
    plt.ylabel("contig")
    plt.title("reveal-tpu bedplot")
    if interactive:
        plt.show()
        return None
    out = output or (bedfile + ".png")
    plt.savefig(out)
    plt.close()
    return out
