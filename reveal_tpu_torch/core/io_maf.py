"""MAF output: flatten a variation graph into multiple-alignment blocks.

Port of convert.graph2maf (reveal/convert.py:231-289): per
weakly-connected component, assign each node a graph offset (longest path
position), then emit one padded alignment row per path.
"""

from __future__ import annotations

from ..graph.pangraph import PanGraph


def graph2maf(G: PanGraph, filename: str) -> str:
    sizes = {sid: 0 for sid in G.graph["id2path"]}

    with open(filename, "w") as maf:
        for comp in G.weakly_connected_components():
            g = G.subgraph(comp)
            order = g.topological_sort()
            longest = 0
            sids = set()
            for node in order:
                if isinstance(node, str):
                    continue
                go = max(
                    [0]
                    + [
                        g.nodes[pred]["graphoffset"]
                        + len(g.nodes[pred]["seq"])
                        for pred in g.predecessors(node)
                        if not isinstance(pred, str)
                    ]
                )
                g.nodes[node]["graphoffset"] = go
                if go + len(g.nodes[node]["seq"]) > longest:
                    longest = go + len(g.nodes[node]["seq"])
                for k in g.nodes[node]["offsets"]:
                    sids.add(k)
                    end = g.nodes[node]["offsets"][k] + len(
                        g.nodes[node]["seq"]
                    )
                    if end > sizes[k]:
                        sizes[k] = end

            ml = max(len(p) for p in G.graph["paths"])
            maf.write("##maf version=1\n")
            maf.write("a\n")
            for sid in sorted(sids):
                path = G.graph["id2path"][sid]
                o = 0
                maf.write(
                    "s %s %d %d + %-10d "
                    % (path.ljust(ml), 0, sizes[sid], sizes[sid])
                )
                for node in order:
                    if isinstance(node, str):
                        continue
                    if sid in g.nodes[node]["offsets"]:
                        while o < g.nodes[node]["graphoffset"]:
                            maf.write("-")
                            o += 1
                        maf.write(g.nodes[node]["seq"])
                        o += len(g.nodes[node]["seq"])
                maf.write("-" * (longest - o))
                maf.write("\n")
            maf.write("\n")
    return filename
