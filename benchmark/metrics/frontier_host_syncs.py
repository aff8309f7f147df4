"""frontier_host_syncs (count a job; layer align.rem frontier,
index.devfrontier): the per-level frontier's reads from the card to the
host, ``devfrontier.LAST_STATS["host_syncs"]`` (each one waits for the
card), over the window's jobs whose route is the frontier."""

from benchmark.readers import ROUTE_STATS, mean

STATS = ROUTE_STATS


def read(run):
    return mean([j["stats"].get("devfrontier", {}).get("host_syncs")
                 for j in run.jobs if j["route"].startswith("frontier")])
