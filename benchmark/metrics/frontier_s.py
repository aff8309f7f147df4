"""frontier_s (s a job; layer align.rem frontier, index.devfrontier): the
per-level frontier, ``devfrontier.LAST_STATS["seconds"]`` (its levels and
the replay of its graph in the serial order), over the window's jobs
whose route is the frontier."""

from benchmark.readers import ROUTE_STATS, mean

STATS = ROUTE_STATS


def read(run):
    return mean([j["stats"].get("devfrontier", {}).get("seconds")
                 for j in run.jobs if j["route"].startswith("frontier")])
