"""host_prefix_s (s a job; layer native defer prefix): the native host
prefix of the pairwise recursion, ``devloop.LAST_STATS
["host_prefix_seconds"]``, over the jobs that took the forest."""

from benchmark.readers import ROUTE_STATS, stat_mean

STATS = ROUTE_STATS


def read(run):
    return stat_mean(run, "devloop", "host_prefix_seconds", route="forest")
