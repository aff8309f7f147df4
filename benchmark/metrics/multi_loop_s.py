"""multi_loop_s (s a job; layer index.devloop_multi): the multi-genome
level loop, ``devloop_multi.LAST_STATS["loop_seconds"]``, over the jobs
that it took (its clock closes after its copies to the host)."""

from benchmark.readers import ROUTE_STATS, stat_mean

STATS = ROUTE_STATS


def read(run):
    return stat_mean(run, "devloop_multi", "loop_seconds", route="multi")
