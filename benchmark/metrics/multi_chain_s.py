"""multi_chain_s (s a job; layer index.devloop_multi): the
sum-of-pairs chain DP and the largest pick (``chain_dense_multi``), the
program's span ``multi.chain`` summed over the multi loop's levels, over
the window's jobs that took the loop."""

from benchmark.readers import ROUTE_STATS
from benchmark.stagespans import PROBES, __getattr__  # noqa: F401
from benchmark.stagespans import STATS as TRACE_STATS
from benchmark.stagespans import mean

STATS = ROUTE_STATS + TRACE_STATS


def read(run):
    return mean(run, "multi.chain", route="multi")
