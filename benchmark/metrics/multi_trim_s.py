"""multi_trim_s (s a job; layer index.devloop_multi): the subset pick,
the ``trim_dim_multi`` passes, the same-path filter and the read of the
segments' candidate counts, the program's span ``multi.trim`` summed over
the multi loop's levels, over the window's jobs that took the loop."""

from benchmark.readers import ROUTE_STATS
from benchmark.stagespans import PROBES, __getattr__  # noqa: F401
from benchmark.stagespans import STATS as TRACE_STATS
from benchmark.stagespans import mean

STATS = ROUTE_STATS + TRACE_STATS


def read(run):
    return mean(run, "multi.trim", route="multi")
