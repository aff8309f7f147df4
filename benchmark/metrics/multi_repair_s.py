"""multi_repair_s (s a job; layer index.devloop_multi): the D repair
passes of a level (batched rounds, one ``window_resolve`` launch a
round), the program's span ``multi.repair`` summed over the multi loop's
levels, over the window's jobs that took the loop."""

from benchmark.readers import ROUTE_STATS
from benchmark.stagespans import PROBES, __getattr__  # noqa: F401
from benchmark.stagespans import STATS as TRACE_STATS
from benchmark.stagespans import mean

STATS = ROUTE_STATS + TRACE_STATS


def read(run):
    return mean(run, "multi.repair", route="multi")
