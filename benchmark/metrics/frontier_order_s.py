"""frontier_order_s (s a job; layer align.rem frontier, index.devfrontier):
putting the frontier's graph into the serial engine's order (its
snapshot before the levels and the replay of every step's surgery in
the serial pop order after them), the program's span ``frontier.order``,
over the window's traced jobs whose route is the frontier.  None on a
program without the span."""

from benchmark.readers import ROUTE_STATS, mean
from benchmark.stagespans import PROBES, __getattr__  # noqa: F401
from benchmark.stagespans import STATS as TRACE_STATS
from benchmark.stagespans import stat

STATS = ROUTE_STATS + TRACE_STATS


def read(run):
    jobs = [j for j in run.jobs if j["route"].startswith("frontier")
            and stat(j, "job") is not None]
    if not any(stat(j, "frontier.order") is not None for j in jobs):
        return None
    return mean([stat(j, "frontier.order") or 0 for j in jobs])
