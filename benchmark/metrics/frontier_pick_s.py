"""frontier_pick_s (s a job; layer align.rem frontier, index.devfrontier):
the host's pick and graph surgery (``graphalign``) of every segment of a
level, the program's span ``frontier.pick`` summed over the frontier's
levels, over the window's traced jobs whose route is the frontier."""

from benchmark.readers import ROUTE_STATS, mean
from benchmark.stagespans import PROBES, __getattr__  # noqa: F401
from benchmark.stagespans import STATS as TRACE_STATS
from benchmark.stagespans import stat

STATS = ROUTE_STATS + TRACE_STATS


def read(run):
    return mean([stat(j, "frontier.pick") or 0 for j in run.jobs
                 if j["route"].startswith("frontier")
                 and stat(j, "job") is not None])
