"""multi_decline_s (s a job; layer index.devloop_multi): what the
multi-genome loop's attempt costs on an input it declines before the
per-level frontier starts: the root's native multiMUM count (the
program's span ``rem.multi_root``) and the loop up to its abort
(``rem.multi_loop``), over the window's traced jobs whose route is the
frontier.  None on a program without the span ``rem.multi_root``."""

from benchmark.readers import ROUTE_STATS, mean
from benchmark.stagespans import PROBES, __getattr__  # noqa: F401
from benchmark.stagespans import STATS as TRACE_STATS
from benchmark.stagespans import stat

STATS = ROUTE_STATS + TRACE_STATS


def read(run):
    jobs = [j for j in run.jobs if j["route"].startswith("frontier")
            and stat(j, "job") is not None]
    if not any(stat(j, "rem.multi_root") is not None for j in jobs):
        return None
    return mean([(stat(j, "rem.multi_root") or 0)
                 + (stat(j, "rem.multi_loop") or 0) for j in jobs])
