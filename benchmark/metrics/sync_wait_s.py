"""sync_wait_s (s a job; layer device): the seconds the host spends in
the program's counted reads from the card (``devloop.HostReads``, the
frontier's fetches; ``trace.LAST_STATS["wait"]``): the host blocked
until the card is done, plus the copy, over the window's jobs."""

from benchmark.stagespans import PROBES, STATS, __getattr__  # noqa: F401
from benchmark.stagespans import mean


def read(run):
    return mean(run, "wait")
