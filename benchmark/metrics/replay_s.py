"""replay_s (s a job; layer align.rem replay): the graph surgery that
replays a device loop's anchors in serial pop order, the program's span
``rem.replay`` (around ``_rem2_replay`` / ``_rem_multi_replay``), over the
window's jobs."""

from benchmark.stagespans import PROBES, STATS, __getattr__  # noqa: F401
from benchmark.stagespans import mean


def read(run):
    return mean(run, "rem.replay")
