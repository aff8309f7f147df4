"""gfa_deflate_s (s a job; layer cli, core.io_fasta, core.io_gfa): the GFA
write's wait for its deflate after the last line, and the end of the
file, the program's span ``gfa.deflate`` (around the close of
``core.gzwrite.GzipTextWriter``, inside ``rem.write``), over the window's
jobs.  A program whose spans have no such label reads nothing."""

import importlib

from benchmark.stagespans import PROBES, STATS, __getattr__  # noqa: F401
from benchmark.stagespans import HAVE, MODULE, mean

LABEL = "gfa.deflate"


def read(run):
    if not HAVE or LABEL not in importlib.import_module(MODULE).LABELS:
        return None
    return mean(run, LABEL)
