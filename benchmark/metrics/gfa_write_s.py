"""gfa_write_s (s a job; layer cli, core.io_fasta, core.io_gfa): the
gzip-9 GFA write, the program's span ``rem.write`` (around
``core.io_gfa.write_gfa``), over the window's jobs."""

from benchmark.stagespans import PROBES, STATS, __getattr__  # noqa: F401
from benchmark.stagespans import mean


def read(run):
    return mean(run, "rem.write")
