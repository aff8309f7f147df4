"""fasta_read_s (s a job; layer cli, core.io_fasta, core.io_gfa): the
fasta read, the program's span ``rem.read`` (around
``align.rem._read_inputs``), over the window's jobs."""

from benchmark.stagespans import PROBES, STATS, __getattr__  # noqa: F401
from benchmark.stagespans import mean


def read(run):
    return mean(run, "rem.read")
