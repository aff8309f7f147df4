"""io_s (s a job; layer cli, core.io_fasta, core.io_gfa): seconds in the
fasta read (``align.rem._read_inputs``) and the GFA write
(``core.io_gfa.write_gfa``), from the benchmark's own spans."""

from benchmark.readers import span_mean


def read(run):
    return span_mean(run, "io")
