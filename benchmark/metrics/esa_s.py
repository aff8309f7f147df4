"""esa_s (s a job; layer index.esa_index): seconds in the root's suffix
array and LCP build (``ESAIndex.construct``: native SA-IS and Kasai on
the host), from the benchmark's own span."""

from benchmark.readers import span_mean


def read(run):
    return span_mean(run, "esa")
