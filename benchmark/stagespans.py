"""The program's own stage spans (``reveal_tpu_torch.core.trace``), as
the metric readers reach them.

A reader of the spans names the trace module in its ``STATS`` (the
harness clears and snapshots its ``LAST_STATS`` a job, under the key
``trace``) and takes from here:

- ``__getattr__``, which hands the harness the reader's ``SPANS`` when it
  asks for them, which it does in a traced run only, after the warm-up
  and before the window.  Asking switches the program's tracing on, and
  the answer is one never-called anchor a label of the program's spans,
  so that the labels join those the profiled job's trace is read with
  (``devtrace.read_events``) and its idle gaps are named by the
  program's stages;
- ``PROBES``, whose probe on ``cli.main`` switches tracing off after the
  profiled job.

On a program without the module (a parent that predates it) ``STATS``,
``SPANS`` and ``PROBES`` are empty and the readers return None.
"""

from __future__ import annotations

import importlib
import importlib.util

MODULE = "reveal_tpu_torch.core.trace"


def _have():
    try:
        return importlib.util.find_spec(MODULE) is not None
    except ImportError:  # no reveal_tpu_torch.core at all
        return False


HAVE = _have()
STATS = (MODULE,) if HAVE else ()


def anchor():
    """Never called: the program's labels are installed on it as spans."""


def spans():
    """Tracing on; one anchor a label of the program's spans."""
    if not HAVE:
        return ()
    trace = importlib.import_module(MODULE)
    trace.enable(True)
    return tuple((__name__, "anchor", label) for label in trace.LABELS)


def _off(_args, _kw, _notes):
    def after(_result):
        importlib.import_module(MODULE).enable(False)
    return after


PROBES = (("reveal_tpu_torch.cli", "main", _off),) if HAVE else ()


def __getattr__(name):
    if name == "SPANS":
        return spans()
    raise AttributeError(name)


def stat(job, key):
    """``trace.LAST_STATS[key]`` of one job, or None."""
    return job["stats"].get("trace", {}).get(key)


def mean(run, key, route=None):
    """The mean of ``trace.LAST_STATS[key]`` over the jobs (of the route
    ``route`` if given) that recorded tracing (a ``job`` id); 0 in a
    traced job that never entered the span.  None when no job was
    traced."""
    from benchmark.readers import mean as mean_

    return mean_([stat(j, key) or 0 for j in run.jobs
                  if stat(j, "job") is not None
                  and (route is None or j["route"] == route)])
