"""Stage spans of the port's commands, and the host's waits at its reads
from the card.

A span names one stage of a command (``rem.esa``, ``multi.chain``, ...)
at its call site::

    with trace.span("multi.chain"):
        ...

Tracing is off unless ``enable(True)`` turns it on (the CLI's ``--profile
DIR`` does, for the command it traces).  Off, ``span`` hands back one
shared no-op: a global read, no clock, no allocation.  On, a span adds to
the command's record ``LAST_STATS``, under its label, the host seconds it
was open, its self seconds (less what the spans opened inside it cover),
its calls, and the counted reads made while it was the innermost open
span with their seconds (``read``: the host blocked until the card is
done, plus the copy).  While a ``torch.profiler`` runs, a span also opens
a ``record_function`` range of its label, so that the profiler's trace
shows the stages on its own clock beside the kernels.

``cli.main`` starts a record at the start of every command (``begin``),
so the spans of one command share one ``job`` id.  Spans belong to the
command's own thread.
"""

from __future__ import annotations

import time

# every label a span of the port carries: the rem job's stages, a level
# of the pairwise forest or single-root loop, a level of the multi-genome
# loop, a level of the per-level frontier
LABELS = (
    "rem.read", "rem.esa", "rem.host_prefix", "rem.forest",
    "rem.single_root", "rem.multi_loop", "rem.frontier", "rem.replay",
    "rem.finish", "rem.write",
    "level.enumerate", "level.trim", "level.chain", "level.split",
    "level.repair",
    "multi.enumerate", "multi.trim", "multi.chain", "multi.split",
    "multi.repair",
    "frontier.enumerate", "frontier.pick", "frontier.apply",
    "frontier.repair",
)

# the last command's record while tracing is on (empty while it is off):
# "job" (the command's id), "reads" and "wait" (its counted reads and
# their seconds), and per label entered: "<label>" (seconds),
# "<label>.self", "<label>.calls", "<label>.reads", "<label>.wait"
LAST_STATS = {}

ON = False
_JOB = 0
# the open spans, innermost last
_OPEN = []


class _Off:
    """The span of tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _profiling():
    import torch

    return torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("label", "stats", "key", "traced", "inner", "rf", "t0")

    def __init__(self, label, stats, key):
        self.label = label
        self.stats = stats
        self.key = key

    def __enter__(self):
        self.traced = ON
        self.inner = 0.0
        self.rf = None
        if self.traced:
            if _profiling():
                from torch.profiler import record_function

                self.rf = record_function(self.label)
                self.rf.__enter__()
            _OPEN.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.stats is not None:
            self.stats[self.key] = self.stats.get(self.key, 0.0) + dt
        if self.traced:
            if _OPEN and _OPEN[-1] is self:
                _OPEN.pop()
            if _OPEN:
                _OPEN[-1].inner += dt
            rec, label = LAST_STATS, self.label
            rec[label] = rec.get(label, 0.0) + dt
            rec[label + ".self"] = (rec.get(label + ".self", 0.0) + dt
                                    - self.inner)
            rec[label + ".calls"] = rec.get(label + ".calls", 0) + 1
            rec.setdefault(label + ".reads", 0)
            rec.setdefault(label + ".wait", 0.0)
            if self.rf is not None:
                self.rf.__exit__(*exc)
        return False


def span(label, stats=None, key=None):
    """A context manager around one stage labelled ``label`` (one of
    ``LABELS``).  With ``stats``, a dict, the stage's seconds are also
    added to ``stats[key]``, with tracing on or off."""
    if stats is None and not ON:
        return _OFF
    return _Span(label, stats, key)


def read(fn, *args, **kw):
    """``fn(*args, **kw)``, a call that returns once the card is done (a
    copy to the host).  With tracing on, its seconds are a wait of the
    command and of the innermost open span."""
    if not ON:
        return fn(*args, **kw)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    wait = time.perf_counter() - t0
    rec = LAST_STATS
    rec["reads"] = rec.get("reads", 0) + 1
    rec["wait"] = rec.get("wait", 0.0) + wait
    if _OPEN:
        label = _OPEN[-1].label
        rec[label + ".reads"] = rec.get(label + ".reads", 0) + 1
        rec[label + ".wait"] = rec.get(label + ".wait", 0.0) + wait
    return out


def enable(on=True):
    """Switch tracing on or off; returns whether it was on."""
    global ON
    was, ON = ON, bool(on)
    return was


def begin():
    """Start a command's record: ``LAST_STATS`` cleared and, with tracing
    on, under a new ``job`` id."""
    global _JOB
    _JOB += 1
    LAST_STATS.clear()
    del _OPEN[:]
    if ON:
        LAST_STATS.update(job=_JOB, reads=0, wait=0.0)
