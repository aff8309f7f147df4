"""The benchmark's own spans around the program's calls into each layer.

A span is a wrapper put on a function of the program for the length of a
traced run: it adds the call's seconds to the current job's total under
the span's label and, while a job is profiled, opens a
``torch.profiler.record_function`` range of that label, so that the
profiler's trace can say what the host was doing while the card sat idle.
Nothing in the program changes: every wrapper is taken off again.
"""

from __future__ import annotations

import contextlib
import importlib
import time

# (module, attribute, label): the layers' entry points, from the outside in.
# An attribute "Class.method" wraps a method (a classmethod stays one).
SPANS = (
    ("reveal_tpu_torch.align.rem", "_read_inputs", "io"),
    ("reveal_tpu_torch.core.io_gfa", "write_gfa", "io"),
    ("reveal_tpu_torch.index.esa_index", "ESAIndex.construct", "esa"),
    ("reveal_tpu_torch.native", "rem2_defer_native", "host_prefix"),
    ("reveal_tpu_torch.index.devloop", "rem_device_forest", "forest"),
    ("reveal_tpu_torch.index.devloop", "rem_device_loop", "single_root"),
    ("reveal_tpu_torch.index.devloop_multi", "rem_device_multi",
     "multi_loop"),
    ("reveal_tpu_torch.align.rem", "_align_loop_frontier", "frontier"),
    ("reveal_tpu_torch.index.devfrontier",
     "DeviceFrontier.enumerate_pairwise", "frontier_enumerate"),
    ("reveal_tpu_torch.index.devfrontier", "DeviceFrontier.enumerate_multi",
     "frontier_enumerate"),
    ("reveal_tpu_torch.index.devfrontier", "DeviceFrontier.apply_level",
     "frontier_apply"),
    ("reveal_tpu_torch.index.devfrontier", "DeviceFrontier.repair_children",
     "frontier_repair"),
    ("reveal_tpu_torch.align.rem", "_rem2_replay", "replay"),
    ("reveal_tpu_torch.align.rem", "_rem_multi_replay", "replay"),
)


def _owner(module, attr):
    """(object holding the attribute, its name) for "name" or
    "Class.name"."""
    obj = importlib.import_module(module)
    *path, name = attr.split(".")
    for part in path:
        obj = getattr(obj, part)
    return obj, name


class Spans:
    """Seconds a label for the current job; ``profiling`` turns on the
    profiler ranges."""

    def __init__(self):
        self.current = {}
        self.profiling = False
        self.labels = set()
        self._undo = []

    def _wrap(self, fn, label):
        spans = self

        def call(*args, **kw):
            ctx = contextlib.nullcontext()
            if spans.profiling:
                from torch.profiler import record_function

                ctx = record_function(label)
            t0 = time.perf_counter()
            try:
                with ctx:
                    return fn(*args, **kw)
            finally:
                spans.current[label] = (spans.current.get(label, 0.0)
                                        + time.perf_counter() - t0)
        call.__wrapped__ = fn
        return call

    def install(self, table=SPANS):
        for module, attr, label in table:
            owner, name = _owner(module, attr)
            raw = owner.__dict__[name] if isinstance(owner, type) else (
                getattr(owner, name))
            if isinstance(raw, classmethod):
                new = classmethod(self._wrap(raw.__func__, label))
            else:
                new = self._wrap(raw, label)
            setattr(owner, name, new)
            self._undo.append((owner, name, raw))
            self.labels.add(label)

    def remove(self):
        while self._undo:
            owner, name, raw = self._undo.pop()
            setattr(owner, name, raw)

    def take(self):
        """The finished job's seconds a label; starts the next job."""
        out, self.current = self.current, {}
        return out
