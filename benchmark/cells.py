"""Find a cell's configuration, traffic mix and metrics by name.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py``, found through the
cell's entry in ``BENCHMARK.json`` at the root of the checkout.  A new
cell, configuration or metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and
    the metrics it reports."""

    def __init__(self, name, root, here=HERE):
        self.root = root
        self.here = here
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError("no workload %r in BENCHMARK.json (have: %s)"
                           % (name, ", ".join(sorted(entries))))
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(
            root, configs[self.entry["config"]]["file"]))
        self.traffic = load_json(os.path.join(
            here, "traffic", self.entry["traffic"] + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]

    def metrics(self, trace):
        return self.per_layer if trace else self.end_to_end


def load_reader(name, here=HERE):
    """The module ``metrics/<name>.py``: ``read(run)`` gives the metric's
    value or None, and optional ``SPANS`` / ``PROBES`` say what it needs
    recorded."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
