"""The jobs a traffic mix can run, one module a CLI command: its
``argv``, the suffix of its ``OUTPUT`` file and its plain ``reference``.
A traffic file names its command (``"command": "rem"``)."""

from __future__ import annotations

import importlib


def load(name):
    return importlib.import_module("benchmark.commands." + name)


def reference_job(command, fastas, out, options):
    """The reference's output of one job, in a process of its own (a
    module-level function, so that a spawned pool can call it)."""
    return load(command).reference(fastas, out, options)
