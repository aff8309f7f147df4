"""The comparison that decides ``correct``: each job's output against the
plain reference's on the same input, byte for byte.

A job's output is read back as text (a gzipped file decompressed: gzip's
header carries a time).  Two numbers are compared, both with the limit 0
(the graph is exact): ``jobs_wrong``, the jobs whose output differs from
the reference's, and ``lines_off``, the most lines by which one job's
output differs from it (lines in one and not the other, counted with
their multiplicity).
"""

from __future__ import annotations

import gzip
from collections import Counter

LIMITS = {"jobs_wrong": 0, "lines_off": 0}


def text_of(data):
    """A job's output file as text bytes (None stays None)."""
    if data is None:
        return None
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


def lines_off(got: bytes, want: bytes) -> int:
    if got == want:
        return 0
    a = Counter(got.split(b"\n"))
    b = Counter(want.split(b"\n"))
    return sum(((a - b) + (b - a)).values())


def judge(outputs):
    """{name: (value, limit)} of every number compared, over ``outputs``:
    (text, jobs that wrote it, the reference's text on their input); a
    job that wrote nothing (text None) counts as wrong."""
    wrong = worst = 0
    for got, jobs, want in outputs:
        off = lines_off(got, want) if got is not None else (
            want.count(b"\n") + 1)
        wrong += jobs * (off > 0)
        worst = max(worst, off)
    return {"jobs_wrong": (wrong, LIMITS["jobs_wrong"]),
            "lines_off": (worst, LIMITS["lines_off"])}


def passes(checks) -> bool:
    return all(value <= limit for value, limit in checks.values())
