"""Anchor-decision log: checkpoint/resume for the rem recursion.

The reference has no partial-alignment checkpoint (SURVEY §5.3/§5.4 —
its only resume story is per-stage GFA files on disk and the SA cache,
interface.c:182-285).  Long multi-genome runs on preemptible TPU hosts
need one, and the deterministic LIFO worklist (threads=0 semantics,
reveal.c:21-27) makes an unusually cheap design correct:

* the pop order of segments is a pure function of the inputs and the
  anchor picks, so the full alignment state is reproducible from the
  *sequence of picker decisions* alone;
* during a run, every decision — the picked split multiMUM plus the
  seeded skipleft/skipright chain remainders (schemes.py:319-331), or a
  stop — is appended to a JSON-lines log (tiny: anchors, not arrays);
* on resume, the driver replays the logged picks in order, skipping MUM
  enumeration and the chaining/pick DP entirely (graph surgery and the
  3-way SA split re-run, which is what rebuilds the in-memory state),
  then switches to live picking where the log ends.

A header line pins the text (sha1) and the picker configuration so a
log can never silently replay against different inputs.  A torn final
line from a crash mid-append is detected and discarded.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from dataclasses import asdict

log = logging.getLogger(__name__)

_FORMAT_VERSION = 1


def _encode_mum(mum):
    l, n, spd = mum
    return [int(l), int(n), [[int(g), int(p)] for g, p in spd]]


def _decode_mum(rec):
    l, n, spd = rec
    return (l, n, tuple((g, p) for g, p in spd))


def _encode_pick(pick):
    if not pick:
        return {"s": 0}
    splitmum, skipleft, skipright = pick
    return {
        "m": _encode_mum(splitmum),
        "L": [[_encode_mum(m), float(s)] for m, s in skipleft],
        "R": [[_encode_mum(m), float(s)] for m, s in skipright],
    }


def _decode_pick(rec):
    if rec.get("s") == 0:
        return ()
    return (
        _decode_mum(rec["m"]),
        [(_decode_mum(m), s) for m, s in rec["L"]],
        [(_decode_mum(m), s) for m, s in rec["R"]],
    )


def text_fingerprint(T) -> str:
    """sha1 of the concatenated sentinel-delimited text."""
    return hashlib.sha1(memoryview(T)).hexdigest()


class AnchorLog:
    """Open (resuming if the file has records) or create an anchor log.

    ``replay`` holds the decoded picks to re-apply in pop order;
    ``append(pick)`` records each live decision past the replay point.
    """

    def __init__(self, path: str, texthash: str, cfg):
        self.path = path
        header = {
            "v": _FORMAT_VERSION,
            "texthash": texthash,
            "cfg": asdict(cfg),
        }
        self.replay = []
        self._since_sync = 0
        if os.path.exists(path) and os.path.getsize(path) > 0:
            with open(path) as f:
                lines = f.read().split("\n")
            try:
                have = json.loads(lines[0])
            except (json.JSONDecodeError, IndexError):
                raise ValueError(
                    "checkpoint %r: unreadable header" % path
                )
            if have != header:
                raise ValueError(
                    "checkpoint %r was written for different inputs or "
                    "settings (header mismatch); refusing to resume — "
                    "delete it to start over" % path
                )
            kept = [lines[0]]
            for ln in lines[1:]:
                if not ln:
                    continue
                try:
                    rec = json.loads(ln)
                except json.JSONDecodeError:
                    log.warning(
                        "checkpoint %s: discarding torn trailing record",
                        path,
                    )
                    break
                self.replay.append(_decode_pick(rec))
                kept.append(ln)
            # rewrite without the torn tail so appends start clean
            with open(path, "w") as f:
                f.write("\n".join(kept) + "\n")
            self._fh = open(path, "a")
            log.info(
                "checkpoint %s: resuming with %d logged anchor "
                "decisions to replay",
                path,
                len(self.replay),
            )
        else:
            self._fh = open(path, "w")
            self._fh.write(json.dumps(header) + "\n")
            self._fh.flush()

    def append(self, pick):
        self._fh.write(json.dumps(_encode_pick(pick)) + "\n")
        self._fh.flush()
        self._since_sync += 1
        if self._since_sync >= 100:
            os.fsync(self._fh.fileno())
            self._since_sync = 0

    def close(self):
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None
