"""Per-bubble result log: checkpoint/resume for the refine stage.

Same rationale as the rem anchor log (align/anchorlog.py): the
reference restarts a crashed refine from scratch (its mp pool streams
results straight into the output graph writer, refine.py:326-374, with
no on-disk intermediate), while pod-scale refine runs on preemptible
hosts want to keep the bubbles already realigned.  Bubbles are
independent — the selection over an input GFA is deterministic and each
bubble's realignment touches only its own subgraph — so the log is a
keyed map, not a replay sequence:

* key = (source node id, sink node id) of the bubble in the input graph;
* value = the full ``refine_bubble`` result (bubble, new subgraph,
  per-path start/end offsets), pickled and base64-wrapped into a JSON
  line (the same objects already cross the --nproc fork pool boundary
  pickled);
* a resumed run skips pair-HMM/consistency/MSA for logged bubbles
  entirely — their pairs never even join the device batch — and
  splices stored results in the original bubble order, so the output
  graph is byte-identical to an uninterrupted run.

The header pins a caller-supplied fingerprint of the input GFA plus
every selection/MSA parameter; a log never resumes against different
inputs or settings.  Torn trailing lines from a crash are discarded.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import pickle

log = logging.getLogger(__name__)

_FORMAT_VERSION = 1


class RefineLog:
    """Open (resuming) or create a per-bubble result log.

    ``done`` maps (source, sink) -> unpickled refine_bubble result.
    """

    def __init__(self, path: str, meta: dict):
        self.path = path
        header = {"v": _FORMAT_VERSION, "meta": meta}
        # normalize through one json round trip so float repr etc.
        # compare equal against a reread header
        header = json.loads(json.dumps(header))
        self.done = {}
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
                    res = pickle.loads(base64.b64decode(rec["r"]))
                except Exception:
                    log.warning(
                        "checkpoint %s: discarding torn trailing record",
                        path,
                    )
                    break
                self.done[tuple(rec["k"])] = res
                kept.append(ln)
            with open(path, "w") as f:
                f.write("\n".join(kept) + "\n")
            self._fh = open(path, "a")
            log.info(
                "checkpoint %s: resuming with %d bubbles already "
                "refined",
                path,
                len(self.done),
            )
        else:
            self._fh = open(path, "w")
            self._fh.write(json.dumps(header) + "\n")
            self._fh.flush()

    def append(self, key, res):
        rec = {
            "k": list(key),
            "r": base64.b64encode(
                pickle.dumps(res, protocol=pickle.HIGHEST_PROTOCOL)
            ).decode("ascii"),
        }
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        self._since_sync += 1
        if self._since_sync >= 20:
            os.fsync(self._fh.fileno())
            self._since_sync = 0

    def close(self):
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None
