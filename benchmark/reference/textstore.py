"""Generalized text store: N genomes concatenated with sentinels.

Mirrors the sample/sequence bookkeeping of the reference index object
(reveallib/interface.c:18-95,116-134):

* ``add_sample(name)`` registers a sample (one fasta file or one graph);
* ``add_sequence(seq)`` appends ``seq + '$'`` to the text and returns the
  interval ``(start, start+len)`` (sentinel excluded) — these intervals are
  the initial graph nodes;
* ``nsep`` holds the text position of the sentinel *preceding* each sample
  boundary (nsep[k] = last index of sample k's region, i.e. its final '$');
* ``SO`` maps every text position to its sample ordinal (the reference only
  builds it for >2 samples; we always expose it).

The store is host-side numpy; device kernels receive the text as a jnp
uint8 array.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from .encoding import SENTINEL, to_bytes


@dataclass
class TextStore:
    samples: List[str] = field(default_factory=list)
    _chunks: List[np.ndarray] = field(default_factory=list)
    # per-chunk sample ordinal
    _chunk_sample: List[int] = field(default_factory=list)
    n: int = 0

    def add_sample(self, name: str) -> int:
        self.samples.append(name)
        return len(self.samples) - 1

    def add_sequence(self, seq) -> Tuple[int, int]:
        """Append seq + '$' under the most recently added sample.

        Returns the (start, end) interval of the sequence excluding the
        sentinel, like reveallib's addsequence (interface.c:51-95).
        """
        if not self.samples:
            raise ValueError("add_sample() before add_sequence()")
        arr = to_bytes(seq)
        start = self.n
        chunk = np.empty(len(arr) + 1, dtype=np.uint8)
        chunk[:-1] = arr
        chunk[-1] = SENTINEL
        self._chunks.append(chunk)
        self._chunk_sample.append(len(self.samples) - 1)
        self.n += len(chunk)
        return (start, start + len(arr))

    @property
    def nsamples(self) -> int:
        return len(self.samples)

    def build(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Finalize -> (T, SO, nsep).

        T: uint8 text (each sequence followed by '$').
        SO: uint16/uint32 sample ordinal per position.
        nsep: int64 array; nsep[k] = index of the final '$' of sample k,
              for k in 0..nsamples-2 (matching interface.c:36-44 where the
              boundary is recorded when the *next* sample is added; we also
              append the final boundary for convenience at build time).
        """
        T = np.concatenate(self._chunks) if self._chunks else np.empty(0, np.uint8)
        so_dtype = np.uint16 if self.nsamples < 65535 else np.uint32
        SO = np.empty(self.n, dtype=so_dtype)
        pos = 0
        last_of_sample = {}
        for chunk, sid in zip(self._chunks, self._chunk_sample):
            SO[pos : pos + len(chunk)] = sid
            pos += len(chunk)
            last_of_sample[sid] = pos - 1
        nsep = np.array(
            [last_of_sample[s] for s in sorted(last_of_sample)], dtype=np.int64
        )
        return T, SO, nsep
