"""Byte-level sequence encoding shared by the whole framework.

The generalized text is kept as a numpy uint8 array of ASCII bytes, exactly
mirroring the reference's C text buffer semantics
(reveallib/interface.c:51-95):

* every sample's sequence is appended followed by a ``$`` sentinel byte;
* uppercase bytes are "live" (unaligned) sequence;
* lowercasing (+32) marks positions that were consumed by an anchor match
  (reveallib/reveal.c:1230-1234);
* ``N`` and ``$`` cap match extension (interface.c:107).

Sorting raw bytes gives the same suffix order as the reference's divsufsort,
so downstream MUM semantics carry over unchanged.
"""

from __future__ import annotations

import numpy as np

SENTINEL = ord("$")  # 36
N_BYTE = ord("N")  # 78

# IUPAC complement table over ASCII, matching the reference's comp_tab
# (reveallib/interface.c:136-145): identity outside A-Z/a-z.
_COMP = np.arange(256, dtype=np.uint8)
_pairs = {
    "A": "T", "B": "V", "C": "G", "D": "H", "G": "C", "H": "D", "K": "M",
    "M": "K", "N": "N", "R": "Y", "S": "S", "T": "A", "U": "A", "V": "B",
    "W": "W", "Y": "R", "X": "X",
}
for _a, _b in _pairs.items():
    _COMP[ord(_a)] = ord(_b)
    _COMP[ord(_a.lower())] = ord(_b.lower())


def to_bytes(seq) -> np.ndarray:
    """str/bytes -> uint8 array."""
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8, copy=False)
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return np.frombuffer(seq, dtype=np.uint8).copy()


def to_str(arr: np.ndarray) -> str:
    return arr.tobytes().decode("ascii")


def revcomp(arr: np.ndarray) -> np.ndarray:
    """Reverse complement (IUPAC aware), as a new array."""
    return _COMP[arr[::-1]]


def rc_str(seq: str) -> str:
    return to_str(revcomp(to_bytes(seq)))


def upper(arr: np.ndarray) -> np.ndarray:
    out = arr.copy()
    low = (out >= ord("a")) & (out <= ord("z"))
    out[low] -= 32
    return out


def is_lower(arr: np.ndarray) -> np.ndarray:
    return (arr >= ord("a")) & (arr <= ord("z"))
