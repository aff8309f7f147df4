"""FASTA reading/writing.

Behavioral parity with the reference's fasta_reader/fasta_writer
(reveal/utils.py:79-160): gz transparency, ``-`` stripping,
optional uppercase, optional N-truncation and N-splitting (cutN).
"""

from __future__ import annotations

import gzip
from typing import Iterator, Tuple


# bytes.translate table: lowercase -> uppercase (C speed)
_UPPER_TAB = bytes(
    b - 32 if ord("a") <= b <= ord("z") else b for b in range(256)
)


def _open(fn: str, mode: str = "rt"):
    if fn.endswith(".gz"):
        return gzip.open(fn, mode)
    return open(fn, mode)


def fasta_reader(
    fn: str,
    truncN: bool = False,
    toupper: bool = True,
    cutN: int = 0,
    keepdash: bool = False,
) -> Iterator[Tuple[str, str]]:
    """Yield (name, seq).

    cutN>0 splits records at runs of >=cutN N's and suffixes names with
    ``_<i>``; truncN collapses N runs to a single N.
    """
    name = None
    parts = []

    def finalize(seq: str):
        if truncN:
            out = []
            for b in seq:
                if b == "N" and (not out or out[-1] == "N"):
                    continue
                out.append(b)
            seq = "".join(out)
        return seq

    def split_cutn(seq: str):
        pieces = []
        cur = []
        nrun = 0
        for b in seq:
            if b == "N":
                nrun += 1
            else:
                if nrun:
                    if nrun >= cutN:
                        if cur:
                            pieces.append("".join(cur))
                            cur = []
                    else:
                        cur.append("N" * nrun)
                    nrun = 0
                cur.append(b)
        if cur:
            pieces.append("".join(cur))
        return pieces

    # fast path for plain files with default options: one bytes read +
    # C-speed translate (the line loop costs ~0.15 s on a 3.7 Mbp
    # genome; this is ~20x faster and byte-identical for records
    # without cutN/truncN processing)
    if (
        not fn.endswith(".gz")
        and not truncN
        and cutN == 0
        and not keepdash
        and toupper
    ):
        with open(fn, "rb") as f:
            data = f.read()
        pos = data.find(b">")
        while pos >= 0:
            eol = data.find(b"\n", pos)
            if eol < 0:
                eol = len(data)
            hdr = (
                data[pos + 1 : eol]
                .rstrip(b"\r")
                .decode()
                .replace("\t", "")
            )
            nxt = data.find(b">", eol)
            body = data[eol + 1 : nxt if nxt >= 0 else len(data)]
            seq = body.translate(_UPPER_TAB, delete=b"\r\n-").decode()
            if body:  # the line reader skips bodyless records
                yield hdr, seq
            pos = nxt
        return

    with _open(fn) as f:
        for line in f:
            line = line.rstrip()
            if line.startswith(">"):
                if name is not None and parts:
                    seq = "".join(parts)
                    if cutN > 0:
                        for i, piece in enumerate(split_cutn(seq)):
                            yield "%s_%d" % (name, i), finalize(piece)
                    else:
                        yield name, finalize(seq)
                name = line[1:].replace("\t", "")
                parts = []
            else:
                if toupper:
                    line = line.upper()
                if not keepdash:
                    line = line.replace("-", "")
                parts.append(line)
        if name is not None and parts:
            seq = "".join(parts)
            if cutN > 0:
                for i, piece in enumerate(split_cutn(seq)):
                    yield "%s_%d" % (name, i), finalize(piece)
            else:
                yield name, finalize(seq)


def fasta_writer(fn: str, name_seq, lw: int = 100) -> None:
    with _open(fn, "wt") as f:
        for name, seq in name_seq:
            if not name.startswith(">"):
                name = ">" + name
            f.write(name + "\n")
            for i in range(0, len(seq), lw):
                f.write(seq[i : i + lw] + "\n")
