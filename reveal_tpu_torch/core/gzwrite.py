"""A text-mode writer of ``.gz`` files that deflates at level 9 on the
host's cores while the text is still being written.

``gzip.open(fn, "wt")`` deflates on the calling thread, after the text,
at about a third of a second a megabyte.  ``GzipTextWriter`` collects the
text, cuts it into chunks of ``CHUNK`` bytes as they fill, and deflates
each chunk in a thread pool while the caller goes on writing (zlib lets go
of the interpreter lock while it deflates), as pigz does: every chunk is a
raw deflate stream at level 9 primed with the ``WINDOW`` bytes of text
before it and ended by a sync flush (the last one by a finish), so that
the streams concatenate into one deflate stream.  ``close`` deflates the
tail on the calling thread, waits for the chunks and ends the file's one
gzip member: the header ``gzip.GzipFile`` writes, the streams in order,
the CRC-32 and the length of the whole text.  The finished streams at the
head of the queue are written to the file as the text goes on, and at
most two a thread wait, so a long text is never held whole.

The bytes depend on the text and the mtime only: the chunks are cut at
fixed offsets of the UTF-8 text, whatever the sizes of the write calls or
the number of threads.  A text under one chunk is deflated on the calling
thread, with no pool.  The file is a little larger than serial level 9's
(0.02% on the GFA of a 2 x 1.6 Mbp ``rem``): each chunk starts a new block,
and matches no text further back than its window.
"""

from __future__ import annotations

import collections
import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

from . import trace

# bytes of text a deflate job: large enough that the chunks' extra blocks
# cost next to nothing of level 9's size, small enough that the deflate
# left after the last line is short (a 2 x 1.6 Mbp rem's GFA of 3.7 MB on
# 8 threads: 128 KiB +0.11%, 256 KiB +0.02%, 512 KiB -0.06% and slower)
CHUNK = 256 * 1024
# the text before a chunk that primes its stream: deflate's whole window
WINDOW = 32 * 1024
LEVEL = 9

_FNAME = 0x08

# the last writer's record, cleared at each close: "chunks" (deflate
# streams), "pooled" (of them deflated off the calling thread), "threads"
# (the pool's most, 1 without one), "text_bytes", "gz_bytes"
LAST_STATS = {}


def _deflate(data, zdict, last):
    """One raw deflate stream of ``data`` at ``LEVEL``, primed with
    ``zdict``, ended by a finish if ``last`` else by a sync flush."""
    args = (LEVEL, zlib.DEFLATED, -zlib.MAX_WBITS, zlib.DEF_MEM_LEVEL,
            zlib.Z_DEFAULT_STRATEGY)
    comp = zlib.compressobj(*args, zdict) if zdict else zlib.compressobj(*args)
    return comp.compress(data) + comp.flush(
        zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


def _header(fn, mtime):
    """The member header ``gzip.GzipFile`` writes at level 9: the file's
    base name less ``.gz`` when Latin-1 holds it, the mtime, XFL 2, OS
    255."""
    try:
        fname = os.path.basename(fn).encode("latin-1")
    except UnicodeEncodeError:
        fname = b""
    if fname.endswith(b".gz"):
        fname = fname[:-3]
    return (b"\x1f\x8b\x08" + bytes([_FNAME if fname else 0])
            + struct.pack("<L", int(mtime)) + b"\x02\xff"
            + (fname + b"\x00" if fname else b""))


class GzipTextWriter:
    """``gzip.open(fn, "wt")``'s writing, the deflate on ``threads``
    threads (default: the CPUs, at most 8); ``mtime`` defaults to now."""

    def __init__(self, fn, threads=None, mtime=None):
        self._threads = (min(os.cpu_count() or 1, 8) if threads is None
                         else max(1, int(threads)))
        self._fh = open(fn, "wb")
        self._gz = 0
        self._put(_header(fn, time.time() if mtime is None else mtime))
        self._parts = []  # text written since the last cut
        self._nchars = 0
        self._carry = b""  # encoded text short of a chunk
        self._window = b""  # the text before the next chunk
        self._crc = 0
        self._size = 0
        self._chunks = 0
        self._pooled = 0
        self._pool = None
        # each stream in order: its bytes, or the future of them
        self._queue = collections.deque()

    def write(self, s):
        self._parts.append(s)
        self._nchars += len(s)
        # a character is at least one byte: a chunk has filled
        if len(self._carry) + self._nchars >= CHUNK:
            self._cut()
            self._drain(2 * self._threads)
        return len(s)

    def _cut(self):
        """Submit the full chunks of the text so far; carry the rest."""
        data = self._carry + "".join(self._parts).encode("utf-8")
        self._parts = []
        self._nchars = 0
        full = len(data) - len(data) % CHUNK
        for off in range(0, full, CHUNK):
            self._submit(data[off:off + CHUNK])
        self._carry = data[full:]

    def _submit(self, chunk, last=False):
        zdict = self._window
        # every chunk but the last is CHUNK >= WINDOW bytes
        self._window = chunk[-WINDOW:]
        self._crc = zlib.crc32(chunk, self._crc)
        self._size += len(chunk)
        self._chunks += 1
        if last or self._threads == 1:
            self._queue.append(_deflate(chunk, zdict, last))
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self._threads)
        self._queue.append(self._pool.submit(_deflate, chunk, zdict, False))
        self._pooled += 1

    def _drain(self, keep):
        """Write the finished streams at the head of the queue, waiting for
        the head while more than ``keep`` streams are queued."""
        queue = self._queue
        while queue:
            head = queue[0]
            if not isinstance(head, bytes):
                if len(queue) <= keep and not head.done():
                    return
                head = head.result()
            queue.popleft()
            self._put(head)

    def _put(self, data):
        self._fh.write(data)
        self._gz += len(data)

    def close(self):
        if self._fh is None:
            return
        try:
            with trace.span("gfa.deflate"):
                self._cut()
                self._submit(self._carry, last=True)
                self._drain(0)
                self._put(struct.pack("<LL", self._crc,
                                      self._size & 0xFFFFFFFF))
        finally:
            if self._pool is not None:
                self._pool.shutdown(cancel_futures=True)
            self._fh.close()
            self._fh = None
        LAST_STATS.clear()
        LAST_STATS.update(
            chunks=self._chunks, pooled=self._pooled,
            threads=min(self._threads, self._pooled) if self._pooled else 1,
            text_bytes=self._size, gz_bytes=self._gz)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
