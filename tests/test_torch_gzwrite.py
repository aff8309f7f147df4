"""The port's ``.gz`` text writer (``reveal_tpu_torch/core/gzwrite.py``):
one gzip member at level 9 whose text is what was written, whatever the
chunks, the write calls or the threads, and the span and counters that
trace it."""

import gzip
import io
import os
import zlib

import pytest

from reveal_tpu_torch.core import gzwrite, trace
from reveal_tpu_torch.core.gzwrite import CHUNK, GzipTextWriter
from reveal_tpu_torch.core.io_gfa import read_gfa, write_gfa
from reveal_tpu_torch.utils.simulate import simulate_population
import torch_support  # noqa: F401  (the thread budget)


def _write(fn, text, step=1_000, **kw):
    with GzipTextWriter(fn, **kw) as f:
        for i in range(0, len(text), step):
            assert f.write(text[i:i + step]) == len(text[i:i + step])
    with open(fn, "rb") as fh:
        return fh.read()


def _one_member(raw):
    dec = zlib.decompressobj(31)
    out = dec.decompress(raw)
    return dec.eof and dec.unused_data == b"", out


def _gfa_text(length, seed=3):
    """A GFA of a chain of bubbles cut from two simulated genomes: a
    shared node of the first, then one allele node of each."""
    (_n1, a, _i1), (_n2, b, _i2) = simulate_population(2, length, seed=seed)
    lines, p1, p2 = ["H\tVN:Z:1.0\n"], [], []
    node, pos, step = 0, 0, 150
    end = min(len(a), len(b)) - 2 * step
    while pos < end:
        shared, alt1, alt2 = node + 1, node + 2, node + 3
        lines.append("S\t%d\t%s\n" % (shared, a[pos:pos + step]))
        lines.append("S\t%d\t%s\n" % (alt1, a[pos + step:pos + step + 7]))
        lines.append("S\t%d\t%s\n" % (alt2, b[pos + step:pos + step + 9]))
        for alt in (alt1, alt2):
            lines.append("L\t%d\t+\t%d\t+\t0M\n" % (shared, alt))
            if pos + step + 7 < end:
                lines.append("L\t%d\t+\t%d\t+\t0M\n" % (alt, node + 4))
        p1.append(shared)
        p1.append(alt1)
        p2.append(shared)
        p2.append(alt2)
        node += 3
        pos += step + 7
    for name, path in (("anc", p1), ("g1", p2)):
        lines.append("P\t%s\t%s\t%s\n" % (
            name, ",".join("%d+" % n for n in path),
            ",".join("0M" for _ in path)))
    return "".join(lines)


@pytest.mark.parametrize("n", [0, 1, CHUNK - 1, CHUNK, CHUNK + 1])
def test_text_round_trips_at_chunk_edges(tmp_path, n):
    text = ("ACGT" * (n // 4 + 1) + "\n")[:n]
    raw = _write(str(tmp_path / "x.gfa.gz"), text, step=4_099)
    assert gzip.decompress(raw) == text.encode()
    whole, out = _one_member(raw)
    assert whole and out == text.encode()
    assert gzwrite.LAST_STATS["text_bytes"] == n
    assert gzwrite.LAST_STATS["gz_bytes"] == len(raw)


def test_many_chunks_under_a_name_latin1_cannot_hold(tmp_path):
    text = "S\t1\tACGTé\n" * (3 * CHUNK // 10) + "P\tgenome_ü\t1+\t0M\n"
    fn = str(tmp_path / "图谱.gfa.gz")
    raw = _write(fn, text, step=777, mtime=7)
    data = text.encode("utf-8")
    assert len(data) > 3 * CHUNK
    assert gzip.decompress(raw) == data
    assert _one_member(raw)[0]
    st = gzwrite.LAST_STATS
    assert st["chunks"] == len(data) // CHUNK + 1
    assert st["text_bytes"] == len(data) and st["gz_bytes"] == len(raw)


@pytest.mark.parametrize("name", ["g.gfa.gz", "grafé.gfa.gz", "图.gfa.gz"])
def test_header_is_gzip_files_own(tmp_path, name):
    fn = str(tmp_path / name)
    raw = _write(fn, "", mtime=1234567)
    buf = io.BytesIO()
    with gzip.GzipFile(filename=fn, mode="wb", fileobj=buf, mtime=1234567,
                       compresslevel=9):
        pass
    head = buf.getvalue()[:-10]  # less its empty stream and trailer
    assert raw.startswith(head)
    assert raw[8] == 2  # XFL: level 9


def test_bytes_do_not_depend_on_threads_or_write_calls(tmp_path):
    text = _gfa_text(400_000)
    outs = []
    for threads, step in ((1, 1_000), (8, 1_000), (8, 65_537), (3, 13)):
        d = tmp_path / ("t%d_%d" % (threads, step))
        d.mkdir()
        outs.append(_write(str(d / "g.gfa.gz"), text, step=step,
                           threads=threads, mtime=42))
    assert all(o == outs[0] for o in outs)
    assert gzip.decompress(outs[0]) == text.encode()


def test_stats_count_chunks_and_pooled(tmp_path):
    text = "x" * (5 * CHUNK + 3)
    _write(str(tmp_path / "a.gz"), text, threads=8)
    assert gzwrite.LAST_STATS == {
        "chunks": 6, "pooled": 5, "threads": 5,
        "text_bytes": len(text), "gz_bytes": os.path.getsize(
            tmp_path / "a.gz")}
    _write(str(tmp_path / "b.gz"), text, threads=1)
    st = gzwrite.LAST_STATS
    assert (st["chunks"], st["pooled"], st["threads"]) == (6, 0, 1)
    # under one chunk: the calling thread alone
    _write(str(tmp_path / "c.gz"), "y" * (CHUNK - 1), threads=8)
    st = gzwrite.LAST_STATS
    assert (st["chunks"], st["pooled"], st["threads"]) == (1, 0, 1)


def test_size_within_a_percent_of_serial_level_9(tmp_path):
    text = _gfa_text(1_200_000)
    raw = _write(str(tmp_path / "g.gfa.gz"), text, threads=4)
    assert gzwrite.LAST_STATS["chunks"] >= 4
    serial = len(gzip.compress(text.encode(), 9))
    assert len(raw) <= 1.01 * serial


def test_gzip_open_and_read_gfa_read_it(tmp_path):
    text = _gfa_text(300_000)
    plain = str(tmp_path / "g.gfa")
    with open(plain, "w") as fh:
        fh.write(text)
    gz = str(tmp_path / "g.gfa.gz")
    _write(gz, text)
    assert gzwrite.LAST_STATS["chunks"] > 1
    with gzip.open(gz, "rt") as fh:
        assert fh.read() == text
    # the graph read from either file writes the same text
    out = []
    for fn in (plain, gz):
        dst = str(tmp_path / ("back%d.gfa" % len(out)))
        write_gfa(read_gfa(fn), None, outputfile=dst)
        with open(dst) as fh:
            out.append(fh.read())
    assert out[0] == out[1] and out[0].count("\nS\t") > 1000


def test_write_gfa_to_gz_is_the_plain_text(tmp_path):
    text = _gfa_text(300_000)
    src = str(tmp_path / "src.gfa")
    with open(src, "w") as fh:
        fh.write(text)
    G = read_gfa(src)
    write_gfa(G, None, outputfile=str(tmp_path / "a.gfa"))
    write_gfa(G, None, outputfile=str(tmp_path / "a.gfa.gz"))
    with open(tmp_path / "a.gfa", "rb") as fh:
        want = fh.read()
    with open(tmp_path / "a.gfa.gz", "rb") as fh:
        assert gzip.decompress(fh.read()) == want
    assert gzwrite.LAST_STATS["text_bytes"] == len(want)


def test_close_is_the_deflate_span(tmp_path):
    was = trace.enable(True)
    try:
        trace.begin()
        _write(str(tmp_path / "g.gfa.gz"), "z" * (2 * CHUNK + 1))
        rec = dict(trace.LAST_STATS)
    finally:
        trace.enable(was)
    assert "gfa.deflate" in trace.LABELS
    assert rec["gfa.deflate.calls"] == 1 and rec["gfa.deflate"] >= 0


def test_deflate_reader_reads_the_span_and_nothing_without_it(
        monkeypatch):
    from benchmark import cells, harness

    reader = cells.load_reader("gfa_deflate_s")
    run = harness.Run("cpu")
    run.jobs = [{"route": "forest", "spans": {}, "stats": {"trace": t}}
                for t in ({"job": 1, "gfa.deflate": 0.02},
                          {"job": 2, "gfa.deflate": 0.04})]
    assert reader.read(run) == pytest.approx(0.03)
    # a program whose spans predate the label
    monkeypatch.setattr(trace, "LABELS", tuple(
        label for label in trace.LABELS if label != "gfa.deflate"))
    assert reader.read(run) is None
