"""The check has to fail what is wrong.  The control (the reference with
``trim=False`` in the program's place) and, through a whole run of the
harness on the CPU with the timed path broken underneath, each fault a
cell can have: a step that returns its state unchanged, half of the input
left out, and an answer altered where it is written (in every job, or in
some jobs only).  (The cells run on
one card: there is no exchange between cards to leave out.)"""

import sys

import pytest

from conftest import ROOT

sys.path.insert(0, ROOT)

from benchmark import cells, compare, harness  # noqa: E402
from benchmark.control import control_reading  # noqa: E402

CELLS = ("pair_2a2b.forest", "panel_1a1f.multi")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", (1, 2, 2**33 + 1))
def test_control_is_not_correct(cell, seed, tiny_root):
    size = 60_000 if cell.startswith("pair") else 30_000
    _seed, nums, _sec = control_reading(cell, seed, root=tiny_root,
                                        size=size)
    assert nums["jobs_wrong"] == 1
    assert nums["lines_off"] > compare.LIMITS["lines_off"]


def _unchanged_state(monkeypatch, cell):
    """The cell's repair step returns what it was given."""
    if cell == "pair_2a2b.forest":
        from reveal_tpu_torch.index import repair

        monkeypatch.setattr(repair, "repair_segments",
                            lambda SA, LCP, BWT, *rest: (SA, LCP, BWT, 1))
    else:
        from reveal_tpu_torch.index import devloop_multi

        monkeypatch.setattr(devloop_multi, "repair_rounds",
                            lambda SA, LCP, moved, *rest: (SA, LCP, moved, 0))


def _half_input(monkeypatch, cell):
    """Each sequence read is cut to its first half."""
    from reveal_tpu_torch.align import rem

    reader = rem.fasta_reader

    def half(*args, **kw):
        for name, seq in reader(*args, **kw):
            yield name, seq[: len(seq) // 2]
    monkeypatch.setattr(rem, "fasta_reader", half)


def _altered_answer(monkeypatch, cell):
    """The GFA writer changes one base of the first segment it writes."""
    from reveal_tpu_torch.core import io_gfa

    write = io_gfa.write_gfa

    def altered(G, T, *args, **kw):
        for node in G.nodes:
            d = G.nodes[node]
            if d.get("seq"):
                s = d["seq"]
                d["seq"] = ("C" if s[0] != "C" else "G") + s[1:]
                break
        return write(G, T, *args, **kw)
    monkeypatch.setattr(io_gfa, "write_gfa", altered)


def _some_jobs_altered(monkeypatch, cell):
    """Only every third GFA written (the warm-up's is the first) has one
    base changed: a fault on some inputs of the pool and not others."""
    from reveal_tpu_torch.core import io_gfa

    write = io_gfa.write_gfa
    calls = [0]

    def altered(G, T, *args, **kw):
        calls[0] += 1
        if calls[0] % 3 == 0:
            for node in G.nodes:
                d = G.nodes[node]
                if d.get("seq"):
                    s = d["seq"]
                    d["seq"] = ("C" if s[0] != "C" else "G") + s[1:]
                    break
        return write(G, T, *args, **kw)
    monkeypatch.setattr(io_gfa, "write_gfa", altered)


FAULTS = {"unchanged_state": _unchanged_state, "half_input": _half_input,
          "altered_answer": _altered_answer,
          "some_jobs_altered": _some_jobs_altered}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(cell, fault, tiny_root, monkeypatch):
    FAULTS[fault](monkeypatch, cell)
    res = harness.run_cell(cells.Cell(cell, tiny_root), 5, 0.1, 0,
                           device="cpu", log=lambda *_: None)
    assert res["correct"] is False
    assert (res["checks"]["jobs_wrong"]["value"] > 0
            or res["checks"]["jobs_failed"]["value"] > 0)


def test_sound_run_is_correct(tiny_root):
    res = harness.run_cell(cells.Cell("pair_2a2b.forest", tiny_root), 5,
                           0.1, 0, device="cpu", log=lambda *_: None)
    assert res["correct"] is True
    assert all(c["value"] == 0 for c in res["checks"].values())
