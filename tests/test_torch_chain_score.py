"""The score pass of the multi loop's chain DP (``index/chain_score.py``).

``chain_scores_plain`` (the column loop ``chain_dense_multi`` ran) is held
to a row-by-row NumPy DP written from the kernel's contract
(``csrc/chain_score_multi.cu``): each row walks its own columns up to its
last live one, dead columns and everything past the walk NEG, the path
pairs taken as a set, every int32 sum, difference and product wrapped.
The planes are random and built to reach the DP's edges: ties, rows with
no compatible earlier column, rows of 0, 1 and W live columns and with
gaps, absent paths, link scores at NEG // 2, and wrapping.  The wrapper
takes the plain loop on CPU tensors and refuses what the kernel does not
take; on a stood-in card a whole multi ``rem`` goes through the kernel's
entry point, one launch a level, and never through the plain loop.  The
kernel itself runs on the card only (``chip_smoke.py --only chain``).
"""

import numpy as np
import pytest
import torch

from reveal_tpu_torch.align import rem as port_rem
from reveal_tpu_torch.core.io_gfa import seq2node, write_gfa
from reveal_tpu_torch.align.graphops import prune_nodes
from reveal_tpu_torch.index import chain_score, devloop_multi
from reveal_tpu_torch.index.devloop import NEG
from test_devloop_multi import _genomes
import torch_support  # noqa: F401  (the thread budget)


def w32(x):
    """x wrapped to int32, as int64."""
    return ((np.asarray(x, np.int64) + 2**31) % 2**32) - 2**31


def kernel_rows(dS, dE, dalb, dL, dwl, mulr, hbp, pairs, wp, W):
    """The contract, row by row, on numpy arrays: returns (R, W + 1)
    int32."""
    dS, dE, dL, dwl, mulr = (np.asarray(a, np.int64)
                             for a in (dS, dE, dL, dwl, mulr))
    dalb, hbp = np.asarray(dalb, bool), np.asarray(hbp, bool)
    _D, R, W1 = dS.shape
    out = np.full((R, W1), NEG, np.int64)
    for r in range(R):
        live = np.flatnonzero(dalb[r, :W])
        walk = live[-1] + 1 if len(live) else 0
        row_pairs = {(min(a, b), max(a, b))
                     for p, (a, b) in enumerate(zip(*pairs)) if hbp[p, r]}
        for j in range(walk):
            if not dalb[r, j]:
                continue
            mx = NEG
            if j > 0:
                delta = w32(dS[:, r, j, None] - dE[:, r, :j])     # (D, j)
                compat = dalb[r, :j] & (delta >= 0).all(0)
                pen = np.zeros(j, np.int64)
                for a, b in sorted(row_pairs):
                    pen = w32(pen + w32(np.abs(w32(delta[a] - delta[b]))))
                tw = np.where(compat, w32(out[r, :j] - w32(wp * pen)), NEG)
                mx = int(tw.max())
            link = (int(w32(mx + w32(dL[r, j] * mulr[r])))
                    if mx > NEG // 2 else NEG)
            out[r, j] = max(int(dwl[r, j]), link)
    return out.astype(np.int32)


def planes(rng, D, R, W, wide=False):
    """Random planes as ``chain_dense_multi`` builds them: per row a set
    of present paths, a number of live candidates (0, 1, W, gaps, any),
    starts and ends masked to 0 where a path is absent or a candidate
    dead, the pseudo column W live.  ``wide`` draws over int32."""
    haveD = rng.random((D, R)) < 0.75
    haveD[:, 0] = True
    dalb = np.zeros((R, W + 1), bool)
    for r in range(R):
        kind = r % 5
        n = (0, 1, W, int(rng.integers(0, W + 1)), W)[kind]
        dalb[r, :n] = True
        if kind == 4:
            dalb[r, :W][rng.random(W) < 0.3] = False    # gaps
    dalb[:, W] = True
    if wide:
        dS = rng.integers(-2**31, 2**31, (D, R, W + 1), dtype=np.int64)
        dL = rng.integers(-2**31, 2**31, (R, W + 1), dtype=np.int64)
        dwl = rng.integers(-2**31, 2**31, (R, W + 1), dtype=np.int64)
        mulr = rng.integers(-2**31, 2**31, R, dtype=np.int64)
    else:
        # near-sorted positions, so that many earlier columns are
        # compatible; small ranges make ties
        dS = (np.arange(W + 1)[None, None, :] * 4
              + rng.integers(-6, 7, (D, R, W + 1)))
        dL = rng.integers(1, 6, (R, W + 1))
        dwl = rng.integers(-20, 40, (R, W + 1))
        mulr = rng.integers(0, 16, R)
    hv = dalb[None] & haveD[:, :, None]
    dE = np.where(hv, w32(dS + np.where(np.arange(W + 1) < W, dL, 0)[None]),
                  0)
    dS = np.where(hv, dS, 0)
    ia, ib = zip(*[(a, b) for a in range(D) for b in range(a + 1, D)])
    hbp = haveD[list(ia)] & haveD[list(ib)]
    t = torch.from_numpy
    return dict(
        dS=t(w32(dS).astype(np.int32)), dE=t(w32(dE).astype(np.int32)),
        dalb=t(dalb), dL=t(w32(dL).astype(np.int32)),
        dwl=t(w32(dwl).astype(np.int32)), mulr=t(w32(mulr).astype(np.int32)),
        hbp=t(np.ascontiguousarray(hbp)),
        pairs=chain_score.pair_index(D, "cpu"), W=W)


def both(p, wp):
    got = chain_score.chain_scores_plain(wp=wp, **p).numpy()
    want = kernel_rows(*(np.asarray(p[k]) for k in
                         ("dS", "dE", "dalb", "dL", "dwl", "mulr", "hbp")),
                       tuple(x.numpy() for x in p["pairs"]), wp, p["W"])
    return got, want


@pytest.mark.parametrize("D", [3, 6])
@pytest.mark.parametrize("seed", range(4))
def test_plain_equals_the_row_dp_on_random_planes(D, seed):
    rng = np.random.default_rng(100 * D + seed)
    p = planes(rng, D, R=10, W=int(rng.integers(8, 30)))
    for wp in (0, 1, 3):
        got, want = both(p, wp)
        np.testing.assert_array_equal(got, want)
    assert (got[:, p["W"]] == NEG).all()
    assert (got[1::5, 1:] == NEG).all()           # rows of one candidate
    assert (got[0::5] == NEG).all()               # rows of none


@pytest.mark.parametrize("seed", range(3))
def test_plain_equals_the_row_dp_when_everything_wraps(seed):
    rng = np.random.default_rng(seed)
    p = planes(rng, 6, R=10, W=12, wide=True)
    for wp in (1, 7, 2**31 - 1, -2**31):
        got, want = both(p, wp)
        np.testing.assert_array_equal(got, want)


def test_plain_equals_the_row_dp_at_the_edges():
    """Ties in score, no compatible earlier column, link scores just
    above and at NEG // 2 (Python's floor, -1,073,741,824)."""
    D, R, W = 3, 5, 4
    rng = np.random.default_rng(7)
    p = planes(rng, D, R, W)
    dS, dE = p["dS"].numpy(), p["dE"].numpy()
    dalb, dL, dwl = p["dalb"].numpy(), p["dL"].numpy(), p["dwl"].numpy()
    dalb[:, :W] = True
    p["hbp"][:] = True
    p["mulr"][:] = 1
    cols = np.arange(W + 1)
    # row 0: positions fall with the column, nothing earlier is compatible
    dS[:, 0] = 100 - 5 * cols
    dE[:, 0] = dS[:, 0] + 3
    # rows 1-2: every earlier column compatible with no gap penalty; the
    # only way to column 1 is from column 0, whose score is NEG // 2 + 1
    # (row 1: taken) or NEG // 2 (row 2: not taken)
    for r, s0 in ((1, NEG // 2 + 1), (2, NEG // 2)):
        dS[:, r] = 10 * cols
        dE[:, r] = dS[:, r] + 2
        dL[r] = 2
        dwl[r] = NEG
        dwl[r, 0] = s0
    # rows 3-4: a chain through every column; in row 4 columns 0 and 1
    # score the same, a tie for column 2
    for r in (3, 4):
        dS[:, r] = 10 * cols
        dE[:, r] = dS[:, r] + 1
        dL[r] = 1
        dwl[r] = 5
    dL[4, 1] = 0
    got, want = both(p, 1)
    np.testing.assert_array_equal(got, want)
    assert (got[0, :W] == dwl[0, :W]).all()
    assert got[1, 1] == NEG // 2 + 1 + 2 and got[2, 1] == NEG
    assert list(got[3, :W]) == [5, 6, 7, 8]
    assert list(got[4, :W]) == [5, 5, 6, 7]


def test_wrapper_takes_the_plain_loop_on_the_cpu():
    p = planes(np.random.default_rng(5), 4, R=7, W=9)
    before = chain_score.LAUNCHES
    got = chain_score.chain_scores(wp=2, **p)
    assert chain_score.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), both(p, 2)[1])
    p0 = dict(planes(np.random.default_rng(5), 4, R=3, W=0))
    assert (chain_score.chain_scores(wp=1, **p0) == NEG).all()
    assert chain_score.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "columns", "device",
                                 "pairs", "contiguity", "paths", "wp"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    p = planes(np.random.default_rng(6), 3, R=4, W=5)
    wp = 1
    if bad == "dtype":
        p["dS"] = p["dS"].long()
    elif bad == "shape":
        p["dL"] = p["dL"][:3]
    elif bad == "columns":
        p["W"] = 4
    elif bad == "device":
        p["dwl"] = torch.empty(p["dwl"].shape, dtype=torch.int32,
                               device="meta")
    elif bad == "pairs":
        p["pairs"] = chain_score.pair_index(4, "cpu")
    elif bad == "contiguity":
        p["dE"] = p["dE"].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "paths":
        p = planes(np.random.default_rng(6), 9, R=2, W=2)
    elif bad == "wp":
        wp = 2**31
    with pytest.raises((TypeError, ValueError)):
        chain_score.chain_scores(wp=wp, **p)


def test_wrapper_refuses_a_device_that_is_neither():
    p = planes(np.random.default_rng(6), 3, R=4, W=5)
    p = {k: (v.to("meta") if isinstance(v, torch.Tensor) else
             tuple(x.to("meta") for x in v) if k == "pairs" else v)
         for k, v in p.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        chain_score.chain_scores(wp=1, **p)


def _gfa(G, idx, fn):
    prune_nodes(G, T=idx.main.T)
    seq2node(G, idx.main.T)
    write_gfa(G, None, outputfile=fn)
    with open(fn, "rb") as fh:
        return fh.read()


def test_multi_rem_on_a_stood_in_card_takes_the_kernel(tmp_path,
                                                        monkeypatch):
    """The wrapper stands a card in (its route test and its launch
    replaced; the launch computes the contract in numpy): a six-genome
    ``rem`` makes one launch a level with live segments and candidate
    columns, counted in ``LAST_STATS["chain_score_launches"]``, never
    runs the plain loop, and writes the plain run's GFA."""
    genomes = _genomes(19, 1200, 6, 12)
    want = _gfa(*port_rem.align_seqs(genomes, minlength=20, device="cpu"),
                str(tmp_path / "plain.gfa"))
    plain_stats = dict(devloop_multi.LAST_STATS)
    assert plain_stats["chain_score_launches"] == 0

    levels, launches = [], []
    chain = devloop_multi.chain_dense_multi

    def record(table, seg_tab, nseg, segkey, maxcnt, abort, ws, wp, CW, D,
               reads):
        levels.append((nseg, min(maxcnt, CW)))
        return chain(table, seg_tab, nseg, segkey, maxcnt, abort, ws, wp, CW,
                     D, reads)

    def launch(score, dS, dE, dalb, dL, dwl, mulr, hbp, pairs, wp, W):
        launches.append((dS.shape[1], W))
        score.copy_(torch.from_numpy(kernel_rows(
            dS, dE, dalb, dL, dwl, mulr, hbp,
            tuple(x.numpy() for x in pairs), wp, W)))

    def refuse(*_a, **_k):
        raise AssertionError("the plain loop ran on a card")

    monkeypatch.setattr(devloop_multi, "chain_dense_multi", record)
    monkeypatch.setattr(chain_score, "_on_card", lambda _t: True)
    monkeypatch.setattr(chain_score, "_launch", launch)
    monkeypatch.setattr(chain_score, "chain_scores_plain", refuse)
    got = _gfa(*port_rem.align_seqs(genomes, minlength=20, device="cpu"),
               str(tmp_path / "card.gfa"))
    st = devloop_multi.LAST_STATS
    assert got == want
    assert st["abort"] == 0 and st["dispatches"] == 1
    assert st["levels"] == plain_stats["levels"] == len(levels)
    assert launches == [(R, W) for R, W in levels if R > 0 and W > 0]
    assert st["chain_score_launches"] == len(launches) > 1
    assert st["chain_steps"] == plain_stats["chain_steps"] == sum(
        W for _R, W in levels)
