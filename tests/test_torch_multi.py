"""The torch port's multi-genome ``rem`` on the CPU.

Three or more genomes take the port's multi-genome loop
(reveal_tpu_torch/index/devloop_multi.py, plain torch on the CPU, the
window-resolve search through its wrapper).  The JAX package's own multi
kernel cannot serve as the oracle: it raises NameError on ``segstart``
(reveal_tpu/index/devloop.py:2616).  So the GFA bytes are held against the
JAX package's host engine (``align_seqs(..., frontier=False)`` and
``align_genomes`` without ``frontier``), the root's candidates against
its host multiMUM enumeration and the root's pick against its host
picker, and the repair rounds against an exact sequential resolve.
Every input is made from a numpy seed.
"""

import numpy as np
import pytest
import torch

import reveal_tpu.align.rem as jax_rem
from reveal_tpu.align.graphops import IntervalIndex as JaxIntervalIndex
from reveal_tpu.align.picker import MumPicker, PickerConfig
from reveal_tpu.core.textstore import TextStore as JaxTextStore
from reveal_tpu.graph.pangraph import PanGraph as JaxPanGraph
from reveal_tpu.index.esa_index import ESAIndex as JaxESAIndex
from reveal_tpu.utils.simulate import simulate_population
from reveal_tpu_torch.align import rem as port_rem
from reveal_tpu_torch.core.textstore import TextStore
from reveal_tpu_torch.index import devloop, devloop_multi
from reveal_tpu_torch.index import window_resolve as wr
from reveal_tpu_torch.index.esa_index import ESAIndex
from test_devloop_multi import _genomes
from torch_support import jax_gfa, write_population

CPU = torch.device("cpu")
GENOME_CASES = [(3, 2000, 3, 4), (13, 1000, 6, 5), (19, 1200, 6, 12),
                (37, 2200, 7, 7)]


@pytest.fixture
def no_host_engine(monkeypatch):
    """The port's host engine must not run."""
    def refuse(*_a, **_k):
        raise AssertionError("the port ran its host engine")
    monkeypatch.setattr(port_rem, "_align_loop", refuse)


def _assert_engaged():
    st = devloop_multi.LAST_STATS
    assert st["dispatches"] >= 1 and st["abort"] == 0, st
    assert st["fallback"] is None and st["levels"] >= 1, st
    assert st["repair_rounds_total"] > 0, st
    assert st["window_resolve_launches"] == 0  # CPU tensors: plain path


def _population(n, length, seed):
    return [(name, seq) for name, seq, _ids in
            simulate_population(n, length, seed=seed)]


@pytest.mark.parametrize(
    "gen",
    [pytest.param(c, id="genomes-%d-%d-%d-%d" % c) for c in GENOME_CASES]
    + [pytest.param((n, length, seed), id="population-%dx%d" % (n, length))
       for n, length, seed in ((3, 6000, 2), (5, 4000, 3), (8, 3000, 5))],
)
def test_align_seqs_matches_the_jax_host_engine(gen, tmp_path,
                                                no_host_engine):
    """D = 3..8 single-contig samples: the port's multi loop on the CPU
    writes the JAX package's host-engine GFA byte for byte."""
    aobjs = _genomes(*gen) if len(gen) == 4 else _population(*gen)
    G, idx = jax_rem.align_seqs(aobjs, minlength=20, frontier=False)
    want = jax_gfa(G, idx, str(tmp_path / "host.gfa"))
    G, idx = port_rem.align_seqs(aobjs, minlength=20, device="cpu")
    _assert_engaged()
    assert devloop_multi.LAST_STATS["paths"] == len(aobjs)
    assert port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa")) == want


@pytest.mark.parametrize("n,length,seed,split",
                         [(3, 6000, 4, 1), (4, 4000, 6, 0)])
def test_two_contig_sample_matches_the_jax_host_engine(
        tmp_path, no_host_engine, n, length, seed, split):
    """One sample of two contigs: paths are not samples (sample_of_path
    is not the identity), through ``align_genomes``."""
    fastas = write_population(tmp_path, n, length, seed, split)
    G, idx = jax_rem.align_genomes(fastas, backend="auto")
    want = jax_gfa(G, idx, str(tmp_path / "host.gfa"))
    G, idx = port_rem.align_genomes(fastas, device="cpu")
    _assert_engaged()
    assert devloop_multi.LAST_STATS["paths"] == n + 1
    assert port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa")) == want


# ----------------------------------------------------------------------
# the root level against the JAX package's host functions
# ----------------------------------------------------------------------
def _root(aobjs):
    """The root layout of ``aobjs`` on the CPU: (port index, tensors,
    sample of each path, path intervals)."""
    ts = TextStore()
    ivs = []
    for name, seq in aobjs:
        ts.add_sample(name)
        ivs.append(tuple(int(v) for v in ts.add_sequence(seq)))
    idx = ESAIndex.construct(ts, backend="native")
    n = len(idx.SA)
    npad = devloop._next_pow2(n)
    SA = np.full(npad, n - 1, np.int32)
    SA[:n] = idx.SA
    LCP = np.zeros(npad, np.int32)
    LCP[:n] = idx.LCP
    SEG = np.full(npad, -1, np.int32)
    SEG[:n] = 0
    T = idx.main.T
    pof = np.zeros(len(T) + 1, np.int32)
    for pid, (b, e) in enumerate(ivs):
        pof[b:e] = pid
    SOA = np.zeros(npad, np.int32)
    SOA[:n] = pof[np.minimum(SA[:n], len(T))]
    t = {k: torch.from_numpy(v) for k, v in
         (("SA", SA), ("LCP", LCP), ("SEG", SEG), ("SOA", SOA))}
    t["T"] = torch.from_numpy(T.astype(np.int32))
    return idx, t, ivs


def test_root_candidates_equal_the_host_multimums():
    """The root's candidate table (after enumeration, before the subset
    pick) equals ``ESAIndex.getmultimums_arrays`` of the JAX package:
    the same multiMUMs in the same order, lexsort (l, lb, ub), each with
    its length, width and one position per path of its window."""
    aobjs = _population(5, 5000, 7)
    idx, t, _ivs = _root(aobjs)
    D = len(aobjs)
    BWT = t["T"][(t["SA"] - 1).clamp(min=0)]
    table, abort = devloop_multi.enumerate_multi(
        t["SA"], t["LCP"], BWT, t["SOA"], t["SEG"], list(range(D)), 20, 2,
        10000, 4096, 8, torch.zeros((), dtype=torch.int32),
    )
    assert int(abort) == 0
    table = table[table[:, devloop_multi.C_SEG] == 0].numpy()

    ts = JaxTextStore()
    for name, seq in aobjs:
        ts.add_sample(name)
        ts.add_sequence(seq)
    jidx = JaxESAIndex.construct(ts, backend="native")
    ls, widths, flat, offs = jidx.getmultimums_arrays(minlength=20, minn=2)
    assert len(ls) == len(table) > 100
    np.testing.assert_array_equal(table[:, devloop_multi.C_L], ls)
    np.testing.assert_array_equal(table[:, devloop_multi.C_W], widths)
    P = table[:, devloop_multi.C_P:devloop_multi.C_P + D]
    for i in range(len(ls)):
        want = np.sort(flat[offs[i]:offs[i + 1]])
        np.testing.assert_array_equal(np.sort(P[i][P[i] >= 0]), want)


def test_root_pick_equals_the_host_picker():
    """The first anchor of the loop (the root's pick) is the one
    ``MumPicker.pick_multi`` of the JAX package picks from the same
    candidates: the same length and positions."""
    aobjs = _population(4, 6000, 8)
    idx, t, ivs = _root(aobjs)
    D = len(aobjs)
    caps = devloop_multi.root_caps(t["SA"].shape[0], 256)
    seg_tab = np.zeros((caps.SMAX, 2 + 3 * D), np.int32)
    seg_tab[0, 0] = -1
    seg_tab[0, 2:2 + D] = [b for b, _e in ivs]
    seg_tab[0, 2 + D:2 + 2 * D] = [e for _b, e in ivs]
    seg_tab[0, 2 + 2 * D:] = -1
    live_key = np.zeros(caps.SMAX, np.int32)
    live_key[0] = (1 << D) - 1
    out = devloop_multi.multi_run(
        t["T"].to(torch.uint8), t["SA"], t["LCP"], t["SOA"], t["SEG"],
        torch.from_numpy(seg_tab), torch.from_numpy(live_key),
        list(range(D)), 20, 2, 10000, 1, 1, caps, level_cap=1,
    )
    assert out["abort"] == 0 and out["level"] == 1 and out["acount"] == 1
    rec = out["anchors"][0].tolist()
    # positions in the record's coordinate order (its path nibbles)
    got = [rec[5 + ((rec[4] >> (4 * k)) & 15)] for k in range(rec[1])]

    # the JAX package's picker on the graph align_seqs starts from
    ts = JaxTextStore()
    G = JaxPanGraph()
    tix = JaxIntervalIndex()
    G.add_node("start")
    G.add_node("end")
    nodes = set()
    for sid, (name, seq) in enumerate(aobjs):
        ts.add_sample(name)
        iv = ts.add_sequence(seq)
        tix.add(iv)
        G.graph["paths"].append(name)
        G.graph["path2id"][name] = sid
        G.graph["id2path"][sid] = name
        G.graph["id2end"][sid] = len(seq)
        G.add_node(iv, offsets={sid: 0}, aligned=0)
        G.add_edge("start", iv, paths={sid}, ofrom="+", oto="+")
        G.add_edge(iv, "end", paths={sid}, ofrom="+", oto="+")
        nodes.add(iv)
    jidx = JaxESAIndex.construct(ts, backend="native")
    jidx.nodes = nodes
    picker = MumPicker(G, tix, PickerConfig(minlength=20))
    picker.set_fastmap(jidx.nodes)
    arrs = jidx.getmultimums_arrays(minlength=20, minn=2)
    (l, n, spd), _skipl, _skipr = picker.pick_multi(*arrs, jidx,
                                                    minlength=20)
    assert (rec[0], rec[1]) == (l, n)
    assert got == [p for _gid, p in spd]


# ----------------------------------------------------------------------
# repair rounds: SOA moves with SA
# ----------------------------------------------------------------------
def _sequential(SA, LCP, BWT, SOA, beg, cq, centry_next, rc):
    """Each crossing suffix in ascending slot order on the live state,
    the insertion point by a whole-array search (bubble_sort,
    reveal.c:666-727), SOA rotating with SA and BWT."""
    SA, LCP, BWT, SOA = SA.copy(), LCP.copy(), BWT.copy(), SOA.copy()
    npad = len(SA)
    for j in range(min(int(rc), len(cq))):
        q = int(cq[j])
        b = int(beg[q])
        saq, lcq = int(SA[q]), int(LCP[q])
        thr = b - saq
        move = saq < b and saq + lcq > b
        if move:
            below = np.nonzero(LCP[:q] < thr)[0]
            x = int(below[-1]) if below.size else 0
            bwq, soq = BWT[q], SOA[q]
            for arr in (SA, BWT, SOA, LCP):
                arr[x + 1:q + 1] = arr[x:q].copy()
            SA[x], BWT[x], SOA[x] = saq, bwq, soq
            LCP[x + 1] = thr
        qn = min(q + 1, npad - 1)
        lcp_qn = int(LCP[qn])
        if move and q < npad - 1 and lcq < lcp_qn:
            LCP[qn] = lcq
        elif (not move and q < npad - 1 and saq < b
              and saq + int(centry_next[j]) > b and lcp_qn > LCP[q]):
            LCP[qn] = b - saq
    return SA, LCP, BWT, SOA


def test_repair_rounds_equal_the_sequential_resolve(monkeypatch):
    """Every repair pass of a multi run on the CPU (batched rounds over
    the window-resolve wrapper) equals the exact sequential resolve on
    the same input, SOA included; some pass moves SOA."""
    passes = []
    original = devloop_multi.repair_pass_multi

    def record(SA, LCP, BWT, SOA, SEG, beg, CCAP, SMAX, abort, rstats,
               reads):
        ins = [a.numpy().copy() for a in (SA, LCP, BWT, SOA, beg)]
        out = original(SA, LCP, BWT, SOA, SEG, beg, CCAP, SMAX, abort,
                       rstats, reads)
        passes.append((ins, [a.numpy().copy() for a in out[:4]], CCAP))
        return out

    monkeypatch.setattr(devloop_multi, "repair_pass_multi", record)
    before = wr.LAUNCHES
    port_rem.align_seqs(_genomes(19, 1200, 6, 12), minlength=20,
                        device="cpu")
    assert devloop_multi.LAST_STATS["abort"] == 0
    assert wr.LAUNCHES == before
    moved_soa = 0
    for (SA, LCP, BWT, SOA, beg), got, CCAP in passes:
        cq, centry_next, rc, _abort = devloop.repair_queue(
            *(torch.from_numpy(a) for a in (SA, LCP)),
            torch.from_numpy(beg) >= 0, torch.from_numpy(beg), CCAP,
            torch.zeros((), dtype=torch.int32))
        want = _sequential(SA, LCP, BWT, SOA, beg, cq.numpy(),
                           centry_next.numpy(), int(rc))
        for name, g, w in zip(("SA", "LCP", "BWT", "SOA"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
        moved_soa += int((got[3] != SOA).any())
    assert len(passes) > 20 and moved_soa > 0


# ----------------------------------------------------------------------
# declines: the per-level frontier takes them
# ----------------------------------------------------------------------
def _node_state(G):
    """tests/test_frontier.py's ``_node_state``: the frontier builds the
    host engine's nodes; only the GFA's node numbering may differ."""
    return sorted(
        (n, tuple(sorted(G.nodes[n]["offsets"].items())),
         G.nodes[n].get("aligned", 0))
        for n in G.nodes if isinstance(n, tuple))


@pytest.fixture
def stood_in_card(monkeypatch):
    """``device="cuda"`` resolves to a CUDA device, while the multi loop
    and the frontier run on the CPU."""
    from reveal_tpu_torch.index import devfrontier

    monkeypatch.setattr(port_rem, "resolve_device",
                        lambda _d: torch.device("cuda"))
    loop = devloop_multi.rem_device_multi
    monkeypatch.setattr(devloop_multi, "rem_device_multi",
                        lambda *a, **k: loop(*a, **dict(k, device=CPU)))

    class OnTheCPU(devfrontier.DeviceFrontier):
        def __init__(self, T, SA, LCP, SO, nsep0, nsamples, device,
                     stats=None):
            assert torch.device(device).type == "cuda"
            super().__init__(T, SA, LCP, SO, nsep0, nsamples, CPU, stats)

    monkeypatch.setattr(devfrontier, "DeviceFrontier", OnTheCPU)
    return devfrontier


def test_decline_raises_on_cuda(tmp_path, stood_in_card, no_host_engine):
    """On a CUDA device an abort code (here ABORT_MAXMUMS: --maxmums 30)
    sends the input to the per-level frontier on the same device, the
    reference's route: it finishes with the JAX package's host-engine
    node state, the decline recorded in both LAST_STATS and the host
    engine never called (the name is from when such inputs raised).  The
    card is stood in for: the loop and the frontier run on the CPU."""
    fastas = write_population(tmp_path, 4, 4000, 9, None)
    G, _idx = jax_rem.align_genomes(fastas, backend="auto", maxmums=30)
    want = _node_state(G)
    G, _idx = port_rem.align_genomes(fastas, device="cuda", maxmums=30)
    assert devloop_multi.LAST_STATS["abort"] == devloop.ABORT_MAXMUMS
    why = devloop_multi.LAST_STATS["fallback"]
    assert why == "kernel abort code 7 (ABORT_MAXMUMS)"
    assert stood_in_card.LAST_STATS["fallback"] == why
    assert stood_in_card.LAST_STATS["levels"] > 1
    assert _node_state(G) == want


@pytest.mark.parametrize("maxmums", [10000, 30])
def test_align_seqs_on_cuda_never_runs_the_host_engine(
        tmp_path, stood_in_card, no_host_engine, maxmums):
    """``align_seqs(aobjs, device="cuda")`` runs the multi loop on the
    card and nothing else: the GFA of the JAX package's host engine with
    the port's host engine never called; a decline (``maxmums`` 30) runs
    the frontier on the card, with the host engine's node state.  The
    card is stood in for: the loop and the frontier run on the CPU."""
    aobjs = _population(4, 3000, 11)
    G, idx = jax_rem.align_seqs(aobjs, minlength=20, maxmums=maxmums,
                                frontier=False)
    want_state = _node_state(G)
    want = jax_gfa(G, idx, str(tmp_path / "host.gfa"))
    stood_in_card.LAST_STATS.clear()
    G, idx = port_rem.align_seqs(aobjs, minlength=20, maxmums=maxmums,
                                 device="cuda")
    if maxmums < 10000:
        assert "ABORT_MAXMUMS" in stood_in_card.LAST_STATS["fallback"]
        assert _node_state(G) == want_state
        return
    _assert_engaged()
    assert not stood_in_card.LAST_STATS
    assert port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa")) == want


def test_decline_finishes_on_the_host_engine_on_the_cpu(tmp_path,
                                                        monkeypatch):
    """On the CPU the same decline finishes on the frontier (the name is
    from when it finished on the host engine): the JAX package's
    ``DeviceFrontier`` GFA byte for byte, the host engine's node state,
    the code recorded."""
    from reveal_tpu_torch.index import devfrontier

    fastas = write_population(tmp_path, 4, 4000, 9, None)
    G, _idx = jax_rem.align_genomes(fastas, backend="auto", maxmums=30)
    want_state = _node_state(G)
    monkeypatch.setenv("REVEAL_TPU_DISABLE_DEVLOOP", "1")
    G, idx = jax_rem.align_genomes(fastas, backend="auto", maxmums=30,
                                   frontier=True)
    want = jax_gfa(G, idx, str(tmp_path / "jax.gfa"))
    G, idx = port_rem.align_genomes(fastas, device="cpu", maxmums=30)
    st = devloop_multi.LAST_STATS
    assert st["abort"] == devloop.ABORT_MAXMUMS
    assert st["fallback"] == "kernel abort code 7 (ABORT_MAXMUMS)"
    assert devfrontier.LAST_STATS["fallback"] == st["fallback"]
    assert _node_state(G) == want_state
    assert port_rem.write_rem_gfa(G, idx, str(tmp_path / "port.gfa")) == want


def test_more_than_eight_paths_is_declined(tmp_path, stood_in_card,
                                           no_host_engine):
    """Nine paths are past the loop's width: on a CUDA device the loop
    declines before any tensor moves and the input takes the frontier
    on the card, with the JAX package's host-engine node state.  The
    card is stood in for: the frontier runs on the CPU."""
    fastas = write_population(tmp_path, 8, 1500, 10, 3)
    G, _idx = jax_rem.align_genomes(fastas, backend="auto")
    want = _node_state(G)
    G, _idx = port_rem.align_genomes(fastas, device="cuda")
    assert devloop_multi.LAST_STATS == {"fallback": devloop_multi.LAST_STATS[
        "fallback"]}
    assert "not eligible" in stood_in_card.LAST_STATS["fallback"]
    assert _node_state(G) == want
