"""The torch port's pair-HMM (plain versions, on the CPU) against the JAX
package's: the Pallas kernels in interpret mode, the float64 oracle and
the XLA row-scan; the posterior cut against the host's sparsify and MEA
DP; and the parameters carried across.

The same numpy-seeded sequences go through both packages.  Tolerances:
the port's plain DP follows the Pallas kernels' formulas (same lse
guards, same doubling scan), so posteriors agree to float32 rounding
(1e-4, totals 1e-3); against float64 and against the row-scan's
different float32 formulation the gates are those of
tests_tpu/test_pallas_hw.py (2e-3 posteriors, 5e-2 totals).
"""

import numpy as np
import pytest
import torch

import reveal_tpu.hmm.msa as jax_msa
import reveal_tpu.hmm.pairhmm as jax_pairhmm
import reveal_tpu.hmm.pallas_pairhmm as jax_pallas
from reveal_tpu_torch.hmm import msa as port_msa
from reveal_tpu_torch.hmm import pairhmm as port_pairhmm
from reveal_tpu_torch.hmm import pairhmm_dp as dp

torch.set_num_threads(2)


def _seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), size=n))


def _mutate(rng, s, rate=0.12):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate:
            out.append(str(rng.choice(list("ACGT"))))
        elif r < rate + 0.02:
            continue
        elif r < rate + 0.04:
            out.append(ch + str(rng.choice(list("ACGT"))))
        else:
            out.append(ch)
    return "".join(out) or "A"


def _pairs8():
    """B = 8, lengths 1..60 mixed, with N, lowercase and a padded entry
    (the batch padding of the JAX package: the pair "A", "A")."""
    rng = np.random.default_rng(11)
    a = _seq(rng, 60)
    b = _seq(rng, 41)
    c = _seq(rng, 33)
    return [
        (a, _mutate(rng, a)[:64]),
        (b[:20] + "NN" + b[22:], _mutate(rng, b)),
        (c.lower(), _mutate(rng, c)),
        ("A", "ACGTTGCA"),
        ("ACGTACGTAC", "C"),
        (_seq(rng, 17), _seq(rng, 52)),
        (b[:30], b[:12].lower() + "N" + b[13:30]),
        ("A", "A"),
    ]


def _padded(pairs, L1p, L2p):
    x = np.stack([port_pairhmm._pad_with_dummy(a.encode(), L1p - 1)
                  for a, _ in pairs])
    y = np.stack([port_pairhmm._pad_with_dummy(b.encode(), L2p - 1)
                  for _, b in pairs])
    lx = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    ly = np.array([len(b) for _, b in pairs], dtype=np.int32)
    return x, y, lx, ly


@pytest.fixture(scope="module")
def pallas_interpret():
    """The JAX package's Pallas posterior under the TPU interpret mode,
    on x, y, lx, ly numpy arrays."""
    from jax.experimental.pallas import tpu as pltpu

    fn = jax_pallas._get_pallas_kernels()

    def run(x, y, lx, ly):
        with pltpu.force_tpu_interpret_mode():
            p, tot = fn(x, y, lx, ly)
        return np.asarray(p), np.asarray(tot)

    return run


def test_posterior_batch_matches_pallas_interpret(pallas_interpret):
    pairs = _pairs8()
    x, y, lx, ly = _padded(pairs, 65, 128)
    pj, tj = pallas_interpret(x, y, lx, ly)
    pt, tt = dp.posterior_batch(*(torch.from_numpy(v) for v in
                                  (x, y, lx, ly)))
    assert pt.shape == pj.shape == (8, 65, 128)
    assert np.abs(pt.numpy() - pj).max() < 1e-4
    assert np.abs(tt.numpy() - tj).max() < 1e-3


def test_fwd_bwd_plain_grids_match_float64_dp():
    """The forward M grid with its row-lx snapshot and the backward grid
    in forward coordinates, cell by cell against the float64 scalar DP
    (the Pallas grids themselves stay inside the JAX package's jitted
    posterior; its posterior and total are held in the test above)."""
    pairs = _pairs8()
    params = port_pairhmm.default_params()
    x, y, lx, ly = (torch.from_numpy(v) for v in _padded(pairs, 65, 128))
    xcls, ycls = dp._prep(x, y)
    m, snap = dp.fwd_dp_plain(xcls, ycls, lx, params)
    xr, yr = dp._prep(dp._reverse_within(x, lx), dp._reverse_within(y, ly))
    g = dp.bwd_dp_plain(xr, yr, params)
    b0 = dp.flip_within(g, lx, ly)
    for k, (s1, s2) in enumerate(pairs):
        f64 = jax_pairhmm.forward_np(s1, s2)
        b64 = jax_pairhmm.backward_np(s1, s2)
        l1, l2 = len(s1), len(s2)
        real = f64[0] > jax_pairhmm.LOG_ZERO / 2
        got = m[k, : l1 + 1, : l2 + 1].numpy()
        assert np.abs(got[real] - f64[0][real]).max() < 1e-3
        assert (got[~real] <= jax_pairhmm.LOG_ZERO / 2).all()
        for s in range(5):
            assert abs(float(snap[k, s, l2]) - f64[s, l1, l2]) < 1e-3 or (
                f64[s, l1, l2] <= jax_pairhmm.LOG_ZERO / 2
                and float(snap[k, s, l2]) <= jax_pairhmm.LOG_ZERO / 2
            )
        gotb = b0[k, : l1 + 1, : l2 + 1].numpy()
        assert np.abs(gotb - b64[0]).max() < 1e-3


def test_wrappers_take_plain_path_on_cpu():
    pairs = _pairs8()[:3]
    params = port_pairhmm.default_params()
    x, y, lx, ly = (torch.from_numpy(v) for v in _padded(pairs, 65, 128))
    xcls, ycls = dp._prep(x, y)
    before = dict(dp.LAUNCHES)
    m_w, s_w = dp.fwd_dp(xcls, ycls, lx, params)
    m_p, s_p = dp.fwd_dp_plain(xcls, ycls, lx, params)
    assert torch.equal(m_w, m_p) and torch.equal(s_w, s_p)
    g_w = dp.bwd_dp(xcls, ycls, lx, ly, params)
    g_p = dp.flip_within(dp.bwd_dp_plain(xcls, ycls, params), lx, ly)
    assert torch.equal(g_w, g_p)
    assert dp.LAUNCHES == before  # CPU tensors launch nothing
    with pytest.raises(TypeError):
        dp.fwd_dp(xcls.int(), ycls, lx, params)
    with pytest.raises(TypeError):
        dp.fwd_dp(xcls, ycls, lx.long(), params)


@pytest.mark.parametrize("k", range(8))
def test_posterior_matches_float64_oracle(k):
    s1, s2 = _pairs8()[k]
    (p, tot), = dp.batch_posteriors_dp([(s1, s2)], "cpu")
    po, to = jax_pairhmm.posterior_oracle(s1, s2)
    assert p.shape == po.shape
    assert np.abs(p - po).max() < 2e-3
    assert abs(tot - to) < 1e-3


def test_posterior_matches_xla_row_scan_at_length_200():
    rng = np.random.default_rng(5)
    a = _seq(rng, 200)
    pairs = [(a, _mutate(rng, a)[:256]), (_seq(rng, 180), _seq(rng, 140))]
    res_j = jax_pairhmm.batch_posteriors(pairs)
    res_t = dp.batch_posteriors_dp(pairs, "cpu")
    for (pj, tj), (pt, tt) in zip(res_j, res_t):
        assert pj.shape == pt.shape
        assert np.abs(np.asarray(pj) - pt).max() < 2e-3
        assert abs(tj - tt) < 5e-2


def test_batch_posteriors_dp_matches_pallas_bucketing(pallas_interpret):
    """Pairs of two buckets in one call come back in input order, each
    equal to the Pallas result of its own bucket."""
    rng = np.random.default_rng(3)
    pairs = [(_seq(rng, 12), _seq(rng, 9)), (_seq(rng, 30), _seq(rng, 28)),
             (_seq(rng, 5), _seq(rng, 16))]
    res = dp.batch_posteriors_dp(pairs, "cpu")
    for (s1, s2), (p, tot) in zip(pairs, res):
        L1p, L2p = dp.bucket_key(s1, s2)
        assert (L1p, L2p) == (jax_pairhmm._bucket(len(s1)) + 1,
                              jax_pallas._round_up(
                                  jax_pairhmm._bucket(len(s2)) + 1, 128))
        batch = [(s1, s2)] + [("A", "A")] * 7
        pj, tj = pallas_interpret(*_padded(batch, L1p, L2p))
        assert np.abs(p - pj[0, : len(s1) + 1, : len(s2) + 1]).max() < 1e-4
        assert abs(tot - float(tj[0])) < 1e-3


def test_cut_matches_host_sparsify_and_mea():
    """Counts, survivors and MEA score of the port's cut against
    msa._sparsify and msa._mea_dp_fast of the same dense matrix."""
    rng = np.random.default_rng(9)
    a = _seq(rng, 90)
    pairs = [(a, _mutate(rng, a)[:128]), (_seq(rng, 70), _seq(rng, 100)),
             ("ACGT", "ACGT")]
    dense = dp.batch_posteriors_dp(pairs, "cpu")
    cut = port_msa.batch_posteriors_cut(pairs, device="cpu")
    for (p, tot), (sp, tot_c, score) in zip(dense, cut):
        want = jax_msa._sparsify(p)
        assert isinstance(sp, port_msa.SparsePost)
        assert np.array_equal(sp.dense(), want)
        assert np.array_equal(sp.cnt, (want > 0).sum(axis=1))
        assert sp.nnz == int((want > 0).sum())
        assert tot_c == tot
        ref = jax_msa._mea_dp_fast(p)[1]
        assert abs(score - ref) <= 1e-5 * max(1.0, abs(ref))


def test_cut_ladder_holds_a_diffuse_row():
    """More than 8 survivors in a row take the next step of the K
    ladder; the survivors stay exact."""
    p = torch.zeros((1, 3, 128))
    p[0, 1, 1:21] = 0.04
    p[0, 2, 5] = 0.5
    v, i, cnt, tot, scores = port_pairhmm.fetch_posteriors_compact(
        p, torch.zeros(1))
    assert v.shape[-1] == 32 and cnt[0].tolist() == [0, 20, 1]
    assert sorted(i[0, 1, :20].tolist()) == list(range(1, 21))
    assert i[0, 2, 0] == 5 and (i[0, 2, 1:] == 0).all()


def test_params_from_numpy_equals_default():
    got = port_pairhmm.params_from_numpy(
        jax_pairhmm.LOG_INIT, jax_pairhmm.LOG_TRANS,
        jax_pairhmm.LOG_EMIT_SINGLE, jax_pairhmm.LOG_EMIT_PAIRS)
    want = port_pairhmm.default_params()
    for name in ("init", "trans", "single", "pair", "packed"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert np.array_equal(got.single.numpy(), jax_pallas._CLS_SINGLE)
    assert np.array_equal(got.pair.numpy(), jax_pallas._CLS_PAIR)
    assert np.array_equal(dp._CLS.astype(np.int32), jax_pallas._CLS)
    assert np.array_equal(port_pairhmm.LOG_TRANS, jax_pairhmm.LOG_TRANS)
    assert got.packed.numel() == 102


# ---------------------------------------------------------------------------
# the CUDA kernels' evaluation order, emulated in numpy
# ---------------------------------------------------------------------------
# The kernels of csrc/pairhmm_dp.cu compute every cell from its three
# neighbours and run the in-row recurrence of the y inserts in sequence
# (no doubling scan).  The emulation does the same arithmetic, vectorised
# over antidiagonals (the cells of one antidiagonal are independent), in
# the dtype given: float64 is the reference, float32 shows the drift of
# that order before any run on a card.

def _np_lse2(x, y):
    m = np.maximum(x, y)
    return m + np.log1p(np.exp(np.minimum(x, y) - m))


def _np_lse5(terms, neg):
    m = terms[0]
    for v in terms[1:]:
        m = np.maximum(m, v)
    s = sum(np.exp(v - m) for v in terms)
    return np.where(m <= neg / 2, neg, m + np.log(s))


def _np_chain(a, zhi, zlo, c):
    """One step Z = lse(a, Z + c) of the y-insert recurrence as the
    kernels take it: Z is carried as hi + lo, the roundings of Z + c and
    of max + log1p(.) go into lo (Fast2Sum: the first addend is the
    larger), so a run of a thousand steps that add the same constant does
    not drift by a thousand half-ulps."""
    th = zhi + c
    tl = (c - (th - zhi)) + zlo
    m = np.maximum(a, th)
    q = np.log1p(np.exp(np.minimum(a, th) - m)) + np.where(th >= a, tl, 0)
    r = m + q
    return r, q - (r - m)


def _emulate_dp(s1, s2, dtype, grids=False):
    """Posterior (l1+1, l2+1) and total of one pair in the kernels'
    order, every operation in ``dtype``; with ``grids`` the forward M
    grid and the backward grid in forward coordinates instead."""
    par = port_pairhmm.default_params()
    li = par.init.numpy().astype(dtype)
    lt = par.trans.numpy().astype(dtype)
    single = par.single.numpy().astype(dtype)
    pair = par.pair.numpy().astype(dtype)
    neg = dtype(dp.LOG_ZERO)
    l1, l2 = len(s1), len(s2)

    def classes(s):
        return dp._CLS[port_pairhmm._pad_with_dummy(s.encode(), len(s))]

    def diagonals():
        for d in range(l1 + l2 + 1):
            i = np.arange(max(0, d - l2), min(l1, d) + 1)
            yield i, d - i

    # forward; arrays carry a border of LOG_ZERO at index 0 (cell -1)
    xc, yc = classes(s1), classes(s2)
    f = np.full((5, l1 + 2, l2 + 2), neg, dtype=dtype)
    flo = np.zeros((2, l1 + 2, l2 + 2), dtype=dtype)  # lo parts of Iy1, Iy2
    for i, j in diagonals():
        I, J = i + 1, j + 1
        em = pair[xc[i], yc[j]]
        e1 = single[xc[i]]
        e2 = single[yc[j]]
        m = em + _np_lse5([f[k, I - 1, J - 1] + lt[k, 0] for k in range(5)],
                          neg)
        m = np.where((i == 1) & (j == 1), li[0] + em, m)
        m = np.where((i == 0) | (j == 0), neg, m)
        ix1 = e1 + _np_lse2(f[0, I - 1, J] + lt[0, 1],
                            f[1, I - 1, J] + lt[1, 1])
        ix2 = e1 + _np_lse2(f[0, I - 1, J] + lt[0, 3],
                            f[3, I - 1, J] + lt[3, 3])
        first = (i == 1) & (j == 0)
        ix1 = np.where(first, li[1] + e1, ix1)
        ix2 = np.where(first, li[3] + e1, ix2)
        ix1 = np.where(i == 0, neg, ix1)
        ix2 = np.where(i == 0, neg, ix2)
        seed = (i == 0) & (j == 1)
        m_left = f[0, I, J - 1]
        a1 = np.where(seed, li[2] + e2, m_left + lt[0, 2] + e2)
        a2 = np.where(seed, li[4] + e2, m_left + lt[0, 4] + e2)
        iy1, lo1 = _np_chain(a1, f[2, I, J - 1], flo[0, I, J - 1],
                             e2 + lt[2, 2])
        iy2, lo2 = _np_chain(a2, f[4, I, J - 1], flo[1, I, J - 1],
                             e2 + lt[4, 4])
        iy1 = np.where(j == 0, neg, iy1)
        iy2 = np.where(j == 0, neg, iy2)
        flo[0, I, J] = np.where(j == 0, 0, lo1)
        flo[1, I, J] = np.where(j == 0, 0, lo2)
        for k, v in enumerate((m, ix1, iy1, ix2, iy2)):
            f[k, I, J] = v
    end = f[:, l1 + 1, l2 + 1] + li
    top = end.max()
    total = top + np.log(np.exp(end - top).sum())

    # backward on the reversed sequences
    xr = classes(s1[::-1])
    yr = classes(s2[::-1])
    g0 = np.full((l1 + 2, l2 + 2), neg, dtype=dtype)
    gx1, gx2, gy1, gy2 = (g0.copy() for _ in range(4))
    glo = np.zeros((2, l1 + 2, l2 + 2), dtype=dtype)
    for i, j in diagonals():
        I, J = i + 1, j + 1
        em = pair[xr[i], yr[j]]
        e1 = single[xr[i]]
        e2 = single[yr[j]]
        H = em + g0[I - 1, J - 1]
        x1 = _np_lse2(lt[1, 0] + H, lt[1, 1] + e1 + gx1[I - 1, J])
        x2 = _np_lse2(lt[3, 0] + H, lt[3, 3] + e1 + gx2[I - 1, J])
        origin = (i == 0) & (j == 0)
        a1 = np.where(j == 0, np.where(origin, li[2], neg), lt[2, 0] + H)
        a2 = np.where(j == 0, np.where(origin, li[4], neg), lt[4, 0] + H)
        y1, glo[0, I, J] = _np_chain(a1, gy1[I, J - 1], glo[0, I, J - 1],
                                     e2 + lt[2, 2])
        y2, glo[1, I, J] = _np_chain(a2, gy2[I, J - 1], glo[1, I, J - 1],
                                     e2 + lt[4, 4])
        g = _np_lse5([lt[0, 0] + H,
                      lt[0, 1] + e1 + gx1[I - 1, J],
                      lt[0, 3] + e1 + gx2[I - 1, J],
                      lt[0, 2] + e2 + gy1[I, J - 1],
                      lt[0, 4] + e2 + gy2[I, J - 1]], neg)
        g0[I, J] = np.where(origin, li[0], g)
        gx1[I, J] = np.where(origin, li[1], x1)
        gx2[I, J] = np.where(origin, li[3], x2)
        gy1[I, J] = y1
        gy2[I, J] = y2
    b0 = g0[1:, 1:][::-1, ::-1]
    p = np.exp(np.minimum(dtype(0), f[0, 1:, 1:] + b0 - total))
    p[0, :] = 0
    p[:, 0] = 0
    if grids:
        return f[0, 1:, 1:], b0
    return p, float(total)


def _related(rng, n):
    a = _seq(rng, n)
    return a, _mutate(rng, a)[:n]


@pytest.mark.parametrize("k", range(8))
def test_kernel_order_float64_equals_oracle(k):
    s1, s2 = _pairs8()[k]
    p, tot = _emulate_dp(s1, s2, np.float64)
    po, to = jax_pairhmm.posterior_oracle(s1, s2)
    assert p.shape == po.shape
    assert np.abs(p - po).max() < 1e-9
    assert abs(tot - to) < 1e-9


@pytest.mark.parametrize("n, seed", [(200, 21), (200, 22), (1000, 23),
                                      (1000, 24), (2000, 25)])
def test_kernel_order_float32_drift(n, seed, capsys):
    """The sequential in-row recurrence in float32 against the same order
    in float64 and against the plain torch version (doubling scan), within
    the port's gate max(2e-3, 4e-5 L)."""
    s1, s2 = _related(np.random.default_rng(seed), n)
    gate = max(2e-3, 4e-5 * max(len(s1), len(s2)))
    p64, t64 = _emulate_dp(s1, s2, np.float64)
    p32, t32 = _emulate_dp(s1, s2, np.float32)
    (pp, tp), = dp.batch_posteriors_dp([(s1, s2)], "cpu")
    e64 = float(np.abs(p32 - p64).max())
    eplain = float(np.abs(p32 - pp).max())
    eplain64 = float(np.abs(pp - p64).max())
    with capsys.disabled():
        print("\nkernel order, %d x %d bp: float32 vs float64 %.3e, vs the "
              "plain version %.3e (plain vs float64 %.3e), gate %.3e; "
              "totals %.6f %.6f %.6f"
              % (len(s1), len(s2), e64, eplain, eplain64, gate, t32, t64, tp))
    assert e64 < gate
    assert eplain < gate
    assert abs(t32 - t64) < 5e-2 * max(1.0, n / 500)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

_PLAN_L1P = [16 * 2 ** k + 1 for k in range(11)]            # 17 .. 16385
_PLAN_L2P = sorted({dp._round_up(16 * 2 ** k + 1, 128) for k in range(11)})


def test_plan_shapes_are_every_bucket():
    keys = {dp.bucket_key("A" * n, "C" * m)
            for n in (1, 16, 17, 100, 513, 5000, 10000)
            for m in (1, 16, 17, 100, 513, 5000, 10000)}
    assert {k[0] for k in keys} <= set(_PLAN_L1P)
    assert {k[1] for k in keys} <= set(_PLAN_L2P)
    assert _PLAN_L2P == [128, 256, 384, 640, 1152, 2176, 4224, 8320, 16512]


@pytest.mark.parametrize("B", [1, 2, 32, 128, 1024])
@pytest.mark.parametrize("L2p", _PLAN_L2P)
def test_launch_plan_is_launchable(L2p, B):
    for L1p in _PLAN_L1P:
        nb = min(B, dp.batch_size(L1p, L2p, "cuda"))
        plan = dp.launch_plan(nb, L1p, L2p)
        C, G, P = plan["C"], plan["G"], plan["P"]
        what = "%r for B=%d %dx%d" % (plan, nb, L1p, L2p)
        # every column in exactly one lane's strip
        cover = np.zeros(P * G * C, dtype=np.int32)
        for p in range(P):
            for t in range(G):
                j0 = (p * G + t) * C
                cover[j0: j0 + C] += 1
        assert len(cover) >= L2p and (cover[:L2p] == 1).all(), what
        assert C in dp.PLAN_COLUMNS and C <= dp.MAX_COLUMNS, what
        assert G in (1, 2, 4, 8, 16, 32), what
        assert plan["pairs_per_warp"] == 32 // G, what
        assert P == 1 or G == 32, what
        wpb = plan["warps_per_block"]
        assert wpb == 1 and plan["threads"] == 32 * wpb <= 1024, what
        assert plan["shared_bytes"] <= 232448, what
        # one warp a panel, or a warp for every 32 // G narrow pairs
        need = -(-nb // (32 // G)) if P == 1 else nb * P
        assert plan["blocks"] * wpb == need < 2 ** 31, what
        # the edge records stay a small share of the grid they serve
        for direction in ("fwd", "bwd"):
            words = dp.scratch_words(direction, nb, L1p, P)
            assert (words == 0) == (P == 1), what
            assert words * 4 <= 0.15 * nb * L1p * L2p * 4 + 64, what


def test_launch_plan_fills_the_card_at_small_batches():
    """The shapes the kernels are timed at: a pair is split over enough
    warps that the card's 528 schedulers have one each."""
    for B, L1p, L2p in ((128, 513, 640), (32, 2049, 2176)):
        plan = dp.launch_plan(B, L1p, L2p)
        assert plan["blocks"] * plan["warps_per_block"] >= 528
    plan = dp.launch_plan(1024, 17, 128)
    assert plan["P"] == 1 and plan["pairs_per_warp"] == 2


# The faster strip width at every shape that scripts/torch_pairhmm_tune.py
# plans timed on an NVIDIA H100 80GB HBM3 (700 W), forward and backward
# summed (the margins were 4% to 42%).
_MEASURED_BEST = [
    (128, 513, 640, 4),
    (32, 2049, 2176, 4),
    (960, 513, 640, 8),
    (120, 2049, 2176, 8),
    (60, 1025, 1152, 4),
    (1024, 17, 128, 8),
    (2, 65, 8320, 8),
    (64, 33, 2176, 8),
]


@pytest.mark.parametrize("B, L1p, L2p, C", _MEASURED_BEST)
def test_launch_plan_is_the_measured_best(B, L1p, L2p, C):
    plan = dp.launch_plan(B, L1p, L2p)
    assert plan["C"] == C, plan


def test_fwd_plain_masks_rows_beyond_lx():
    pairs = _pairs8()
    params = port_pairhmm.default_params()
    x, y, lx, ly = (torch.from_numpy(v) for v in _padded(pairs, 65, 128))
    xcls, ycls = dp._prep(x, y)
    m, _snap = dp.fwd_dp_plain(xcls, ycls, lx, params)
    for k in range(len(pairs)):
        assert (m[k, int(lx[k]) + 1:] == dp.LOG_ZERO).all()
        assert (m[k, 1: int(lx[k]) + 1, 1] > dp.LOG_ZERO / 2).all()
    with pytest.raises(ValueError):
        dp._scratch_tensor("fwd", dp.make_plan(2, 65, 130, 8), 2, 65, 130,
                           torch.device("cpu"))
