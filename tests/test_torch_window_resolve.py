"""window_resolve (reveal_tpu_torch/index/window_resolve.py) on the CPU.

The port's wrapper takes its plain torch path for CPU tensors; it is held
against the JAX package's Pallas TPU kernel (run in TPU interpret mode)
and against a numpy brute force, with exact int32 equality.  The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reveal_tpu.index.devloop import _make_window_resolve
from reveal_tpu_torch.index import window_resolve as wr
import torch_support  # noqa: F401  (the thread budget)

WRV = 256


def brute(lcp, q, thr, wrv=WRV):
    out = np.full(len(q), -1, np.int32)
    for r, (qq, tt) in enumerate(zip(q.tolist(), thr.tolist())):
        for j in range(qq - 1, max(qq - wrv, 0) - 1, -1):
            if lcp[j] < tt:
                out[r] = j
                break
    return out


def edge_inputs(npad, rbv, seed):
    """Random LCP/q/thr with the edges planted at the front: q = 0,
    q < WRV, q = npad-1, q = npad, thr <= 0, windows with no hit."""
    rng = np.random.default_rng(seed)
    lcp = rng.integers(0, 60, size=npad, dtype=np.int32)
    hi0 = npad // 2
    lcp[hi0:hi0 + min(600, npad // 4)] = 500  # a block with no hit
    q = rng.integers(0, npad + 1, size=rbv, dtype=np.int32)
    thr = rng.integers(-3, 70, size=rbv, dtype=np.int32)
    edges = [
        (0, 30), (1, 30), (7, 30), (WRV - 1, 30), (WRV, 30), (WRV + 1, 30),
        (npad - 1, 30), (npad, 30), (npad // 3, 0), (npad // 3, -4),
        (hi0 + min(600, npad // 4), 500), (hi0 + 3, 501),
        (npad // 5, 2**31 - 1),
    ]
    for i, (qq, tt) in enumerate(edges[:rbv]):
        q[i], thr[i] = min(qq, npad), tt
    return lcp, q, thr


def port(lcp, q, thr, wrv=WRV):
    return wr.window_resolve(
        torch.from_numpy(lcp), torch.from_numpy(q), torch.from_numpy(thr),
        wrv,
    ).numpy()


@pytest.mark.parametrize("npad", [4096, 65536])
@pytest.mark.parametrize("rbv", [64, 1024])
def test_window_resolve_matches_pallas_kernel(npad, rbv):
    lcp, q, thr = edge_inputs(npad, rbv, seed=npad + rbv)
    with pltpu.force_tpu_interpret_mode():
        run = _make_window_resolve(WRV, rbv, npad)
        ref = np.asarray(
            jax.device_get(
                run(jnp.asarray(lcp), jnp.asarray(q), jnp.asarray(thr))
            )
        )
    got = port(lcp, q, thr)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, brute(lcp, q, thr))


@pytest.mark.parametrize("npad", [1, 2, 100, 383, 384, 1000])
def test_window_resolve_small_npad_brute_force(npad):
    # below the Pallas kernel's npad >= 384 / npad % 128 layout limits
    lcp, q, thr = edge_inputs(npad, 64, seed=npad)
    np.testing.assert_array_equal(port(lcp, q, thr), brute(lcp, q, thr))


@pytest.mark.parametrize("wrv", [1, 31, 300])
def test_window_resolve_other_window_widths(wrv):
    lcp, q, thr = edge_inputs(5000, 128, seed=wrv)
    np.testing.assert_array_equal(
        port(lcp, q, thr, wrv), brute(lcp, q, thr, wrv)
    )


def test_window_resolve_edges_by_hand():
    lcp = np.array([0, 5, 3, 9, 9, 9, 1, 9], np.int32)
    q = np.array([0, 1, 3, 6, 8, 8, 8, 6], np.int32)
    thr = np.array([9, 9, 4, 9, 2, 0, -1, 3], np.int32)
    # q=0: empty window; q=1: j=0; q=3: LCP[2]=3<4; q=6: j=5 9<9 no,
    # j=4 no, j=3 no, j=2 yes; q=8 thr=2: LCP[6]=1; thr<=0: none;
    # q=6 thr=3: only LCP[0]=0
    exp = np.array([-1, 0, 2, 2, 6, -1, -1, 0], np.int32)
    np.testing.assert_array_equal(port(lcp, q, thr, 8), exp)
    np.testing.assert_array_equal(port(lcp, q, thr, 2),
                                  np.array([-1, 0, 2, -1, 6, -1, -1, -1]))


def test_window_resolve_cpu_does_not_count_launches():
    before = wr.LAUNCHES
    lcp, q, thr = edge_inputs(4096, 64, seed=3)
    port(lcp, q, thr)
    assert wr.LAUNCHES == before


@pytest.mark.parametrize(
    "bad",
    ["dtype", "shape", "contiguity", "ndim", "wrv"],
)
def test_window_resolve_rejects_bad_inputs(bad):
    lcp = torch.zeros(1024, dtype=torch.int32)
    q = torch.arange(64, dtype=torch.int32)
    thr = torch.ones(64, dtype=torch.int32)
    wrv = WRV
    if bad == "dtype":
        lcp = lcp.long()
    elif bad == "shape":
        thr = thr[:63]
    elif bad == "contiguity":
        q = torch.arange(128, dtype=torch.int32)[::2]
    elif bad == "ndim":
        lcp = lcp.reshape(8, 128)
    else:
        wrv = 0
    with pytest.raises((TypeError, ValueError)):
        wr.window_resolve(lcp, q, thr, wrv)
