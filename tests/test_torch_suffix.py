"""The port's device doubling build (``build_esa(T, "jax")``) on the CPU.

``reveal_tpu_torch.index.suffix.build_esa_device`` is held exactly (SA,
LCP, SAi) against ``reveal_tpu``'s ``build_esa_jax`` on CPU JAX, and
against the port's native SA-IS + Kasai and numpy doubling builds, on
seeded multi-sample texts with 'N' runs, lowercase and '$', the edge
cases of the padding (n = 0, 1, 2, exact powers of two), a text that
needs every doubling round (``A`` x 1,000) and texts that finish early,
the int64 variant against the int32 one, and a hypothesis property over
short texts.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from reveal_tpu.index.suffix import build_esa_jax
from reveal_tpu_torch.core.textstore import TextStore
from reveal_tpu_torch.index import suffix
from reveal_tpu_torch.index.esa_index import ESAIndex
import torch_support  # noqa: F401  (the thread budget)


def _bytes(s):
    return np.frombuffer(s, dtype=np.uint8).copy()


def _sample_text(seed, nsamples, length, lower=False, nruns=0):
    """``nsamples`` related sequences, each closed by '$' as TextStore
    closes them, with ``nruns`` runs of 'N' and (``lower``) lowercase
    stretches."""
    rng = np.random.default_rng(seed)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=length)
    parts = []
    for _ in range(nsamples):
        seq = base.copy()
        for i in rng.integers(0, length, size=length // 50):
            seq[i] = rng.choice(np.frombuffer(b"ACGT", np.uint8))
        for i in rng.integers(0, length - 12, size=nruns):
            seq[i: i + int(rng.integers(1, 12))] = ord("N")
        if lower:
            i = int(rng.integers(0, length - 40))
            seq[i: i + 40] += ord("a") - ord("A")
        parts += [seq, _bytes(b"$")]
    return np.concatenate(parts)


TEXTS = {
    "empty": np.zeros(0, np.uint8),
    "one": _bytes(b"A"),
    "two": _bytes(b"AC"),
    "dollar": _bytes(b"$"),
    "pow2_4": _bytes(b"AAAA"),
    "pow2_64": _sample_text(5, 1, 63),
    "pow2_1024": _bytes(b"ACGT" * 256),
    "banana": _bytes(b"BANANA$"),
    "lowercase": _bytes(b"acgtACGTacgtNNacgt$ACGTacgt$"),
    "n_runs": _bytes(b"ACNNNNNNNNGT$ACNNNNGT$NNNN$"),
    "dollars": _bytes(b"A$$$C$$G$"),
    "all_a": _bytes(b"A" * 1000),
    "samples_3x300": _sample_text(1, 3, 300, nruns=3),
    "samples_5x700_lower": _sample_text(2, 5, 700, lower=True, nruns=4),
    "samples_2x1500": _sample_text(3, 2, 1500, lower=True),
    "random_1000": _bytes(
        np.random.default_rng(4).choice(list(b"ACGTN$acgt"), 1000)
        .astype(np.uint8).tobytes()),
}


def _equal(got, want):
    assert len(got) == len(want) == 3
    for g, w, name in zip(got, want, ("SA", "LCP", "SAi")):
        assert g.dtype == np.int64, name
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_device_build_equals_build_esa_jax(name):
    T = TEXTS[name]
    got = suffix.build_esa(T, "jax", device="cpu")
    _equal(got, build_esa_jax(T))
    _equal(got, suffix.build_esa(T, "np"))
    if len(T):
        _equal(got, suffix.build_esa(T, "native"))
        assert suffix.sufcheck(T, got[0])


@pytest.mark.parametrize("name", ["banana", "pow2_1024", "all_a",
                                  "samples_5x700_lower", "random_1000"])
def test_force64_equals_int32(name):
    T = TEXTS[name]
    got = suffix.build_esa_device(T, torch.device("cpu"), force64=True)
    assert suffix.LAST_STATS["int64"]
    _equal(got, suffix.build_esa_device(T, torch.device("cpu")))
    assert not suffix.LAST_STATS["int64"]
    _equal(got, build_esa_jax(T, force64=True))


def test_rounds_stop_early_or_run_to_the_end():
    """``A`` x 1,000 (npad 1,024) needs all ten doubling rounds; a random
    text of the same size is done after a few, and the LCP descent over
    the levels it kept gives the JAX build's LCP."""
    suffix.build_esa(TEXTS["all_a"], "jax", device="cpu")
    assert suffix.LAST_STATS["npad"] == 1024
    assert suffix.LAST_STATS["rounds"] == 10
    T = _sample_text(6, 1, 999)
    got = suffix.build_esa(T, "jax", device="cpu")
    assert suffix.LAST_STATS["rounds"] < 10
    _equal(got, build_esa_jax(T))


def test_jax_dist_raises_and_no_card_raises(monkeypatch):
    """``'jax-dist'`` (once unported, hence the name) builds over a world
    of one on the device named, the arrays of the JAX package's
    distributed build on its 8-device mesh; the device builds without a
    device named go to the card, and without a card they raise."""
    from reveal_tpu.index.suffix import build_esa as jax_build_esa

    monkeypatch.delenv("REVEAL_TPU_DSA_LCP_STRIDE", raising=False)
    for name in ("banana", "samples_5x700_lower"):
        T = TEXTS[name]
        _equal(suffix.build_esa(T, "jax-dist", device="cpu"),
               jax_build_esa(T, "jax-dist"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        suffix.build_esa(TEXTS["banana"], "jax-dist")
    with pytest.raises(RuntimeError, match="is_available"):
        suffix.build_esa(TEXTS["banana"], "jax")
    with pytest.raises(RuntimeError, match="is_available"):
        suffix.build_esa(TEXTS["banana"], "jax", device="cuda")


def test_esa_index_construct_on_a_device():
    ts = TextStore()
    for i, seq in enumerate(("ACGTTGCAacgtNNNACGT" * 20, "ACGTAGCA" * 30)):
        ts.add_sample("s%d" % i)
        ts.add_sequence(seq)
    dev = ESAIndex.construct(ts, backend="jax", device="cpu")
    nat = ESAIndex.construct(ts, backend="native")
    assert np.array_equal(dev.main.T, nat.main.T)
    for a, b in ((dev.SA, nat.SA), (dev.LCP, nat.LCP),
                 (dev.main.SAi, nat.main.SAi)):
        assert np.array_equal(a, b)


@settings(max_examples=60, deadline=None)
@given(st.binary(min_size=0, max_size=70).map(
    lambda b: bytes(b"ACGTN$ag"[x % 8] for x in b)))
def test_device_build_property(s):
    T = _bytes(s) if s else np.zeros(0, np.uint8)
    got = suffix.build_esa(T, "jax", device="cpu")
    _equal(got, suffix.build_esa(T, "np"))
    _equal(got, build_esa_jax(T))
