"""The port's multi-genome loop against the JAX package's own multi kernel,
with the kernel's one undefined name defined.

``_build_kernel_multi`` (reveal_tpu/index/devloop.py) raises NameError on
``segstart`` when it is traced.  Here its source is read, the pairwise
kernel's definition of that name (``segstart = SEG != shift1(SEG, -9)``,
devloop.py:1137) is added where the multi kernel has set the classes of a
level, and the result is executed as a module of its own: no file under
``reveal_tpu/`` changes.  Each case goes through the port's
``align_genomes`` on the CPU; the arguments its ``rem_device_multi`` was
called with go through the patched JAX ``rem_device_multi`` as well, and
the anchors in pop order, the output text, the level count and the JAX
package's counters must be equal.
"""

import pathlib
import types

import numpy as np
import pytest

import reveal_tpu.index.devloop as jax_devloop
from reveal_tpu.core.io_fasta import fasta_writer
from reveal_tpu.utils.simulate import simulate_population
from reveal_tpu_torch.align import rem as port_rem
from reveal_tpu_torch.index import devloop_multi
from test_devloop_multi import _genomes
import torch_support  # noqa: F401  (the thread budget)

# where the multi kernel has classified the slots of a level, and the
# line the pairwise kernel defines segstart with
_AFTER = "            cls = jnp.where(nsg < 0, 0, cls)\n"
_SEGSTART = "            segstart = SEG != shift1(SEG, -9)\n"
_COUNTERS = ("levels", "dispatches", "anchors", "abort", "trim_steps",
             "chain_steps", "repair_steps")


@pytest.fixture(scope="module")
def jax_multi():
    """The JAX package's devloop module with ``segstart`` defined."""
    src = pathlib.Path(jax_devloop.__file__).read_text()
    assert src.count(_AFTER) == 1 and "segstart = SEG" in src
    mod = types.ModuleType("reveal_tpu.index._devloop_segstart")
    mod.__package__ = "reveal_tpu.index"
    mod.__file__ = jax_devloop.__file__
    exec(compile(src.replace(_AFTER, _AFTER + _SEGSTART),
                 jax_devloop.__file__, "exec"), mod.__dict__)
    return mod


def _fastas(tmp_path, case):
    """Fasta files of a ``_genomes`` case, or of a population whose
    sample 0 is cut into two contigs (paths are then not samples)."""
    if case[0] == "genomes":
        records = [[(name, seq)] for name, seq in _genomes(*case[1:])]
    else:
        pop = simulate_population(*case[1:3], seed=case[3])
        records = []
        for i, (name, seq, _ids) in enumerate(pop):
            half = len(seq) // 2
            records.append([(name, seq)] if i else
                           [(name + "_1", seq[:half]),
                            (name + "_2", seq[half:])])
    fastas = []
    for i, recs in enumerate(records):
        fn = str(tmp_path / ("s%d.fa" % i))
        fasta_writer(fn, recs)
        fastas.append(fn)
    return fastas


@pytest.mark.parametrize("case", [("genomes", 3, 2000, 3, 4),
                                  ("split", 3, 3000, 6)],
                         ids=lambda c: "-".join(map(str, c)))
def test_multi_loop_equals_the_jax_kernel(tmp_path, monkeypatch, jax_multi,
                                          case):
    calls = []
    port_loop = devloop_multi.rem_device_multi

    def record(T, SA, LCP, path_ivs, path_samples, *rest, **kw):
        args = (T.copy(), SA.copy(), LCP.copy(), list(path_ivs),
                list(path_samples)) + rest
        res = port_loop(T, SA, LCP, path_ivs, path_samples, *rest, **kw)
        calls.append((args, kw, res, dict(devloop_multi.LAST_STATS)))
        return res

    monkeypatch.setattr(devloop_multi, "rem_device_multi", record)
    port_rem.align_genomes(_fastas(tmp_path, case), device="cpu")
    assert len(calls) == 1
    args, kw, (p_anchors, p_T, p_levels), p_stats = calls[0]
    assert len(set(args[4])) < len(args[4]) or case[0] == "genomes"
    got = jax_multi.rem_device_multi(*args, root_mums=kw["root_mums"])
    assert got is not None, dict(jax_multi.LAST_STATS)
    j_anchors, j_T, j_levels = got
    np.testing.assert_array_equal(np.asarray(p_anchors),
                                  np.asarray(j_anchors))
    np.testing.assert_array_equal(np.asarray(p_T), np.asarray(j_T))
    assert p_levels == j_levels
    assert ({k: p_stats[k] for k in _COUNTERS}
            == {k: jax_multi.LAST_STATS[k] for k in _COUNTERS})
    assert p_stats["abort"] == 0 and len(p_anchors) > 10
