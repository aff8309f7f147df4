"""Mesh ``rem`` across processes, and the port's multichip dry run.

(d) The two-process runs of ``tests/test_distributed.py``
(``test_two_host_full_rem``: a 60 kbp pair from seed 3;
``test_two_host_multi_rem``: three genomes of 30 kbp from seed 9) as two
processes that join one gloo group through ``init_distributed`` (a
``file://`` address) and run ``align_genomes(..., mesh=global_mesh())``.
Both ranks must print the same node-state hash, and it must equal the
port's single-process per-level frontier's; for the pair also the JAX
host engine's, for the three genomes the JAX mesh route's on 8 virtual
devices (the JAX single-device route of that test dies on its reference
defect, ``segstart``).

(e) ``python -m reveal_tpu_torch.parallel.dryrun --ranks 4 --device cpu``
(a world of 4 processes) passes its five checks on every rank; without a
card the mesh entry points raise unless the CPU is named, and a device
that contradicts the mesh's raises.
"""

import hashlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from reveal_tpu_torch.align import rem as port_rem
from reveal_tpu_torch.core.io_fasta import fasta_writer
from reveal_tpu_torch.index import devfrontier
from reveal_tpu_torch.parallel import dryrun
from reveal_tpu_torch.parallel.distributed import World
from reveal_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _mutate(rng, seq, count):
    """``tests/test_distributed.py``'s mutation: half substitutions, a
    quarter deletions, a quarter insertions."""
    mut = list(seq)
    for _ in range(count):
        i = int(rng.integers(0, len(mut)))
        r = rng.random()
        if r < 0.5:
            mut[i] = "ACGT"[int(rng.integers(0, 4))]
        elif r < 0.75:
            del mut[i]
        else:
            mut.insert(i, "ACGT"[int(rng.integers(0, 4))])
    return "".join(mut)


def pair_3(d):
    rng = np.random.default_rng(3)
    base = "".join(rng.choice(list("ACGT"), size=60_000))
    fas = [str(d / "a.fa"), str(d / "b.fa")]
    fasta_writer(fas[0], [("a", base)])
    fasta_writer(fas[1], [("b", _mutate(rng, base, 300))])
    return fas


def three_9(d):
    rng = np.random.default_rng(9)
    base = "".join(rng.choice(list("ACGT"), size=30_000))
    fas = []
    for s in range(3):
        fa = str(d / ("m%d.fa" % s))
        fasta_writer(fa, [("m%d" % s, _mutate(rng, base, 150))])
        fas.append(fa)
    return fas


def state_hash(state):
    norm = [(tuple(int(x) for x in n),
             tuple((int(k), int(v)) for k, v in offs), int(al))
            for n, offs, al in state]
    return hashlib.sha256(repr(norm).encode()).hexdigest()


def _jax_state(G):
    return sorted(
        (n, tuple(sorted(G.nodes[n]["offsets"].items())),
         G.nodes[n].get("aligned", 0))
        for n in G.nodes if isinstance(n, tuple))


WORKER = textwrap.dedent(
    """
    import hashlib, sys
    sys.path.insert(0, %(root)r)
    import torch
    from reveal_tpu_torch.align.rem import align_genomes, node_state
    from reveal_tpu_torch.parallel.distributed import (global_mesh,
                                                       init_distributed)

    me = int(sys.argv[1])
    torch.set_num_threads(1)
    init_distributed(%(address)r, 2, me, device="cpu")
    G, idx = align_genomes(%(fastas)r, mesh=global_mesh("cpu"))
    norm = [(tuple(int(x) for x in n),
             tuple((int(k), int(v)) for k, v in offs), int(al))
            for n, offs, al in node_state(G)]
    h = hashlib.sha256(repr(norm).encode()).hexdigest()
    t = hashlib.sha256(idx.main.T.tobytes()).hexdigest()
    print("OK process", me, h, t)
    """
)


def _two_processes(tmp_path, fastas):
    """The node-state and text hashes both ranks printed."""
    script = WORKER % {"root": REPO, "fastas": fastas,
                       "address": "file://%s" % (tmp_path / "store")}
    fn = tmp_path / "worker.py"
    fn.write_text(script)
    procs = [subprocess.Popen([sys.executable, str(fn), str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "process %d failed:\n%s" % (i, out)
        line = [ln for ln in out.splitlines() if ln.startswith("OK process")]
        assert len(line) == 1 and line[0].split()[2] == str(i), out
        got.append(tuple(line[0].split()[3:]))
    return got


def _single_process(fastas):
    """The port's single-device per-level frontier on the CPU: (node
    state hash, text hash)."""
    ts, t, G, root_nodes = port_rem._read_inputs(fastas)
    idx = port_rem.ESAIndex.construct(ts, backend="native")
    idx.nodes = root_nodes
    port_rem._align_loop_frontier(G, t, idx, port_rem.PickerConfig(), CPU)
    return (state_hash(port_rem.node_state(G)),
            hashlib.sha256(idx.main.T.tobytes()).hexdigest())


def test_two_process_full_rem(tmp_path):
    from reveal_tpu.align.rem import align_genomes as jax_align

    fas = pair_3(tmp_path)
    got = _two_processes(tmp_path, fas)
    want = _single_process(fas)
    assert got[0] == got[1] == want
    Gh, _ = jax_align(fas, backend="np")
    assert state_hash(_jax_state(Gh)) == want[0]


def test_two_process_multi_rem(tmp_path):
    from reveal_tpu.align.rem import align_genomes as jax_align
    from reveal_tpu.parallel.mesh import make_mesh as jax_make_mesh

    fas = three_9(tmp_path)
    got = _two_processes(tmp_path, fas)
    want = _single_process(fas)
    assert got[0] == got[1] == want
    Gm, _ = jax_align(fas, backend="np", mesh=jax_make_mesh(8))
    assert state_hash(_jax_state(Gm)) == want[0]


def test_dryrun_in_a_world_of_4():
    out = subprocess.run(
        [sys.executable, "-m", "reveal_tpu_torch.parallel.dryrun",
         "--ranks", "4", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("rank ")]
    assert len(lines) == 4
    for r, line in enumerate(lines):
        assert line.startswith("rank %d: dryrun_multichip ok: ranks=4 " % r)
        assert line.split(": ", 1)[1] == lines[0].split(": ", 1)[1]
        assert ("sharded-rem-graph=match(synthetic) multi3-mesh-rem=match"
                in line)


def test_dryrun_needs_a_card_unless_the_cpu_is_named(tmp_path,
                                                      monkeypatch):
    out = subprocess.run(
        [sys.executable, "-m", "reveal_tpu_torch.parallel.dryrun"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "is_available" in out.stderr
    assert "dryrun_multichip ok" not in out.stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fas = pair_3(tmp_path)
    for call in (make_mesh, dryrun.dryrun_on_world,
                 lambda: port_rem.rem_on_world(fas),
                 lambda: World(2, "file://%s" % (tmp_path / "store"))):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    mesh = make_mesh(1, "cpu")
    with pytest.raises(ValueError, match="contradicts"):
        port_rem.align_genomes(fas, mesh=mesh, device="cuda")
    with pytest.raises(ValueError, match="contradicts"):
        port_rem.align_seqs([("a", "ACGT"), ("b", "ACGA")], mesh=mesh,
                            device="cuda:0")
    with pytest.raises(ValueError, match="checkpoint"):
        port_rem.align_genomes(fas, mesh=mesh,
                               checkpoint=str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="contradicts"):
        devfrontier.DeviceFrontier(np.zeros(2, np.uint8), [0, 1], [0, 0],
                                   [0, 0], 0, 2, "cuda", mesh=mesh)
