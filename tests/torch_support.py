"""What the port's CPU tests share: one thread budget, one launcher for
every subprocess that runs the port, and the inputs and comparisons that
more than one ``test_torch_*.py`` file uses.

pytest does not collect this module (its name does not start with
``test_``); test files import it from ``tests/``, which pytest puts on
``sys.path``.  At module level it imports neither jax nor reveal_tpu nor
the port: ``chip_smoke.py`` takes ``write_bubble_chain`` and ``diverge``
from here on a machine without JAX, and may import the port from another
checkout.
"""

import multiprocessing
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

# torch's intra-op threads for a test process and every process it
# starts: the machine's cores shared among pytest-xdist's workers
THREADS = max(1, (os.cpu_count() or 1)
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
# a rank of parallel.distributed.World imports test modules to run its
# calls, and keeps the one thread its server set
if multiprocessing.parent_process() is None:
    torch.set_num_threads(THREADS)


# ``python -c _BLOCKED <module> args...``: ``python -m <module> args...``
# in a process that cannot import jax or reveal_tpu, and fails if either
# got into sys.modules
_BLOCKED = """
import runpy, sys
BANNED = ("jax", "jaxlib", "reveal_tpu")
class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Blocked())
sys.argv = sys.argv[1:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
finally:
    leaked = [m for m in sys.modules if m.split(".")[0] in BANNED]
    if leaked:
        raise SystemExit("imported: %s" % leaked)
"""


def run_port(argv, *, blocked=False, cwd=None, timeout=600):
    """``python *argv`` with the repo on ``PYTHONPATH`` and ``THREADS``
    threads (``OMP_NUM_THREADS``, ``MKL_NUM_THREADS``); output captured
    as text.  With ``blocked``, ``argv`` is ``["-m", module, ...]`` and the
    module runs with jax and reveal_tpu blocked."""
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS),
               MKL_NUM_THREADS=str(THREADS))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    if blocked:
        if argv[0] != "-m":
            raise ValueError("a blocked run takes -m <module>: %r" % argv)
        argv = ["-c", _BLOCKED, *argv[1:]]
    return subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=timeout)


def run_ranks(script, n, *, timeout):
    """``run_port([script, rank])`` for ranks 0..n-1 at once (the ranks of
    one ``torch.distributed`` world); their results in rank order."""
    with ThreadPoolExecutor(n) as pool:
        return list(pool.map(
            lambda r: run_port([str(script), str(r)], timeout=timeout),
            range(n)))


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def write_population(tmp_path, n, length, seed, split=None):
    """``simulate_population(n, length, seed)`` as ``n`` fastas; the
    genome at index ``split`` as two contigs, its halves."""
    from reveal_tpu_torch.core.io_fasta import fasta_writer
    from reveal_tpu_torch.utils.simulate import simulate_population

    fastas = []
    for i, (name, seq, _ids) in enumerate(
            simulate_population(n, length, seed=seed)):
        fn = str(tmp_path / (name + ".fa"))
        half = len(seq) // 2
        fasta_writer(fn, [(name, seq)] if i != split else
                     [(name + "_1", seq[:half]), (name + "_2", seq[half:])])
        fastas.append(fn)
    return fastas


def _mutate(rng, seq, count, indels=True):
    """Half substitutions, half deletions (only substitutions without
    ``indels``)."""
    mut = list(seq)
    for _ in range(count):
        i = int(rng.integers(0, len(mut)))
        if not indels or rng.random() < 0.5:
            mut[i] = "ACGT"[int(rng.integers(0, 4))]
        else:
            del mut[i]
    return "".join(mut)


def _random(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def multicontig_pair(tmp_path):
    """tests/test_frontier.py's multi-contig pair."""
    from reveal_tpu_torch.core.io_fasta import fasta_writer

    rng = np.random.default_rng(9)
    c1 = _random(rng, 1500)
    c2 = _random(rng, 1200)
    m1 = _mutate(rng, c1, 15, indels=False)
    fa = [str(tmp_path / "m1.fa"), str(tmp_path / "m2.fa")]
    fasta_writer(fa[0], [("x1", c1), ("x2", c2)])
    fasta_writer(fa[1], [("y1", m1), ("y2", c2)])
    return fa


def repetitive_pair(tmp_path):
    """tests/test_frontier.py's repetitive pair (boundary repairs)."""
    from reveal_tpu_torch.core.io_fasta import fasta_writer

    rng = np.random.default_rng(23)
    unit = _random(rng, 120)
    base = unit * 12 + _random(rng, 2000)
    fa = [str(tmp_path / "r1.fa"), str(tmp_path / "r2.fa")]
    fasta_writer(fa[0], [("a", base)])
    fasta_writer(fa[1], [("b", _mutate(rng, base, 20, indels=False))])
    return fa


def four_genomes(tmp_path):
    """tests/test_frontier.py's four-genome input."""
    from reveal_tpu_torch.core.io_fasta import fasta_writer

    rng = np.random.default_rng(17)
    base = _random(rng, 3000)
    fa = []
    for k in range(4):
        fn = str(tmp_path / ("g%d.fa" % k))
        fasta_writer(fn, [("g%d" % k, _mutate(rng, base, 25))])
        fa.append(fn)
    return fa


def mutate(rng, seq, count):
    """tests/test_devloop.py's and tests/test_distributed.py's mutation:
    half substitutions, a quarter deletions, a quarter insertions."""
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


def devloop_case(name):
    """(seqa, seqb, minlength) of the tests/test_devloop.py cases."""
    if name.startswith("fuzz"):
        seed, n, nmut = (int(v) for v in name.split("-")[1:])
        rng = np.random.default_rng(seed)
        base = "".join(rng.choice(list("ACGT"), size=n))
        return base, mutate(rng, base, nmut), 20
    if name == "identical":
        rng = np.random.default_rng(11)
        s = "".join(rng.choice(list("ACGT"), size=800))
        return s, s, 20
    if name == "no_matches":
        return "A" * 400, "C" * 400, 20
    if name == "short_minlength":
        rng = np.random.default_rng(13)
        base = "".join(rng.choice(list("ACGT"), size=600))
        return base, mutate(rng, base, 12), 8
    # repetitive-N: tandem repeats longer than the repair window force
    # the deep whole-array resolve and the sequential repair branch
    seed = int(name.split("-")[1])
    rng = np.random.default_rng(seed)
    unit = "".join(rng.choice(list("ACGT"), size=40))
    base = (unit * 120) + "".join(rng.choice(list("ACGT"), size=1500))
    base += unit * 10
    return base, mutate(rng, base, 60), 20


def diverge(rng, seq, sub_rate, maxlen=None):
    """A copy of ``seq`` (uint8 array of ACGT) with ``sub_rate`` true
    substitutions and one indel of 1..12 bp per ~260 bp."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    code = np.searchsorted(bases, seq)
    hit = rng.random(len(seq)) < sub_rate
    code[hit] = (code[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    out = bytearray(bases[code].tobytes())
    for _ in range(len(seq) // 260 + 1):
        p = int(rng.integers(0, len(out)))
        ln = int(rng.integers(1, 13))
        if rng.random() < 0.5 and len(out) > 2 * ln:
            del out[p:p + ln]
        else:
            out[p:p] = bases[rng.integers(0, 4, ln)].tobytes()
    if maxlen is not None:
        del out[maxlen:]
    return bytes(out)


def write_bubble_chain(path, seed, n_small=64, small=500, n_big=8,
                       big=1900, npaths=6, flank=40, bubbles=None):
    """Write a GFA of a chain of bubbles between shared flank nodes,
    ``npaths`` paths, every bubble with one allele per path: each allele
    is its bubble's random ancestor with 5-7.5% substitutions (10-15%
    between two alleles) and indels of up to 12 bp.  Returns {path name:
    sequence}; a list given as ``bubbles`` receives the alleles of each
    bubble in path order."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    sizes = [small] * n_small + [big] * n_big
    order = rng.permutation(len(sizes))
    segs = []           # (id, sequence)
    links = []
    walks = [[] for _ in range(npaths)]
    seqs = [[] for _ in range(npaths)]
    nid = 0

    def add(seq):
        nonlocal nid
        nid += 1
        segs.append((nid, seq))
        return nid

    prev = add(bases[rng.integers(0, 4, flank)].tobytes().decode())
    for k in range(npaths):
        walks[k].append(prev)
        seqs[k].append(segs[-1][1])
    for bi in order:
        n = int(sizes[bi] * (0.94 + 0.06 * rng.random()))
        anc = bases[rng.integers(0, 4, n)].copy()
        alleles = []
        for k in range(npaths):
            rate = 0.05 + 0.025 * rng.random()
            alleles.append(add(diverge(rng, anc, rate).decode()))
        if bubbles is not None:
            bubbles.append([segs[a - 1][1] for a in alleles])
        sink_seq = bases[rng.integers(0, 4, flank)].tobytes().decode()
        sink = add(sink_seq)
        for k, a in enumerate(alleles):
            links.append((prev, a))
            links.append((a, sink))
            walks[k] += [a, sink]
            seqs[k] += [segs[a - 1][1], sink_seq]
        prev = sink
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        for i, s in segs:
            fh.write("S\t%d\t%s\n" % (i, s))
        for u, v in links:
            fh.write("L\t%d\t+\t%d\t+\t0M\n" % (u, v))
        for k in range(npaths):
            fh.write("P\tp%d\t%s\t%s\n" % (
                k, ",".join("%d+" % n for n in walks[k]),
                ",".join(["0M"] * (len(walks[k]) - 1))))
    return {"p%d" % k: "".join(seqs[k]) for k in range(npaths)}


GFA_REGION = """H\tVN:Z:1.0
S\t1\tAAAACC
S\t2\tGGTACGTAGGA
S\t3\tGGTACCTAGG
S\t4\tTTTTGG
L\t1\t+\t2\t+\t0M
L\t1\t+\t3\t+\t0M
L\t2\t+\t4\t+\t0M
L\t3\t+\t4\t+\t0M
P\tx\t1+,2+,4+\t0M
P\ty\t1+,3+,4+\t0M
"""

GFA_NO_BUBBLE = """H\tVN:Z:1.0
S\t1\tAAAA
S\t2\tCCCC
L\t1\t+\t2\t+\t0M
P\tx\t1+,2+\t0M
P\ty\t1+,2+\t0M
"""


def refine_graphs(tmp_path):
    """{name: (gfa, refine options, the paths' sequences or None)}: the
    three graphs of tests/test_refine.py (region bubble, no bubble, the
    region bubble through --nproc) and a numpy-seeded six-path bubble
    chain."""
    region = tmp_path / "region.gfa"
    region.write_text(GFA_REGION)
    nobub = tmp_path / "nobubble.gfa"
    nobub.write_text(GFA_NO_BUBBLE)
    chain = tmp_path / "chain.gfa"
    want = write_bubble_chain(str(chain), seed=4, n_small=3, small=45,
                              n_big=1, big=110)
    return {
        "region": (region, dict(minlength=1, minsize=1, nrefinements=5),
                   None),
        "no_bubble": (nobub, dict(minlength=1), None),
        "region_nproc": (region, dict(minlength=1, minsize=1,
                                      nrefinements=5, nproc=4), None),
        "chain": (chain, dict(minsize=2, maxsize=10000, nrefinements=20),
                  want),
    }


# --------------------------------------------------------------------------
# comparisons
# --------------------------------------------------------------------------

def jax_gfa(G, idx, fn):
    """The JAX package's GFA of ``G`` as its ``rem`` writes it (pruned
    past two paths): the file's bytes.  The port's is
    ``align.rem.write_rem_gfa``."""
    from reveal_tpu.align.graphops import prune_nodes
    from reveal_tpu.core.io_gfa import seq2node, write_gfa

    if len(G.graph["paths"]) > 2:
        prune_nodes(G, T=idx.main.T)
    seq2node(G, idx.main.T)
    write_gfa(G, idx.main.T, outputfile=fn)
    with open(fn, "rb") as fh:
        return fh.read()


def jax_refined(gfa, out, **kw):
    """The JAX package's ``refine_all`` on ``gfa`` and the rest of its
    ``refine_cmd`` (prune, contract, write): the GFA's bytes."""
    from reveal_tpu.align.graphops import prune_nodes
    from reveal_tpu.core.io_gfa import read_gfa, write_gfa
    from reveal_tpu.graph.simplify import contract
    from reveal_tpu.hmm.refine import refine_all

    G = refine_all(read_gfa(gfa), **kw)
    prune_nodes(G)
    contract(G, [n for n in G.topological_sort() if not isinstance(n, str)])
    write_gfa(G, None, outputfile=out)
    with open(out, "rb") as fh:
        return fh.read()


def cli_args(kw):
    """``refine_all`` keywords as ``refine`` flags."""
    args = []
    for k, v in kw.items():
        flag = {"minlength": "-m"}.get(k, "--" + k)
        if v is True:
            args.append(flag)
        elif v is not False:
            args += [flag, str(v)]
    return args


def pin_jax_two_phase(monkeypatch):
    """Pin the JAX package's refine to the route the port implements: its
    two-phase route with stage 1 through ``batch_posteriors_cut`` (the
    native host pair-HMM and the native whole-MSA batch off)."""
    import reveal_tpu.hmm.msa as jax_msa

    monkeypatch.setattr(jax_msa, "NATIVE_POST_MAX_CELLS", 0)
    monkeypatch.setenv("REVEAL_TPU_NATIVE_MSA", "0")
