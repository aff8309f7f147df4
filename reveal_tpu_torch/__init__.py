"""reveal-tpu on PyTorch and CUDA.

A port of ``reveal_tpu`` (JAX, XLA and Pallas) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``).  ``reveal_tpu`` stays the
reference, but the port stands alone: it keeps its own copy of the host
code it needs (native C++ engine, fasta/GFA I/O, graph model, anchor
replay, the host MSA) under the same sub-package and module names, and
imports neither ``jax`` nor anything of ``reveal_tpu``.

Covered so far:

* pairwise ``rem --frontier`` (two fastas -> GFA), whose residual
  recursion runs on the device as the level kernel of ``index/devloop.py``
  with each repair pass one launch of a CUDA kernel
  (``csrc/repair_pass.cu``); a pair the forest declines runs the whole
  recursion from the root in the same level loop with the flat chain
  (the single-root loop, ``devloop.rem_device_loop``);
* multi-genome ``rem --frontier`` (three or more fastas, up to 8 contig
  paths -> GFA), whose whole recursion runs on the device as the level
  loop of ``index/devloop_multi.py`` with the repair rounds' insertion
  points from the window-resolve CUDA kernel (``csrc/window_resolve.cu``);
* every other ``rem --frontier`` input -- bacterial-scale multi-genome
  inputs past ``--maxmums`` (every input the multi loop declines), more
  than 8 contig paths, multi-contig pairs (genomes with plasmids),
  ``.gfa`` inputs, ``--notrim``, ``--seedsize``, ``--gcmodel``,
  ``--maxsize`` -- whose recursion state stays on the device across the
  levels of the per-level frontier (``index/devfrontier.py``: torch
  stages, the host picking anchors and doing the graph surgery between
  them);
* ``refine`` (GFA -> GFA with realigned bubbles), whose pair posteriors
  (stage 1 of the consistency MSA) run on the device with the pair-HMM
  forward and backward DP as CUDA kernels (``csrc/pairhmm_dp.cu``), and
  with them the MEA distances and the consistency transform of every
  bubble under the chain's size cap; ``--logadd-compat``, ``--method``
  (external aligners, ``reveal_rem``) and ``--nproc`` run on the host as
  in ``reveal_tpu``;
* ``align``, the pipeline rem -> unzip -> refine -> variants: printed as
  a script of ``python -m reveal_tpu_torch.cli`` lines, or with ``--run``
  run in one process, its ``rem`` and ``refine`` stages on ``--device``;
* every other subcommand of ``reveal_tpu``'s CLI, host code copied whole
  (``graph/{unzip,varcall,annotate,chop}.py``, ``align/{anchorlog,
  kdchain}.py``, ``transform/``, ``core/{io_maf,maf2graph}.py``,
  ``utils/{dformat,falcon2gfa}.py``, ``viz.py``): unzip, variants,
  bubbles, extract, split, merge, comp, subgraph, stats, chop, annotate,
  matches, chain, rearrangements, transform, finish, convert, plot and
  gplot; ``rem --checkpoint`` (the serial LIFO host engine logging its
  picks) and the host loops of ``align_genomes(frontier=False)``;
* the device suffix-array build (``--backend jax``: prefix doubling and
  the LCP rank descent in torch, ``index/suffix.build_esa_device``) and
  the device pairwise-MUM scans that read it
  (``index/mums.pairwise_mums_device``, ``index/frontier.frontier_mums``);
* the process groups and the distributed suffix-array build
  (``--backend jax-dist``, ``parallel/dsa.build_esa_distributed``: one
  process a rank in a ``torch.distributed`` group, gloo on the CPU and
  NCCL on cards, a world of one unless the caller set up a group with
  ``parallel/distributed.init_distributed``), and the sharded pipeline
  step (``parallel/mesh.build_pipeline_step``);
* the mesh frontier (``DeviceFrontier(mesh=)``, ``mesh=`` on
  ``align_seqs``/``align_genomes``: the per-level frontier's slots
  sharded over the ranks of a mesh) and multi-process ``rem``
  (``align.rem.rem_on_world``, every rank of a ``World`` making the same
  call), and the multichip dry run (``parallel/dryrun.py``).

Entry points:

* ``reveal_tpu_torch.align.rem.align_genomes([a.fa, b.gfa, ...], device="cuda")``
* ``reveal_tpu_torch.hmm.refine.refine_all(G, device="cuda", ...)``
* ``python -m reveal_tpu_torch.cli align a.fa b.fa c.fa --run -o prg``
* ``python -m reveal_tpu_torch.cli rem a.fa b.fa -o out.gfa``
* ``python -m reveal_tpu_torch.cli refine g.gfa --all -o out.gfa``
* ``python -m reveal_tpu_torch.cli <subcommand> -h`` for the rest
"""

