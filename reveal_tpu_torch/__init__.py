"""reveal-tpu on PyTorch and CUDA.

A port of ``reveal_tpu`` (JAX, XLA and Pallas) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``).  ``reveal_tpu`` stays the
reference: the port imports its framework-free host code (native C++ engine,
fasta/GFA I/O, graph model, anchor replay) and re-implements only the device
code.  This package never imports ``jax``.

Covered so far: pairwise ``rem --frontier`` (two fastas -> GFA), whose
residual recursion runs on the device as the level kernel of
``index/devloop.py`` with the repair window-resolve as a CUDA kernel
(``csrc/window_resolve.cu``).  Entry points:

* ``reveal_tpu_torch.align.rem.align_genomes([a.fa, b.fa], device="cuda")``
* ``python -m reveal_tpu_torch.cli rem a.fa b.fa --frontier -o out.gfa``
"""
