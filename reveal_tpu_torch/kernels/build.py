"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded
with ``ctypes``.  The library lives in ``reveal_tpu_torch/build/`` under
a name keyed by a hash of the sources, so an edited source rebuilds and
an unchanged one loads at once.  A failed build raises; nothing falls
back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def _sources():
    return sorted(
        glob.glob(os.path.join(CSRC, "*.cu"))
        + glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def _nvcc():
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    exe = os.path.join(home, "bin", "nvcc")
    if os.path.exists(exe):
        return exe
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME (%s); the CUDA kernels "
        "of reveal_tpu_torch cannot be built" % home
    )


def library_path() -> str:
    """Path of the shared library for the current sources."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(
        BUILD_DIR, "libreveal_kernels_%s.so" % h.hexdigest()[:16]
    )


def _run_all(cmds):
    """Run the commands side by side; raise with the output of the
    first that fails.  Returns their standard error, in order."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                "nvcc failed (exit %d): %s\n%s%s"
                % (p.returncode, " ".join(cmd), out, err)
            )
    return [err for _out, err in outs]


def build() -> str:
    """Compile the sources if their library is missing; return its
    path.  One nvcc per source, all started together, then one link.
    Raises ``RuntimeError`` with nvcc's output on failure."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp.%d" % (so, os.getpid())
    cus = [s for s in _sources() if s.endswith(".cu")]
    objs = ["%s.%s.o" % (tmp, os.path.basename(cu)) for cu in cus]
    nvcc = _nvcc()
    try:
        reports = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, cu]
                            for cu, obj in zip(cus, objs)])
        _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(so + ".ptxas.txt", "w") as fh:
        fh.write("".join(reports))
    os.replace(tmp, so)
    return so


def ptxas_report() -> str:
    """What ``ptxas -v`` said when the current library was built: every
    kernel's registers, shared memory and spills."""
    with open(build() + ".ptxas.txt") as fh:
        return fh.read()


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with every C
    entry point's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(build())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # (lcp, npad, q, thr, out, rbv, wrv, stream) -> cudaError_t
    lib.rtt_window_resolve_i32.argtypes = [vp, ci, vp, vp, vp, ci, ci, vp]
    lib.rtt_window_resolve_i32.restype = ci
    # (sa, lcp, bwt, seg, beg, cq, centry_next, rc, ticket, stats, npad,
    #  ccap, grid, stream)
    lib.rtt_repair_pass_i32.argtypes = [vp] * 10 + [ci] * 3 + [vp]
    lib.rtt_repair_pass_i32.restype = ci
    # (xcls, ycls, lx, params, m_out, snap, scratch, B, L1p, L2p,
    #  C, G, P, stream)
    lib.rtt_pairhmm_fwd_f32.argtypes = [vp] * 7 + [ci] * 6 + [vp]
    lib.rtt_pairhmm_fwd_f32.restype = ci
    # (xcls, ycls, lx, ly, params, out, scratch, B, L1p, L2p,
    #  C, G, P, stream)
    lib.rtt_pairhmm_bwd_f32.argtypes = [vp] * 7 + [ci] * 6 + [vp]
    lib.rtt_pairhmm_bwd_f32.restype = ci
    # (forward, B, L1p, P) -> 32-bit words of zeroed scratch
    lib.rtt_pairhmm_scratch_words.argtypes = [ci] * 4
    lib.rtt_pairhmm_scratch_words.restype = ctypes.c_long
    # (p, out, B, L1p, L2p, nrows, stream)
    lib.rtt_mea_score_f32.argtypes = [vp, vp] + [ci] * 4 + [vp]
    lib.rtt_mea_score_f32.restype = ci
    # (L2p, &threads, &k4) -> 1 if the kernel takes rows of L2p columns
    lib.rtt_mea_score_plan.argtypes = [ci, vp, vp]
    lib.rtt_mea_score_plan.restype = ci
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(
            "%s: CUDA launch failed with cudaError_t %d" % (what, err)
        )
