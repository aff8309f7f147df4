"""Native host kernels (C++, built on demand with g++, loaded via ctypes).

Provides the host-side equivalents of the reference's native layer
(libdivsufsort + the C index internals): SA-IS suffix-array construction
and the capped Kasai LCP pass.  The build is cached next to the source,
keyed by a source hash; if no compiler is available the package degrades
to the numpy implementations.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess

import numpy as np

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "esa.cpp")

_lib = None
_tried = False


def _build_dir():
    d = os.path.join(os.path.dirname(_HERE), "build")
    os.makedirs(d, exist_ok=True)
    return d


def get_lib():
    """Compile (if needed) and load the native library; None if
    unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("REVEAL_TPU_DISABLE_NATIVE"):
        # honest-CPU-proxy mode for bench.py: force every kernel onto its
        # numpy fallback so the measured baseline contains no C++
        return None
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
        tag = hashlib.sha256(src).hexdigest()[:16]
        so = os.path.join(_build_dir(), "esa_%s.so" % tag)
        if not os.path.exists(so):
            tmp = so + ".tmp.%d" % os.getpid()
            cmd = [
                "g++",
                "-O3",
                "-march=native",
                "-shared",
                "-fPIC",
                "-std=c++17",
                "-pthread",
                _SRC,
                "-o",
                tmp,
            ]
            subprocess.run(
                cmd, check=True, capture_output=True, timeout=300
            )
            os.replace(tmp, so)
            log.info("built native kernels: %s", so)
        lib = ctypes.CDLL(so)
        lib.rtpu_sais64.restype = ctypes.c_int
        lib.rtpu_sais64.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.rtpu_sais32.restype = ctypes.c_int
        lib.rtpu_sais32.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib.rtpu_kasai64.restype = None
        lib.rtpu_kasai64.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.rtpu_kasai32.restype = None
        lib.rtpu_kasai32.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int32
        ]
        for nm in ("rtpu_repair_leading", "rtpu_repair_leading32"):
            fn = getattr(lib, nm)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int64,
                ctypes.c_void_p,
                ctypes.c_int64,
            ]
        for nm in ("rtpu_multimums", "rtpu_multimums32"):
            fn = getattr(lib, nm)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
            ] + [ctypes.c_void_p] * 3
        for nm in ("rtpu_split3_full", "rtpu_split3_full32"):
            fn = getattr(lib, nm)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p] * 2 + [
                ctypes.c_int64,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int64,
            ] + [ctypes.c_void_p] * 3
        for nm in ("rtpu_split3_repair_enum", "rtpu_split3_repair_enum32"):
            fn = getattr(lib, nm)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p] * 2 + [
                ctypes.c_int64,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int,
                ctypes.c_int,
            ] + [ctypes.c_void_p] * 6
        for nm in ("rtpu_pairwise_mums", "rtpu_pairwise_mums32"):
            fn = getattr(lib, nm)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int,
                ctypes.c_int64,
            ] + [ctypes.c_void_p] * 3
        lib.rtpu_split3.restype = None
        lib.rtpu_split3.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int64
        ] + [ctypes.c_void_p] * 8
        lib.rtpu_trim_overlap.restype = ctypes.c_int64
        lib.rtpu_trim_overlap.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.rtpu_pick_multi.restype = ctypes.c_int
        lib.rtpu_pick_multi.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int64, ctypes.c_int64]
            + [ctypes.c_void_p] * 2
            + [ctypes.c_int64]
            + [ctypes.c_void_p] * 3
            + [ctypes.c_int64, ctypes.c_int]
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_double]
            + [ctypes.c_int64, ctypes.c_double, ctypes.c_int64]
            + [ctypes.c_int64]
            + [ctypes.c_void_p] * 6
        )
        lib.rtpu_pick_pairwise.restype = ctypes.c_int
        lib.rtpu_pick_pairwise.argtypes = (
            [ctypes.c_void_p] * 3
            + [ctypes.c_int64]
            + [ctypes.c_void_p] * 2
            + [ctypes.c_int64]
            + [ctypes.c_void_p] * 2
            + [ctypes.c_int64, ctypes.c_int]
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_double]
            + [ctypes.c_int64, ctypes.c_double, ctypes.c_int64]
            + [ctypes.c_void_p] * 5
        )
        lib.rtpu_chain.restype = None
        lib.rtpu_chain.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_double,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.rtpu_glocal_dp.restype = None
        lib.rtpu_glocal_dp.argtypes = (
            [ctypes.c_void_p] * 8
            + [ctypes.c_int64]
            + [ctypes.c_void_p] * 2
            + [ctypes.c_double] * 6
            + [ctypes.c_int64] * 2
            + [ctypes.c_int]
            + [ctypes.c_void_p] * 2
        )
        lib.rtpu_mea_dp.restype = ctypes.c_int64
        lib.rtpu_mea_dp.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.rtpu_posterior_accum.restype = None
        lib.rtpu_posterior_accum.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            + [ctypes.c_int64] * 3
            + [ctypes.c_void_p] * 2
            + [ctypes.c_int]
        )
        lib.rtpu_build_posterior.restype = None
        lib.rtpu_build_posterior.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_void_p] * 10
            + [ctypes.c_int64]
        )
        lib.rtpu_refine_rounds.restype = ctypes.c_int64
        lib.rtpu_refine_rounds.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
            + [ctypes.c_void_p] * 4
            + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        )
        for nm in ("rtpu_rem2_loop", "rtpu_rem2_loop32"):
            fn = getattr(lib, nm)
            fn.restype = ctypes.c_int64
            fn.argtypes = (
                [ctypes.c_void_p] * 4
                + [ctypes.c_int64] * 3
                + [ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
                + [ctypes.c_double, ctypes.c_double, ctypes.c_int64]
                + [ctypes.POINTER(ctypes.c_void_p)]
            )
        for nm in ("rtpu_rem2_defer64", "rtpu_rem2_defer32"):
            fn = getattr(lib, nm)
            fn.restype = ctypes.c_int64
            fn.argtypes = (
                [ctypes.c_void_p] * 4
                + [ctypes.c_int64] * 3
                + [ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
                + [ctypes.c_double, ctypes.c_double, ctypes.c_int64]
                + [ctypes.POINTER(ctypes.c_void_p)] * 2
                + [ctypes.c_void_p]
            )
        for nm in ("rtpu_rem2_defer_par64", "rtpu_rem2_defer_par32"):
            fn = getattr(lib, nm, None)
            if fn is None:
                continue
            fn.restype = ctypes.c_int64
            fn.argtypes = (
                [ctypes.c_void_p] * 4
                + [ctypes.c_int64] * 3
                + [ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
                + [ctypes.c_double, ctypes.c_double, ctypes.c_int64]
                + [ctypes.c_int64]
                + [ctypes.POINTER(ctypes.c_void_p)] * 2
                + [ctypes.c_void_p]
            )
        lib.rtpu_pairhmm_post_batch.restype = None
        lib.rtpu_pairhmm_post_batch.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int64]
            + [ctypes.c_void_p] * 8
            + [ctypes.c_float, ctypes.c_int64]
        )
        lib.rtpu_msa_batch.restype = ctypes.c_int
        lib.rtpu_msa_batch.argtypes = (
            [ctypes.c_void_p] * 3
            + [ctypes.c_int64]
            + [ctypes.c_void_p] * 2
            + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64]
            + [ctypes.c_void_p] * 4
            + [ctypes.c_float]
            + [ctypes.c_void_p] * 5
            + [ctypes.c_void_p]
            + [ctypes.c_int64]
        )
        lib.rtpu_free.restype = None
        lib.rtpu_free.argtypes = [ctypes.c_void_p]
        lib.rtpu_replay_pairwise.restype = ctypes.c_void_p
        lib.rtpu_replay_pairwise.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_void_p] * 5
            + [ctypes.c_int64]
            + [ctypes.c_void_p] * 5
            + [ctypes.c_void_p] * 3
        )
        lib.rtpu_replay_fetch.restype = None
        lib.rtpu_replay_fetch.argtypes = [ctypes.c_void_p] * 13
        lib.rtpu_replay_nedges.restype = ctypes.c_int64
        lib.rtpu_replay_nedges.argtypes = [ctypes.c_void_p]
        lib.rtpu_replay_end.restype = None
        lib.rtpu_replay_end.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception as e:  # pragma: no cover
        log.warning("native kernels unavailable (%s); using numpy", e)
        _lib = None
    return _lib


def index_dtype(n: int):
    """Index width for an n-byte text: int32 below 2^31 (the reference
    builds 32- and 64-bit extension twins, setup.py:21-31; the 32-bit
    index halves memory traffic on the memory-bound SA/LCP passes)."""
    return np.int32 if n < 2**31 else np.int64


def build_esa_native(T: np.ndarray):
    """(SA, LCP, SAi) via SA-IS + capped Kasai.  Raises if the native
    library is unavailable.  Arrays are int32 for texts below 2^31,
    int64 otherwise (the reveallib/reveallib64 twin-width design)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native kernels unavailable")
    n = len(T)
    T = np.ascontiguousarray(T, dtype=np.uint8)
    dt = index_dtype(n)
    SA = np.empty(n, dtype=dt)
    if dt == np.int32:
        rc = lib.rtpu_sais32(
            T.ctypes.data, SA.ctypes.data, ctypes.c_int32(n)
        )
    else:
        rc = lib.rtpu_sais64(
            T.ctypes.data, SA.ctypes.data, ctypes.c_int64(n)
        )
    if rc != 0:
        raise RuntimeError("sais failed: %d" % rc)
    SAi = np.empty(n, dtype=dt)
    LCP = np.empty(n, dtype=dt)
    if dt == np.int32:
        lib.rtpu_kasai32(
            T.ctypes.data,
            SA.ctypes.data,
            SAi.ctypes.data,
            LCP.ctypes.data,
            ctypes.c_int32(n),
        )
    else:
        lib.rtpu_kasai64(
            T.ctypes.data,
            SA.ctypes.data,
            SAi.ctypes.data,
            LCP.ctypes.data,
            ctypes.c_int64(n),
        )
    return SA, LCP, SAi


def pairwise_mums_native(T, SA, LCP, nsep0, minl, rc, nT):
    """Fast per-segment pairwise MUM scan; returns (l, a, b) arrays in
    the index dtype, or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(SA)
    dt = np.int32 if SA.dtype == np.int32 else np.int64
    fn = lib.rtpu_pairwise_mums32 if dt == np.int32 else lib.rtpu_pairwise_mums
    out_l = np.empty(n, dtype=dt)
    out_a = np.empty(n, dtype=dt)
    out_b = np.empty(n, dtype=dt)
    cnt = fn(
        T.ctypes.data,
        np.ascontiguousarray(SA, dtype=dt).ctypes.data,
        np.ascontiguousarray(LCP, dtype=dt).ctypes.data,
        ctypes.c_int64(n),
        ctypes.c_int64(nsep0),
        ctypes.c_int64(minl),
        ctypes.c_int(1 if rc else 0),
        ctypes.c_int64(nT),
        out_l.ctypes.data,
        out_a.ctypes.data,
        out_b.ctypes.data,
    )
    return out_l[:cnt], out_a[:cnt], out_b[:cnt]


def repair_leading_native(SA, LCP, SAi, begins) -> bool:
    """In-place boundary repair (bubble_sort semantics) on the child's
    SA/LCP and the global SAi.  Returns False (caller should use the
    Python path) when the library is unavailable or the arrays are not
    mutable contiguous same-width int32/int64 buffers."""
    lib = get_lib()
    if lib is None:
        return False
    dt = SA.dtype
    if dt not in (np.int32, np.int64):
        return False
    for a in (SA, LCP, SAi):
        if (
            a.dtype != dt
            or not a.flags["C_CONTIGUOUS"]
            or not a.flags["WRITEABLE"]
        ):
            return False
    fn = lib.rtpu_repair_leading32 if dt == np.int32 else lib.rtpu_repair_leading
    b = np.ascontiguousarray(begins, dtype=np.int64)
    fn(
        SA.ctypes.data,
        LCP.ctypes.data,
        SAi.ctypes.data,
        ctypes.c_int64(len(SA)),
        b.ctypes.data,
        ctypes.c_int64(len(b)),
    )
    return True


def multimums_native(T, SA, LCP, SO, nsamples_main, minl, minn):
    """(l, lb, ub) int64 arrays from the linear LCP-interval stack walk,
    or None if unavailable / SO is not uint16."""
    lib = get_lib()
    if lib is None or SO.dtype != np.uint16:
        return None
    n = len(SA)
    dt = np.int32 if SA.dtype == np.int32 else np.int64
    fn = lib.rtpu_multimums32 if dt == np.int32 else lib.rtpu_multimums
    SA = np.ascontiguousarray(SA, dtype=dt)
    LCP = np.ascontiguousarray(LCP, dtype=dt)
    out_l = np.empty(n, dtype=dt)
    out_lb = np.empty(n, dtype=dt)
    out_ub = np.empty(n, dtype=dt)
    cnt = fn(
        T.ctypes.data,
        SA.ctypes.data,
        LCP.ctypes.data,
        SO.ctypes.data,
        ctypes.c_int64(n),
        ctypes.c_int64(nsamples_main),
        ctypes.c_int64(minl),
        ctypes.c_int64(minn),
        out_l.ctypes.data,
        out_lb.ctypes.data,
        out_ub.ctypes.data,
    )
    return out_l[:cnt], out_lb[:cnt], out_ub[:cnt]


def split3_full_native(SA, LCP, SAi, intervals):
    """Classify + 3-way split in one native call.  intervals: iterable of
    (begin, end, cls) with cls in {1: leading, 2: trailing, 4: rest,
    3: matched}, applied in order (later classes overwrite).  Returns
    ((sa_l, lcp_l), (sa_t, lcp_t), (sa_p, lcp_p)) — views into a shared
    buffer — or None if the library is unavailable.  Mutates SAi."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(SA)
    dt = np.int32 if SA.dtype == np.int32 else np.int64
    fn = lib.rtpu_split3_full32 if dt == np.int32 else lib.rtpu_split3_full
    SA = np.ascontiguousarray(SA, dtype=dt)
    LCP = np.ascontiguousarray(LCP, dtype=dt)
    if SAi.dtype != dt or not SAi.flags["C_CONTIGUOUS"]:
        return None
    iv = np.array(intervals, dtype=np.int64).reshape(-1, 3)
    iv = np.ascontiguousarray(iv)
    sa_buf = np.empty(n, dtype=dt)
    lcp_buf = np.empty(n, dtype=dt)
    out_n = np.zeros(3, dtype=np.int64)
    fn(
        SA.ctypes.data,
        LCP.ctypes.data,
        ctypes.c_int64(n),
        SAi.ctypes.data,
        iv.ctypes.data,
        ctypes.c_int64(len(iv)),
        sa_buf.ctypes.data,
        lcp_buf.ctypes.data,
        out_n.ctypes.data,
    )
    nl, nt, npar = int(out_n[0]), int(out_n[1]), int(out_n[2])
    return (
        (sa_buf[:nl], lcp_buf[:nl]),
        (sa_buf[nl : nl + nt], lcp_buf[nl : nl + nt]),
        (sa_buf[nl + nt : nl + nt + npar], lcp_buf[nl + nt : nl + nt + npar]),
    )


def split3_repair_enum_native(
    SA, LCP, SAi, intervals, T, matches, nsep0, minl,
    enum_lead=True, enum_trail=True,
):
    """Fused split + matched-text lowercase + leading-child boundary
    repair + per-child pairwise MUM enumeration (one ctypes crossing per
    recursion step instead of four; children are scanned cache-hot).

    matches: [(pos, l)] of the picked anchor's occurrences.  Returns
    (children, lead_mums, trail_mums) where children is the
    split3_full_native triple and each mums entry is (l, a, b) arrays or
    None when that child was not enumerated.  Returns None if the
    library is unavailable (callers use the separate steps)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(SA)
    dt = np.int32 if SA.dtype == np.int32 else np.int64
    fn = (
        lib.rtpu_split3_repair_enum32
        if dt == np.int32
        else lib.rtpu_split3_repair_enum
    )
    SA = np.ascontiguousarray(SA, dtype=dt)
    LCP = np.ascontiguousarray(LCP, dtype=dt)
    if SAi.dtype != dt or not SAi.flags["C_CONTIGUOUS"]:
        return None
    iv = np.ascontiguousarray(
        np.array(intervals, dtype=np.int64).reshape(-1, 3)
    )
    mt = np.ascontiguousarray(
        np.array(matches, dtype=np.int64).reshape(-1, 2)
    )
    sa_buf = np.empty(n, dtype=dt)
    lcp_buf = np.empty(n, dtype=dt)
    ml = np.empty(n, dtype=dt)
    ma = np.empty(n, dtype=dt)
    mb = np.empty(n, dtype=dt)
    out_n = np.zeros(5, dtype=np.int64)
    fn(
        SA.ctypes.data,
        LCP.ctypes.data,
        ctypes.c_int64(n),
        SAi.ctypes.data,
        iv.ctypes.data,
        ctypes.c_int64(len(iv)),
        T.ctypes.data,
        mt.ctypes.data,
        ctypes.c_int64(len(mt)),
        ctypes.c_int64(nsep0),
        ctypes.c_int64(minl),
        ctypes.c_int(1 if enum_lead else 0),
        ctypes.c_int(1 if enum_trail else 0),
        sa_buf.ctypes.data,
        lcp_buf.ctypes.data,
        ml.ctypes.data,
        ma.ctypes.data,
        mb.ctypes.data,
        out_n.ctypes.data,
    )
    nl, nt, npar = int(out_n[0]), int(out_n[1]), int(out_n[2])
    children = (
        (sa_buf[:nl], lcp_buf[:nl]),
        (sa_buf[nl : nl + nt], lcp_buf[nl : nl + nt]),
        (sa_buf[nl + nt : nl + nt + npar], lcp_buf[nl + nt : nl + nt + npar]),
    )
    # copy the (small) mum prefixes so the n-sized scratch buffers are
    # not pinned alive by children waiting on the LIFO queue
    cl = int(out_n[3])
    ct = int(out_n[4])
    lead_mums = (
        None
        if cl < 0
        else (ml[:cl].copy(), ma[:cl].copy(), mb[:cl].copy())
    )
    off = max(cl, 0)
    trail_mums = (
        None
        if ct < 0
        else (
            ml[off : off + ct].copy(),
            ma[off : off + ct].copy(),
            mb[off : off + ct].copy(),
        )
    )
    return children, lead_mums, trail_mums


def rem2_loop_native(
    T, SA, LCP, SAi, nsep0, minlength, trim, maxmums, wscore, wpen,
    pcutoff, nthreads=None,
):
    """Whole pairwise LIFO recursion in one native call (rem2_loop in
    esa.cpp): pop -> premums/enumerate -> pick (pick_pairwise_dp) ->
    split3_repair_enum -> push, without returning to Python.

    Returns an (n_anchors, 7) int64 array of
    ``[ma, mb, l, aBeg, aEnd, bBeg, bEnd]`` records in pop order, or
    None on a pick defer / missing library — T and SAi are mutated
    (matched lowercase, child slots), so callers must snapshot and
    restore them before falling back to the per-step loop."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(SA)
    dt = np.int32 if SA.dtype == np.int32 else np.int64
    if (
        LCP.dtype != dt
        or SAi.dtype != dt
        or not SA.flags["C_CONTIGUOUS"]
        or not LCP.flags["C_CONTIGUOUS"]
        or not SAi.flags["C_CONTIGUOUS"]
        or not T.flags["C_CONTIGUOUS"]
    ):
        return None
    fn = lib.rtpu_rem2_loop32 if dt == np.int32 else lib.rtpu_rem2_loop
    if nthreads is None:
        env = os.environ.get("REVEAL_TPU_REM2_THREADS")
        if env is not None:
            nthreads = int(env)
        else:
            # pure-C workers, no GIL: default to the machine width (the
            # deterministic serial pop order is reconstructed from the
            # recorded recursion tree, see rem2_loop_par in esa.cpp)
            nthreads = min(8, os.cpu_count() or 1)
    out_ptr = ctypes.c_void_p()
    na = fn(
        T.ctypes.data,
        SA.ctypes.data,
        LCP.ctypes.data,
        SAi.ctypes.data,
        ctypes.c_int64(n),
        ctypes.c_int64(nsep0),
        ctypes.c_int64(minlength),
        ctypes.c_int(1 if trim else 0),
        ctypes.c_int64(maxmums),
        ctypes.c_int64(wscore),
        ctypes.c_double(wpen),
        ctypes.c_double(pcutoff),
        ctypes.c_int64(max(1, nthreads)),
        ctypes.byref(out_ptr),
    )
    if na < 0:
        return None
    try:
        if na == 0:
            return np.empty((0, 7), dtype=np.int64)
        buf = (ctypes.c_int64 * (na * 7)).from_address(out_ptr.value)
        return np.array(buf, dtype=np.int64).reshape(na, 7)
    finally:
        lib.rtpu_free(out_ptr)


def rem2_defer_native(
    T, SA, LCP, SAi, nsep0, minlength, trim, maxmums, wscore, wpen,
    pcutoff, defer_max, threads=0,
):
    """Host-prefix pairwise recursion with small-segment deferral
    (rem2_loop defer_max in esa.cpp): segments whose enumerated
    candidate count is <= defer_max are not recursed into; a
    placeholder anchor row (l == -1, ma = defer id) marks each one's
    serial pop position and its frozen state comes back for the device
    whole-recursion kernel (index/devloop.rem_device_forest).

    Returns ``(anchors, defers)`` where anchors is an (na, 7) int64
    array in pop order (placeholder rows included) and defers is a
    list of ``(k, a_beg, a_end, b_beg, b_end, sa, lcp)`` per deferred
    segment, ordered by defer id; or None on a pick defer / missing
    library — T and SAi are mutated (matched lowercase, child slots),
    so callers must snapshot and restore them before falling back."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(SA)
    dt = np.int32 if SA.dtype == np.int32 else np.int64
    if (
        LCP.dtype != dt
        or SAi.dtype != dt
        or not SA.flags["C_CONTIGUOUS"]
        or not LCP.flags["C_CONTIGUOUS"]
        or not SAi.flags["C_CONTIGUOUS"]
        or not T.flags["C_CONTIGUOUS"]
    ):
        return None
    par = threads and threads > 1
    if par:
        fn = (
            lib.rtpu_rem2_defer_par32
            if dt == np.int32
            else lib.rtpu_rem2_defer_par64
        )
    else:
        fn = (
            lib.rtpu_rem2_defer32
            if dt == np.int32
            else lib.rtpu_rem2_defer64
        )
    out_ptr = ctypes.c_void_p()
    def_ptr = ctypes.c_void_p()
    def_len = np.zeros(1, dtype=np.int64)
    args = [
        T.ctypes.data,
        SA.ctypes.data,
        LCP.ctypes.data,
        SAi.ctypes.data,
        ctypes.c_int64(n),
        ctypes.c_int64(nsep0),
        ctypes.c_int64(minlength),
        ctypes.c_int(1 if trim else 0),
        ctypes.c_int64(maxmums),
        ctypes.c_int64(wscore),
        ctypes.c_double(wpen),
        ctypes.c_double(pcutoff),
        ctypes.c_int64(defer_max),
    ]
    if par:
        args.append(ctypes.c_int64(int(threads)))
    args += [
        ctypes.byref(out_ptr),
        ctypes.byref(def_ptr),
        def_len.ctypes.data,
    ]
    na = fn(*args)
    if na < 0:
        if def_ptr.value:
            lib.rtpu_free(def_ptr)
        return None
    try:
        if na == 0:
            anchors = np.empty((0, 7), dtype=np.int64)
        else:
            buf = (ctypes.c_int64 * (na * 7)).from_address(out_ptr.value)
            anchors = np.array(buf, dtype=np.int64).reshape(na, 7)
        dlen = int(def_len[0])
        defers = []
        if dlen:
            dbuf = np.frombuffer(
                (ctypes.c_int64 * dlen).from_address(def_ptr.value),
                dtype=np.int64,
            )
            off = 0
            while off < dlen:
                sn = int(dbuf[off])
                k, ab, ae, bb, be = (int(v) for v in dbuf[off + 1:off + 6])
                sa = dbuf[off + 6:off + 6 + sn].copy()
                lcp = dbuf[off + 6 + sn:off + 6 + 2 * sn].copy()
                defers.append((k, ab, ae, bb, be, sa, lcp))
                off += 6 + 2 * sn
        return anchors, defers
    finally:
        lib.rtpu_free(out_ptr)
        if def_ptr.value:
            lib.rtpu_free(def_ptr)


def split3_native(SA, LCP, D_sa, SAi):
    """3-way stable split with running-min LCP; returns
    ((sa_l, lcp_l), (sa_t, lcp_t), (sa_p, lcp_p)) trimmed to size, or None
    if the library is unavailable.  Mutates SAi in place."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(SA)
    SA = np.ascontiguousarray(SA, dtype=np.int64)
    LCP = np.ascontiguousarray(LCP, dtype=np.int64)
    D_sa = np.ascontiguousarray(D_sa, dtype=np.uint8)
    counts = np.bincount(D_sa, minlength=5)
    nl, nt, npar = int(counts[1]), int(counts[2]), int(counts[4])
    sa_l = np.empty(nl, dtype=np.int64)
    lcp_l = np.empty(nl, dtype=np.int64)
    sa_t = np.empty(nt, dtype=np.int64)
    lcp_t = np.empty(nt, dtype=np.int64)
    sa_p = np.empty(npar, dtype=np.int64)
    lcp_p = np.empty(npar, dtype=np.int64)
    out_n = np.zeros(3, dtype=np.int64)
    lib.rtpu_split3(
        SA.ctypes.data,
        LCP.ctypes.data,
        D_sa.ctypes.data,
        ctypes.c_int64(n),
        SAi.ctypes.data,
        sa_l.ctypes.data,
        lcp_l.ctypes.data,
        sa_t.ctypes.data,
        lcp_t.ctypes.data,
        sa_p.ctypes.data,
        lcp_p.ctypes.data,
        out_n.ctypes.data,
    )
    return ((sa_l, lcp_l), (sa_t, lcp_t), (sa_p, lcp_p))


def pick_pairwise_native(
    ls, aa, bb, seq_starts, seq_sids, left_off, right_off,
    trim, maxmums, wscore, wpen, seedsize, pcutoff, minlength,
):
    """Whole pairwise pick (graphmumpicker, schemes.py:197-358) in one
    native call; see pick_pairwise_dp in esa.cpp.  Returns
    (status, (l, a, b), pvalue, skip_left, skip_right) where status is
    0 = picked, 1 = stop recursion, 2 = defer to the generic path; skip
    lists are [(l, a, b, score_delta)] (seedsize-filtered).  None when
    the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    k = len(ls)
    ls = np.ascontiguousarray(ls, dtype=np.int64)
    aa = np.ascontiguousarray(aa, dtype=np.int64)
    bb = np.ascontiguousarray(bb, dtype=np.int64)
    seq_starts = np.ascontiguousarray(seq_starts, dtype=np.int64)
    seq_sids = np.ascontiguousarray(seq_sids, dtype=np.int64)
    left_off = np.ascontiguousarray(left_off, dtype=np.int64)
    right_off = np.ascontiguousarray(right_off, dtype=np.int64)
    split_out = np.zeros(3, dtype=np.int64)
    pvalue = np.zeros(1, dtype=np.float64)
    nskip = max(k, 1)
    skip_buf = np.empty((2, nskip, 3), dtype=np.int64)
    skip_counts = np.zeros(2, dtype=np.int64)
    skip_scores = np.empty((2, nskip), dtype=np.float64)
    st = lib.rtpu_pick_pairwise(
        ls.ctypes.data,
        aa.ctypes.data,
        bb.ctypes.data,
        ctypes.c_int64(k),
        seq_starts.ctypes.data,
        seq_sids.ctypes.data,
        ctypes.c_int64(len(seq_starts)),
        left_off.ctypes.data,
        right_off.ctypes.data,
        ctypes.c_int64(len(left_off)),
        ctypes.c_int(1 if trim else 0),
        ctypes.c_int64(maxmums),
        ctypes.c_int64(wscore),
        ctypes.c_double(wpen),
        ctypes.c_int64(seedsize),
        ctypes.c_double(pcutoff),
        ctypes.c_int64(minlength),
        split_out.ctypes.data,
        pvalue.ctypes.data,
        skip_buf.ctypes.data,
        skip_counts.ctypes.data,
        skip_scores.ctypes.data,
    )
    skips = []
    for side in range(2):
        cnt = int(skip_counts[side])
        skips.append(
            [
                (
                    int(skip_buf[side, i, 0]),
                    int(skip_buf[side, i, 1]),
                    int(skip_buf[side, i, 2]),
                    float(skip_scores[side, i]),
                )
                for i in range(cnt)
            ]
        )
    return (
        int(st),
        (int(split_out[0]), int(split_out[1]), int(split_out[2])),
        float(pvalue[0]),
        skips[0],
        skips[1],
    )


def pick_multi_native(
    ls, ws, coords, offs, nsamples_seg, seq_starts, seq_sids, SO,
    left_off, right_off, trim, maxmums, wscore, wpen, seedsize,
    pcutoff, minlength,
):
    """d-dim multiMUM pick in one native call (pick_multi_dp).  mums
    arrive as ragged rows: ls (k), ws (k widths), coords flat + offs
    (k+1).  Returns (status, (l, w, coords), pvalue, skip_left,
    skip_right) with skip entries (l, w, coords, score_delta); None if
    the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    k = len(ls)
    ls = np.ascontiguousarray(ls, dtype=np.int64)
    ws = np.ascontiguousarray(ws, dtype=np.int64)
    coords = np.ascontiguousarray(coords, dtype=np.int64)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    seq_starts = np.ascontiguousarray(seq_starts, dtype=np.int64)
    seq_sids = np.ascontiguousarray(seq_sids, dtype=np.int64)
    SO = np.ascontiguousarray(SO, dtype=np.uint16)
    left_off = np.ascontiguousarray(left_off, dtype=np.int64)
    right_off = np.ascontiguousarray(right_off, dtype=np.int64)
    wmax = int(ws.max()) if k else 2
    rowlen = 1 + wmax
    out_hdr = np.zeros(2, dtype=np.int64)
    split_coords = np.zeros(max(wmax, 1), dtype=np.int64)
    pvalue = np.zeros(1, dtype=np.float64)
    nskip = max(k, 1)
    skip_buf = np.empty((2, nskip, rowlen), dtype=np.int64)
    skip_counts = np.zeros(2, dtype=np.int64)
    skip_scores = np.empty((2, nskip), dtype=np.float64)
    st = lib.rtpu_pick_multi(
        ls.ctypes.data,
        ws.ctypes.data,
        coords.ctypes.data,
        offs.ctypes.data,
        ctypes.c_int64(k),
        ctypes.c_int64(nsamples_seg),
        seq_starts.ctypes.data,
        seq_sids.ctypes.data,
        ctypes.c_int64(len(seq_starts)),
        SO.ctypes.data,
        left_off.ctypes.data,
        right_off.ctypes.data,
        ctypes.c_int64(len(left_off)),
        ctypes.c_int(1 if trim else 0),
        ctypes.c_int64(maxmums),
        ctypes.c_int64(wscore),
        ctypes.c_double(wpen),
        ctypes.c_int64(seedsize),
        ctypes.c_double(pcutoff),
        ctypes.c_int64(minlength),
        ctypes.c_int64(rowlen),
        out_hdr.ctypes.data,
        split_coords.ctypes.data,
        pvalue.ctypes.data,
        skip_buf.ctypes.data,
        skip_counts.ctypes.data,
        skip_scores.ctypes.data,
    )
    w = int(out_hdr[1])
    skips = []
    for side in range(2):
        cnt = int(skip_counts[side])
        skips.append(
            [
                (
                    int(skip_buf[side, i, 0]),
                    w,
                    tuple(
                        int(skip_buf[side, i, 1 + c]) for c in range(w)
                    ),
                    float(skip_scores[side, i]),
                )
                for i in range(cnt)
            ]
        )
    return (
        int(st),
        (
            int(out_hdr[0]),
            w,
            tuple(int(split_coords[c]) for c in range(w)),
        ),
        float(pvalue[0]),
        skips[0],
        skips[1],
    )


def trim_overlap_native(L, P):
    """Per-dimension overlap trimming (schemes.py:161-191 semantics, see
    align/chaining.trim_overlap).  L: (k,) lengths, P: (k, d) start
    coordinates.  Returns trimmed (L', P') copies in final order, or None
    if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    Lc = np.ascontiguousarray(L, dtype=np.int64).copy()
    Pc = np.ascontiguousarray(P, dtype=np.int64).copy()
    k, d = Pc.shape
    ord_out = np.empty(k, dtype=np.int64)
    cnt = lib.rtpu_trim_overlap(
        Lc.ctypes.data,
        Pc.ctypes.data,
        ctypes.c_int64(k),
        ctypes.c_int64(d),
        ord_out.ctypes.data,
    )
    sel = ord_out[:cnt]
    return Lc[sel], Pc[sel]


def chain_native(starts, lens, nmul, left_start, wpen):
    """Full chain DP in C; returns (link, scores) or None if unavailable.
    starts: (k, d) int64 in the exact scan order; link[m] = predecessor
    slot (-1 = left)."""
    lib = get_lib()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    nmul = np.ascontiguousarray(nmul, dtype=np.int64)
    left_start = np.ascontiguousarray(left_start, dtype=np.int64)
    k, d = starts.shape
    link = np.empty(k, dtype=np.int64)
    scores = np.empty(k, dtype=np.float64)
    lib.rtpu_chain(
        starts.ctypes.data,
        lens.ctypes.data,
        nmul.ctypes.data,
        ctypes.c_int64(k),
        ctypes.c_int64(d),
        left_start.ctypes.data,
        ctypes.c_double(wpen),
        link.ctypes.data,
        scores.ctypes.data,
    )
    return link, scores


def glocal_dp_native(
    S1, E1, S2, E2, O, REF, CTG, SCORE, RNG0, RNG1,
    rearrangecost, inversioncost, _lambda, eps, alfa, gapopen,
    lastn, lastbp, axis,
):
    """Glocal synteny-chain DP over [start] + sorted blocks candidate
    arrays (transform/blocks.glocalchain non-heap semantics).  Returns
    (bestidx, bestscore) per block, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arrs = [
        np.ascontiguousarray(a, dtype=np.int64)
        for a in (S1, E1, S2, E2, O, REF, CTG, SCORE)
    ]
    rng0 = np.ascontiguousarray(RNG0, dtype=np.int64)
    rng1 = np.ascontiguousarray(RNG1, dtype=np.int64)
    ncand = len(arrs[0])
    nb = ncand - 1
    best = np.empty(nb, dtype=np.int64)
    score = np.empty(nb, dtype=np.float64)
    lib.rtpu_glocal_dp(
        *[a.ctypes.data for a in arrs],
        ctypes.c_int64(ncand),
        rng0.ctypes.data,
        rng1.ctypes.data,
        ctypes.c_double(rearrangecost),
        ctypes.c_double(inversioncost),
        ctypes.c_double(_lambda),
        ctypes.c_double(eps),
        ctypes.c_double(alfa),
        ctypes.c_double(gapopen),
        ctypes.c_int64(lastn),
        ctypes.c_int64(lastbp),
        ctypes.c_int(axis),
        best.ctypes.data,
        score.ctypes.data,
    )
    return best, score


def mea_dp_native(post):
    """MEA alignment DP (ComputeAlignment, ProbabilisticModel.h:641-760)
    over a float32 (L1+1, L2+1) posterior.  Returns (edit_ops, total)
    with edit_ops a uint8 array (0='B', 1='Y', 2='X') in forward order,
    or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(post, dtype=np.float32)
    L1 = p.shape[0] - 1
    L2 = p.shape[1] - 1
    edit = np.empty(L1 + L2 + 1, dtype=np.uint8)
    total = np.zeros(1, dtype=np.float64)
    k = lib.rtpu_mea_dp(
        p.ctypes.data,
        ctypes.c_int64(L1),
        ctypes.c_int64(L2),
        edit.ctypes.data,
        total.ctypes.data,
    )
    return edit[:k], float(total[0])


def posterior_accum_native(post, P, m1, m2, transpose=False):
    """post[m1[ii], m2[jj]] += P[ii, jj] (or P[jj, ii] when transpose)
    — the BuildPosterior scatter-add (ProbabilisticModel.h:1018-1089).
    post must be float32 C-contiguous and is modified in place.  Returns
    False if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    assert post.dtype == np.float32 and post.flags.c_contiguous
    Pc = np.ascontiguousarray(P, dtype=np.float32)
    m1c = np.ascontiguousarray(m1, dtype=np.int64)
    m2c = np.ascontiguousarray(m2, dtype=np.int64)
    l1 = len(m1c) - 1
    l2 = len(m2c) - 1
    lib.rtpu_posterior_accum(
        post.ctypes.data,
        ctypes.c_int64(post.shape[1]),
        Pc.ctypes.data,
        ctypes.c_int64(l1),
        ctypes.c_int64(l2),
        ctypes.c_int64(Pc.shape[1]),
        m1c.ctypes.data,
        m2c.ctypes.data,
        ctypes.c_int(1 if transpose else 0),
    )
    return True


def build_posterior_native(L1, W, pair_jobs, m1s, m2s):
    """One-call BuildPosterior sum (ProbabilisticModel.h:1018-1089).

    pair_jobs: [(P, i, j, transpose)] — P float32 C-contiguous; i/j index
    into m1s/m2s (int64 mapping arrays).  Returns the (L1+1, W) float32
    accumulation, or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(pair_jobs)
    post = np.zeros((L1 + 1, W), dtype=np.float32)
    if n == 0:
        return post
    ptrs = (ctypes.c_void_p * n)()
    pl1 = np.empty(n, dtype=np.int64)
    pl2 = np.empty(n, dtype=np.int64)
    pw = np.empty(n, dtype=np.int64)
    tf = np.empty(n, dtype=np.int32)
    m1_idx = np.empty(n, dtype=np.int64)
    m2_idx = np.empty(n, dtype=np.int64)
    keep = []  # hold refs so contiguous copies outlive the call
    for k, (P, i, j, transpose) in enumerate(pair_jobs):
        Pc = np.ascontiguousarray(P, dtype=np.float32)
        keep.append(Pc)
        ptrs[k] = Pc.ctypes.data
        m1_idx[k] = i
        m2_idx[k] = j
        pl1[k] = len(m1s[i]) - 1
        pl2[k] = len(m2s[j]) - 1
        pw[k] = Pc.shape[1]
        tf[k] = 1 if transpose else 0
    m1_off = np.zeros(len(m1s), dtype=np.int64)
    off = 0
    for i, m in enumerate(m1s):
        m1_off[i] = off
        off += len(m)
    m1_cat = np.concatenate(m1s).astype(np.int64)
    m2_off = np.zeros(len(m2s), dtype=np.int64)
    off = 0
    for j, m in enumerate(m2s):
        m2_off[j] = off
        off += len(m)
    m2_cat = np.concatenate(m2s).astype(np.int64)
    lib.rtpu_build_posterior(
        post.ctypes.data,
        ctypes.c_int64(W),
        ctypes.cast(ptrs, ctypes.c_void_p),
        pl1.ctypes.data,
        pl2.ctypes.data,
        pw.ctypes.data,
        tf.ctypes.data,
        m1_idx.ctypes.data,
        m2_idx.ctypes.data,
        m1_cat.ctypes.data,
        m1_off.ctypes.data,
        m2_cat.ctypes.data,
        m2_off.ctypes.data,
        ctypes.c_int64(n),
    )
    return post


def refine_rounds_native(rows, mats_list, masks):
    """All iterative-refinement rounds of one MSA problem in one call
    (DoIterativeRefinement, Probcons.cc:1467-1490): project / scatter-add
    posteriors / MEA DP / re-merge, natively per round.

    rows: (N, L0) uint8 alignment matrix with row k = label k, '-' = gap.
    mats_list: dense float32 (la+1, lb+1) posterior matrices in (a < b)
    lexicographic pair order.  masks: (nrounds, N) uint8 bipartitions.
    Returns the refined (N, L) uint8 matrix, or None if the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    N, L0 = rows.shape
    masks = np.ascontiguousarray(masks, dtype=np.uint8)
    nrounds = masks.shape[0]
    n = len(mats_list)
    assert n == N * (N - 1) // 2
    ptrs = (ctypes.c_void_p * max(n, 1))()
    mrows = np.empty(max(n, 1), dtype=np.int64)
    mcols = np.empty(max(n, 1), dtype=np.int64)
    keep = []
    for k, P in enumerate(mats_list):
        Pc = np.ascontiguousarray(P, dtype=np.float32)
        keep.append(Pc)
        ptrs[k] = Pc.ctypes.data
        mrows[k] = Pc.shape[0]
        mcols[k] = Pc.shape[1]
    # merged columns always hold >=1 residue, so the total residue count
    # bounds every intermediate alignment length
    Lcap = max(int(L0), int(np.count_nonzero(rows != ord("-")))) + 1
    out = np.empty((N, Lcap), dtype=np.uint8)
    L = lib.rtpu_refine_rounds(
        rows.ctypes.data,
        ctypes.c_int64(N),
        ctypes.c_int64(L0),
        ctypes.cast(ptrs, ctypes.c_void_p),
        mrows.ctypes.data,
        mcols.ctypes.data,
        masks.ctypes.data,
        ctypes.c_int64(nrounds),
        out.ctypes.data,
        ctypes.c_int64(Lcap),
    )
    if L < 0:  # pragma: no cover
        return None
    return np.ascontiguousarray(out[:, :L])


def replay_pairwise_native(anchors, init_nodes, init_succ, init_pred):
    """Run the full pairwise graph-surgery replay in C (rtpu_replay_*).

    anchors: (A, 7) int64 in serial LIFO pop order.
    init_nodes: (ns, ne, off0, off1, nflags) arrays of the N initial
    nodes in dict-insertion order (markers: ns < 0, a unique sentinel
    each; nflags bit0/1 = has path0/1, bit2 = aligned).
    init_succ: (succ_cnt, succ_nbr, succ_mask) — per-node successor
    adjacency in dict order with the edge path masks.
    init_pred: (pred_cnt, pred_nbr) — per-node predecessor adjacency in
    dict order (resolves to the succ scan's edge objects).

    Returns (ns, ne, off0, off1, flags, succ_cnt, pred_cnt, succ_nbr,
    succ_eid, pred_nbr, pred_eid, edge_mask) — final nodes in
    dict-insertion order (marker rows keep their negative sentinels),
    adjacency in dict order, shared-edge ids for attribute-dict
    sharing.  None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    anchors = np.ascontiguousarray(anchors, dtype=np.int64)
    ns0, ne0, o0, o1 = (
        np.ascontiguousarray(a, dtype=np.int64) for a in init_nodes[:4]
    )
    nf = np.ascontiguousarray(init_nodes[4], dtype=np.uint8)
    sc, sn_, sm = init_succ
    pc, pn_ = init_pred
    sc = np.ascontiguousarray(sc, dtype=np.int64)
    sn_ = np.ascontiguousarray(sn_, dtype=np.int64)
    sm = np.ascontiguousarray(sm, dtype=np.uint8)
    pc = np.ascontiguousarray(pc, dtype=np.int64)
    pn_ = np.ascontiguousarray(pn_, dtype=np.int64)
    nn = ctypes.c_int64()
    nsu = ctypes.c_int64()
    npr = ctypes.c_int64()
    h = lib.rtpu_replay_pairwise(
        anchors.ctypes.data,
        ctypes.c_int64(len(anchors)),
        ns0.ctypes.data, ne0.ctypes.data,
        o0.ctypes.data, o1.ctypes.data, nf.ctypes.data,
        ctypes.c_int64(len(ns0)),
        sc.ctypes.data, sn_.ctypes.data, sm.ctypes.data,
        pc.ctypes.data, pn_.ctypes.data,
        ctypes.byref(nn), ctypes.byref(nsu), ctypes.byref(npr),
    )
    try:
        N, SU, PR = nn.value, nsu.value, npr.value
        E = lib.rtpu_replay_nedges(h)
        ns = np.empty(N, np.int64)
        ne = np.empty(N, np.int64)
        off0 = np.empty(N, np.int64)
        off1 = np.empty(N, np.int64)
        flags = np.empty(N, np.uint8)
        succ_cnt = np.empty(N, np.int64)
        pred_cnt = np.empty(N, np.int64)
        succ_nbr = np.empty(SU, np.int64)
        succ_eid = np.empty(SU, np.int64)
        pred_nbr = np.empty(PR, np.int64)
        pred_eid = np.empty(PR, np.int64)
        edge_mask = np.empty(E, np.uint8)
        lib.rtpu_replay_fetch(
            h,
            *(a.ctypes.data for a in (
                ns, ne, off0, off1, flags, succ_cnt, pred_cnt,
                succ_nbr, succ_eid, pred_nbr, pred_eid, edge_mask,
            )),
        )
    finally:
        lib.rtpu_replay_end(h)
    return (ns, ne, off0, off1, flags, succ_cnt, pred_cnt,
            succ_nbr, succ_eid, pred_nbr, pred_eid, edge_mask)


def pairhmm_post_batch_native(pairs, cutoff=0.01, nthreads=0):
    """All-pairs 5-state pair-HMM posteriors on host threads (scalar
    float32 DP; ProbabilisticModel.h:102-331 recurrences with exact
    logaddexp, Defaults.h params via hmm.pairhmm's log tables).

    pairs: [(seq1, seq2), ...] strings.  Returns
    [(post_cut, total, score), ...] where post_cut is the dense
    (L1+1, L2+1) float32 posterior already cutoff-sparsified
    (msa._sparsify semantics), total the log-probability, and score the
    MEA score of the full posterior (== msa._mea_dp_fast(post)[1]) —
    exactly the triple msa.batch_posteriors_cut's dense path returns.
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None or not pairs:
        return None if lib is None else []
    from ..hmm.pairhmm import (
        LOG_EMIT_PAIRS,
        LOG_EMIT_SINGLE,
        LOG_INIT,
        LOG_TRANS,
    )

    # unique-sequence table ('@'-prefixed, Sequence.h:50 convention)
    seq_ids = {}
    chunks = []
    offs = [0]
    pa = np.empty(len(pairs), np.int32)
    pb = np.empty(len(pairs), np.int32)
    for k, (s1, s2) in enumerate(pairs):
        for which, s in ((pa, s1), (pb, s2)):
            i = seq_ids.get(s)
            if i is None:
                i = len(seq_ids)
                seq_ids[s] = i
                chunks.append(b"@" + s.encode())
                offs.append(offs[-1] + len(s) + 1)
            which[k] = i
    seqs = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    offs = np.asarray(offs, dtype=np.int64)

    sizes = np.array(
        [(len(a) + 1) * (len(b) + 1) for a, b in pairs], dtype=np.int64
    )
    out_offs = np.zeros(len(pairs), dtype=np.int64)
    np.cumsum(sizes[:-1], out=out_offs[1:])
    out = np.empty(int(sizes.sum()), dtype=np.float32)
    tots = np.empty(len(pairs), dtype=np.float64)
    scores = np.empty(len(pairs), dtype=np.float64)
    li = np.ascontiguousarray(LOG_INIT, dtype=np.float32)
    lt = np.ascontiguousarray(LOG_TRANS, dtype=np.float32)
    les = np.ascontiguousarray(LOG_EMIT_SINGLE, dtype=np.float32)
    lep = np.ascontiguousarray(LOG_EMIT_PAIRS, dtype=np.float32)
    lib.rtpu_pairhmm_post_batch(
        seqs.ctypes.data, offs.ctypes.data, pa.ctypes.data, pb.ctypes.data,
        ctypes.c_int64(len(pairs)), out_offs.ctypes.data, out.ctypes.data,
        tots.ctypes.data, scores.ctypes.data, li.ctypes.data,
        lt.ctypes.data, les.ctypes.data, lep.ctypes.data,
        ctypes.c_float(cutoff), ctypes.c_int64(nthreads),
    )
    res = []
    for k, (s1, s2) in enumerate(pairs):
        shp = (len(s1) + 1, len(s2) + 1)
        p = out[out_offs[k] : out_offs[k] + sizes[k]].reshape(shp)
        res.append((p, float(tots[k]), float(scores[k])))
    return res


def msa_batch_native(
    problems,
    consistency=2,
    consgap=True,
    nrounds=100,
    seed=0,
    cutoff=0.01,
    nthreads=0,
):
    """Whole-MSA native batch: the complete per-bubble DoAlign pipeline
    (Probcons.cc:312-544 — posteriors, consistency, guide tree,
    progressive MEA, iterative refinement, column confidence) on host
    worker threads, one call for all bubbles of a refinement pass.

    problems: [[(name, seq), ...], ...].  Returns
    [([(name, gapped_seq), ...], conf_list) | None, ...] matching
    hmm.msa.probcons_align's output per problem (None = that problem
    failed; caller falls back).  None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not problems:
        return []
    if not hasattr(lib, "rtpu_msa_batch"):  # pragma: no cover
        return None
    from ..hmm.pairhmm import (
        LOG_EMIT_PAIRS,
        LOG_EMIT_SINGLE,
        LOG_INIT,
        LOG_TRANS,
    )

    chunks = []
    soffs = [0]
    boffs = [0]
    masks_chunks = []
    moffs = [0]
    ooffs = [0]
    coffs = [0]
    lcaps = []
    for aobjs in problems:
        N = len(aobjs)
        total = sum(len(s) for _n, s in aobjs)
        lcap = max(1, total)
        for _n, s in aobjs:
            chunks.append(b"@" + s.encode())
            soffs.append(soffs[-1] + len(s) + 1)
        boffs.append(boffs[-1] + N)
        # the refinement bipartition stream: identical rng call
        # sequence to probcons_align stage 5 (one draw per round)
        rng = np.random.default_rng(seed)
        m = (
            np.stack(
                [rng.integers(0, 2, size=N) for _ in range(nrounds)]
            ).astype(np.uint8)
            if nrounds and N > 1
            else np.zeros((nrounds, N), np.uint8)
        )
        masks_chunks.append(m.tobytes())
        moffs.append(moffs[-1] + nrounds * N)
        lcaps.append(lcap)
        ooffs.append(ooffs[-1] + N * lcap)
        coffs.append(coffs[-1] + lcap)
    seqs = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    soffs = np.asarray(soffs, dtype=np.int64)
    boffs = np.asarray(boffs, dtype=np.int64)
    masks = np.frombuffer(b"".join(masks_chunks), dtype=np.uint8)
    if len(masks) == 0:
        masks = np.zeros(1, dtype=np.uint8)
    moffs = np.asarray(moffs, dtype=np.int64)
    ooffs_a = np.asarray(ooffs[:-1], dtype=np.int64)
    coffs_a = np.asarray(coffs[:-1], dtype=np.int64)
    lcaps_a = np.asarray(lcaps, dtype=np.int64)
    out_rows = np.zeros(ooffs[-1], dtype=np.uint8)
    out_conf = np.zeros(coffs[-1], dtype=np.int32)
    out_lens = np.zeros(len(problems), dtype=np.int64)
    li = np.ascontiguousarray(LOG_INIT, dtype=np.float32)
    lt = np.ascontiguousarray(LOG_TRANS, dtype=np.float32)
    les = np.ascontiguousarray(LOG_EMIT_SINGLE, dtype=np.float32)
    lep = np.ascontiguousarray(LOG_EMIT_PAIRS, dtype=np.float32)
    rc = lib.rtpu_msa_batch(
        seqs.ctypes.data, soffs.ctypes.data, boffs.ctypes.data,
        ctypes.c_int64(len(problems)), masks.ctypes.data,
        moffs.ctypes.data, ctypes.c_int64(consistency),
        ctypes.c_int(1 if consgap else 0), ctypes.c_int64(nrounds),
        li.ctypes.data, lt.ctypes.data, les.ctypes.data,
        lep.ctypes.data, ctypes.c_float(cutoff), out_rows.ctypes.data,
        ooffs_a.ctypes.data, lcaps_a.ctypes.data, out_lens.ctypes.data,
        out_conf.ctypes.data, coffs_a.ctypes.data,
        ctypes.c_int64(nthreads),
    )
    if rc != 0:  # pragma: no cover
        return None
    res = []
    for b, aobjs in enumerate(problems):
        L = int(out_lens[b])
        if L < 0:
            res.append(None)
            continue
        N = len(aobjs)
        lcap = lcaps[b]
        rows = out_rows[ooffs[b] : ooffs[b] + N * lcap].reshape(N, lcap)
        aln = [
            (aobjs[k][0], rows[k, :L].tobytes().decode("latin1"))
            for k in range(N)
        ]
        conf = [int(c) for c in out_conf[coffs[b] : coffs[b] + L]]
        res.append((aln, conf))
    return res
