"""Repair insertion-point search (one call per batched repair round).

    y[r] = max{ j in [q[r] - wrv, q[r]) : j >= 0, LCP[j] < thr[r] }, or -1

``window_resolve`` is the wrapper: on a CUDA tensor it launches the CUDA
kernel ``csrc/window_resolve.cu`` (the port of the Pallas TPU kernel
``reveal_tpu/index/devloop.py:_make_window_resolve``); on a CPU tensor it
runs ``window_resolve_plain``.  There is no other route between the two.
"""

from __future__ import annotations

import torch

from ..kernels import build

# kernel launches made by window_resolve (CUDA tensors only)
LAUNCHES = 0


def window_resolve_plain(lcp, q, thr, wrv: int = 256):
    """Plain torch version: the exact XLA-gather path of the JAX package
    (reveal_tpu/index/devloop.py, the repair round's window fetch)."""
    offs = torch.arange(1, wrv + 1, dtype=torch.int32, device=lcp.device)
    widx = q[:, None] - offs[None, :]
    lcpw = lcp[widx.clamp(min=0)]
    cand = (widx >= 0) & (lcpw < thr[:, None])
    return torch.where(cand, widx, -1).amax(dim=1)


def _check(lcp, q, thr, wrv):
    for name, t in (("lcp", lcp), ("q", q), ("thr", thr)):
        if t.dtype != torch.int32:
            raise TypeError("%s must be int32, got %s" % (name, t.dtype))
        if t.dim() != 1:
            raise ValueError("%s must be 1-D, got %s" % (name, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != lcp.device:
            raise ValueError(
                "%s is on %s, lcp on %s" % (name, t.device, lcp.device)
            )
    if q.shape != thr.shape:
        raise ValueError(
            "q %s and thr %s differ in shape"
            % (tuple(q.shape), tuple(thr.shape))
        )
    if lcp.numel() < 1 or lcp.numel() >= 2**31:
        raise ValueError("lcp length %d out of range" % lcp.numel())
    if not 1 <= wrv < 2**31:
        raise ValueError("wrv %d out of range" % wrv)


def window_resolve(lcp, q, thr, wrv: int = 256):
    """Insertion points for a batch of repair candidates.

    ``lcp``: (npad,) int32; ``q``, ``thr``: (RBV,) int32 with
    0 <= q <= npad; returns (RBV,) int32 on the same device."""
    global LAUNCHES
    _check(lcp, q, thr, wrv)
    if lcp.device.type == "cpu":
        return window_resolve_plain(lcp, q, thr, wrv)
    if lcp.device.type != "cuda":
        raise ValueError("unsupported device %s" % lcp.device)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = build.load_library()
    with torch.cuda.device(lcp.device):
        stream = torch.cuda.current_stream(lcp.device).cuda_stream
        err = lib.rtt_window_resolve_i32(
            lcp.data_ptr(), lcp.numel(), q.data_ptr(), thr.data_ptr(),
            out.data_ptr(), q.numel(), wrv, stream,
        )
    build.check(err, "window_resolve")
    LAUNCHES += 1
    return out
