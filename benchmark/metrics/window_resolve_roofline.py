"""window_resolve_roofline (%; layer index.window_resolve, kernel
``window_resolve``): the least time of the profiled job's window-resolve
launches over their device time.

Least time = bytes / HBM bandwidth (3.35 TB/s on an H100 SXM; ``peaks``).
Bytes, for each launch, counted once each, over its live rows: the LCP
words of the union of their windows ``[q - wrv, q)`` (4 bytes a word;
rows whose windows overlap share their words), and each live row's q, thr
and result (4 bytes each).  A launch has RBV rows, of which the first
hold the round's pending candidates, each at its own slot; the rest are
padding, at the repair queue's pad slot ``npad - 1`` (``repair_queue``
pads with it; a full queue's last candidate stands in for it, and the
distinct slots count it once).  So the live rows are the launch's
distinct q below ``npad - 1``.  The windows come from what
``index.window_resolve.window_resolve`` receives: the probe keeps a
reference to each launch's ``q`` (no copy, no launch) and the reader
reads them after the job.  The device time is that
of the kernels named ``window_resolve_kernel`` in the trace."""

import numpy as np

from benchmark import devtrace, peaks


def _note(args, kw, notes):
    lcp = args[0] if args else kw["lcp"]
    q = args[1] if len(args) > 1 else kw["q"]
    wrv = args[3] if len(args) > 3 else kw.get("wrv", 256)
    notes.setdefault("window_resolve", []).append((q, int(wrv),
                                                   lcp.numel()))


PROBES = (("reveal_tpu_torch.index.window_resolve", "window_resolve",
           _note),)


def launch_bytes(q, wrv, npad):
    """Bytes one launch needs: the union of its live rows' windows' LCP
    words, and q, thr and the result of each live row."""
    q = np.unique(np.asarray(q, np.int64))
    q = q[q < npad - 1]
    rows = len(q)
    lo = np.clip(q - wrv, 0, npad)
    hi = np.clip(q, 0, npad)
    # windows sorted by their end, each as long as wrv: a window adds the
    # part of it past the previous window's end
    start = np.maximum(lo, np.r_[0, hi[:-1]])
    words = int(np.clip(hi - start, 0, None).sum())
    return 4 * words + 12 * rows


def read(run):
    t = run.trace
    bw = peaks.hbm_bytes_per_s(run.device_kind)
    if not t or bw is None:
        return None
    sec, _n = devtrace.kernel_seconds(t, "window_resolve_kernel")
    launches = t["notes"].get("window_resolve", [])
    nbytes = sum(launch_bytes(q.cpu().numpy(), wrv, npad)
                 for q, wrv, npad in launches)
    if not sec or nbytes <= 0:
        return None
    return 100.0 * nbytes / bw / sec
