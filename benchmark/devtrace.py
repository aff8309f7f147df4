"""What one profiled job did on the card, read from ``torch.profiler``.

Counting follows the port's ``chip_smoke.py`` (``trace_counts``): one pass
over the raw kineto events, without building the profiler's event tree,
which takes minutes at the multi loop's half a million launches.  Unlike
``chip_smoke.py``, the device's busy time is the union of the intervals in
which a kernel, a copy or a memset ran, not the sum of their durations, so
that work on two streams at once is not counted twice.
"""

from __future__ import annotations

import numpy as np

# the runtime calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchKernelExC")
SYNC_CALL = "cudaStreamSynchronize"
JOB = "job"
# a kernel's name in the breakdown: its head (templated names run to
# thousands of characters)
NAME_CHARS = 120


def union_intervals(starts, ends):
    """Disjoint, sorted (starts, ends) covering the same time."""
    if len(starts) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(starts, kind="stable")
    s = np.asarray(starts, np.int64)[order]
    e = np.asarray(ends, np.int64)[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.nonzero(new)[0]
    last = np.r_[first[1:] - 1, len(s) - 1]
    return s[first], reach[last]


def clip(starts, ends, lo, hi):
    s = np.clip(starts, lo, hi)
    e = np.clip(ends, lo, hi)
    keep = e > s
    return s[keep], e[keep]


def read_events(events, span_labels):
    """Sort the raw events of a finished profile into the job's window,
    the device's intervals and kernel times, the host's launch and sync
    calls, and the benchmark's span ranges."""
    window = None
    dev_s, dev_e, kernels = [], [], {}
    launches = syncs = 0
    spans = []
    for evt in events:
        name = evt.name()
        if str(evt.device_type()).endswith("CUDA"):
            if evt.is_user_annotation() or name in span_labels or name == JOB:
                continue  # a range's shadow on the device timeline
            t, d = evt.start_ns(), evt.duration_ns()
            dev_s.append(t)
            dev_e.append(t + d)
            sec, n = kernels.get(name, (0.0, 0))
            kernels[name] = (sec + d / 1e9, n + 1)
            continue
        if name == JOB:
            window = (evt.start_ns(), evt.start_ns() + evt.duration_ns())
        elif name in span_labels:
            spans.append((evt.start_ns(), evt.start_ns() + evt.duration_ns(),
                          name))
        elif name in LAUNCH_CALLS:
            launches += 1
        elif name == SYNC_CALL:
            syncs += 1
    return {
        "window": window, "dev_s": np.asarray(dev_s, np.int64),
        "dev_e": np.asarray(dev_e, np.int64), "kernels": kernels,
        "launches": launches, "syncs": syncs, "spans": spans,
    }


def busy_before(us, ue, t):
    """Busy nanoseconds of the union intervals (us, ue) before each
    instant of ``t``."""
    if len(us) == 0:
        return np.zeros(len(t), np.int64)
    cum = np.r_[0, np.cumsum(ue - us)]
    k = np.searchsorted(us, t, side="right")
    over = np.where(k > 0, np.maximum(ue[np.maximum(k - 1, 0)] - t, 0), 0)
    return cum[k] - over


def idle_by_span(spans, us, ue, lo, hi):
    """The window's idle seconds by what the host was doing: the window is
    cut at every span's ends, each piece goes to the innermost span that
    holds it (``job`` if none), and a piece's idle time is its length less
    the busy time inside it."""
    cuts = np.unique(np.clip(np.array(
        [lo, hi] + [x for s, e, _n in spans for x in (s, e)], np.int64),
        lo, hi))
    mids = (cuts[:-1] + cuts[1:]) // 2
    names = [JOB]
    label = np.zeros(len(mids), np.int64)
    for s, e, name in sorted(spans, key=lambda x: x[0] - x[1]):
        if name not in names:
            names.append(name)
        label[(mids >= s) & (mids < e)] = names.index(name)
    busy = busy_before(us, ue, cuts)
    idle = np.diff(cuts) - np.diff(busy)
    per = np.bincount(label, weights=idle / 1e9, minlength=len(names))
    return {name: float(per[k]) for k, name in enumerate(names) if per[k]}


def summarize(raw, top=10):
    """The job's window and busy seconds, launches, kernel seconds by name,
    the top device operations and the idle time by what the host did."""
    lo, hi = raw["window"]
    s, e = clip(raw["dev_s"], raw["dev_e"], lo, hi)
    us, ue = union_intervals(s, e)
    busy_ns = int((ue - us).sum())
    idle = idle_by_span(raw["spans"], us, ue, lo, hi)
    device_ops = sorted(((sec, name) for name, (sec, _n)
                         in raw["kernels"].items()), reverse=True)
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy_ns / 1e9,
        "device_sum_s": float((e - s).sum()) / 1e9,
        "launches": raw["launches"],
        "host_syncs": raw["syncs"],
        "kernels": raw["kernels"],
        "device_ops": [[name[:NAME_CHARS], sec]
                       for sec, name in device_ops[:top]],
        "idle_gaps": sorted(([name, sec] for name, sec in idle.items()),
                            key=lambda x: -x[1])[:top],
    }


def kernel_seconds(trace, fragment):
    """Device seconds and launches of the kernels whose name holds
    ``fragment``."""
    sec = n = 0
    for name, (s, k) in trace["kernels"].items():
        if fragment in name:
            sec += s
            n += k
    return sec, n
