"""device.idle_pct (%; layer device): the share of one profiled job's
wall time in which no kernel, copy or memset ran on the card (the union
of the device's intervals in the ``torch.profiler`` trace, clipped to the
job)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
