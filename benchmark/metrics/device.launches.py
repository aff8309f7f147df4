"""device.launches (count a job; layer device): the kernel launches of
one profiled job (runtime launch calls in the ``torch.profiler``
trace)."""


def read(run):
    t = run.trace
    if not t or not t["launches"]:
        return None
    return t["launches"]
