"""repair_pass_roofline (%; layer index.repair, kernel ``repair_pass``):
the least time of the profiled job's repair passes over their device time.

Least time = bytes / HBM bandwidth (3.35 TB/s on an H100 SXM; ``peaks``).
Bytes, each counted at most once: 24 for each distinct slot that a pass
moved (its SA, LCP and BWT words read and written), and 16 for each
candidate applied (its ``cq`` and ``centry_next`` entries and the ``beg``
and ``SEG`` words at its slot).  The words a candidate reads at a slot
that no mover touches are left out, so the bytes are a lower bound.  The
distinct moved slots of a pass are the slots whose SA word the launch
changed: the probe keeps a copy of SA on the card before each launch of
``index.repair.repair_segments`` and counts the changed slots there after
it (three device operations a pass, in the profiled job; read after the
job).  The candidates are the job's ``devloop.LAST_STATS
["repair_applied"]`` (the kernel's own counter); the device time is that
of the kernels named ``repair_pass_kernel`` in the trace."""

from benchmark import devtrace, peaks

STATS = ("reveal_tpu_torch.index.devloop",)


def _note(args, kw, notes):
    before = (args[0] if args else kw["SA"]).clone()

    def after(result):
        notes.setdefault("repair_moved", []).append(
            (result[0] != before).sum())
    return after


PROBES = (("reveal_tpu_torch.index.repair", "repair_segments", _note),)


def read(run):
    t = run.trace
    bw = peaks.hbm_bytes_per_s(run.device_kind)
    if not t or bw is None:
        return None
    sec, _n = devtrace.kernel_seconds(t, "repair_pass_kernel")
    st = t["job"]["stats"].get("devloop", {})
    moved = t["notes"].get("repair_moved", [])
    if not sec or not moved or "repair_applied" not in st:
        return None
    nbytes = 24 * sum(int(m) for m in moved) + 16 * int(st["repair_applied"])
    if nbytes <= 0:
        return None
    return 100.0 * nbytes / bw / sec
