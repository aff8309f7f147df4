"""One run of one cell: set-up, the measured window, the traced job and
the check against the plain reference.

A run is a closed loop of one client: job after job, each the CLI command
that the traffic mix names (``commands/<command>.py``) called in-process
as a user calls it, with the configuration's options, its output written
to disk.  The jobs take in turn a pool of distinct inputs made once from
the seed (the traffic mix says how many).  Set-up (import, the CUDA
context, loading or building the program's native library and kernels,
the fastas, and one untimed warm-up job on a smaller input of the same
configuration) ends where the first timed job starts; the window ends at
the end of the first job that finishes after ``--seconds`` (and not
before every input of the pool has had a job).  With ``--trace 1`` the
window's jobs run under the benchmark's spans and one more job runs under
``torch.profiler``; the per-layer metrics are read from them.  Then the
output of every timed job is held to the reference's on its input
(``compare.py``), the references of the pool's inputs computed side by
side in processes of their own.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

from . import cells, commands, compare, devtrace, genomes
from .readers import route_of
from .spans import Spans

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "reveal_tpu")
# the warm-up job's genomes, as a share of the configuration's length:
# it loads every library and kernel of the route, and carries little of
# the host's drift into set-up
WARM_SHARE = 0.125
# the port's hand-written kernels on rem's routes, by their names in a trace
PORT_KERNELS = ("repair_pass_kernel", "window_resolve_kernel")


class NoCard(RuntimeError):
    pass


def process_seconds():
    """Seconds since this process started (Linux: ``/proc``)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as fh:
        return float(fh.read().split()[0]) - start


def forbidden_modules():
    return sorted(m for m in sys.modules
                  if m.split(".", 1)[0] in FORBIDDEN)


class Run:
    """What the metric readers see: the jobs of the window (each
    with its seconds, input bases, span seconds, the program's
    ``LAST_STATS`` and its route), the set-up, and the profiled job's
    trace (``--trace 1``)."""

    def __init__(self, device_kind):
        self.device_kind = device_kind
        self.setup_s = None
        self.jobs = []
        self.trace = None

    @property
    def window_s(self):
        return self.jobs[-1]["t1"] - self.jobs[0]["t0"]


class Program:
    """The system under test, reached through its CLI and its counters
    (the ``LAST_STATS`` of the modules that the metric readers name in
    their ``STATS``)."""

    def __init__(self, device, stats_modules=()):
        self.device = device
        self.cli = importlib.import_module("reveal_tpu_torch.cli")
        self.stats = {name.rsplit(".", 1)[-1]: importlib.import_module(
            name).LAST_STATS for name in stats_modules}

    def job(self, argv, out):
        """One job: returns (t0, t1, its output file's bytes or None, the
        counters, the error or None)."""
        for st in self.stats.values():
            st.clear()
        if os.path.exists(out):
            os.remove(out)
        err = None
        t0 = time.perf_counter()
        try:
            rc = self.cli.main(argv)
            if rc:
                err = "%s exited %s" % (argv[0], rc)
        except Exception:  # a failed job is counted, the loop goes on
            err = traceback.format_exc()
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()
        t1 = time.perf_counter()
        data = None
        if err is None and os.path.exists(out):
            with open(out, "rb") as fh:
                data = fh.read()
        stats = {k: dict(v) for k, v in self.stats.items()}
        return t0, t1, data, stats, err


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return "nvidia-smi not available (%s)" % exc


def _install_probes(readers):
    """Wrap the launchers whose arguments the metric readers ask to see
    (their ``PROBES``: (module, attribute, fn(args, kw, notes)), where fn
    notes what it needs in the dict ``notes`` and may return a function
    that is handed the launcher's result); returns (notes, undo list)."""
    notes, undo = {}, []
    for mod in readers:
        for module, attr, fn in getattr(mod, "PROBES", ()):
            owner = importlib.import_module(module)
            raw = getattr(owner, attr)

            def probe(*args, _raw=raw, _fn=fn, **kw):
                after = _fn(args, kw, notes)
                result = _raw(*args, **kw)
                if after is not None:
                    after(result)
                return result
            setattr(owner, attr, probe)
            undo.append((owner, attr, raw))
    return notes, undo


def profile_job(program, spans, readers, argv, out):
    """One job under ``torch.profiler``: (the job's record, its trace
    summary)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if program.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    notes, undo = _install_probes(readers)
    spans.profiling = True
    try:
        with profile(activities=acts) as prof:
            with record_function(devtrace.JOB):
                rec = program.job(argv, out)
    finally:
        spans.profiling = False
        for owner, attr, raw in reversed(undo):
            setattr(owner, attr, raw)
    raw = devtrace.read_events(prof.profiler.kineto_results.events(),
                               spans.labels | {devtrace.JOB})
    del prof
    trace = devtrace.summarize(raw)
    trace["notes"] = notes
    return rec, trace


def stats_modules(mods):
    """The modules whose ``LAST_STATS`` the readers ``mods`` name."""
    out = []
    for mod in mods:
        out += [m for m in getattr(mod, "STATS", ()) if m not in out]
    return out


def references(command, pool, options, workdir):
    """The reference's output on every input of the pool, side by side in
    spawned processes (NumPy on the host; nothing of the program)."""
    import multiprocessing

    jobs = [(command, fastas, os.path.join(workdir, "reference%d" % i
                                           + commands.load(command).OUTPUT),
             options) for i, (fastas, _bases) in enumerate(pool)]
    procs = max(1, min(len(jobs), (os.cpu_count() or 2) // 2))
    pool_ = multiprocessing.get_context("spawn").Pool(procs)
    try:
        return pool_.starmap(commands.reference_job, jobs)
    finally:
        pool_.close()
        pool_.join()


def run_cell(cell, seed, seconds, trace, device="cuda", log=print):
    """Everything of one run but the exit: returns the result's dict.
    Prints what it learns on the way with ``log``."""
    # every reader of the cell names the counters it reads; the run's
    # mode reports its own metrics
    readers = {m["name"]: cells.load_reader(m["name"], cell.here)
               for m in cell.end_to_end + cell.per_layer}
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is False (torch %s)"
                         % torch.__version__)
        if torch.cuda.device_count() < cell.chips:
            raise NoCard("the cell needs %d cards, torch sees %d"
                         % (cell.chips, torch.cuda.device_count()))
        torch.cuda.init()
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    name = cell.traffic["command"]
    command = commands.load(name)
    options = cell.config.get("options", {})
    extra = cell.traffic.get("args", [])
    program = Program(device, stats_modules(readers.values()))
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        # the run's inputs: a pool of distinct ones, each from the seed,
        # that the jobs take in turn; the warm-up's smaller input after
        # them
        pool = []
        for i in range(int(cell.traffic.get("inputs", 1))):
            d = os.path.join(workdir, "in%d" % i)
            os.mkdir(d)
            pool.append(genomes.write_inputs(cell.config, cell.traffic,
                                             seed, d, index=i))
        d = os.path.join(workdir, "warm")
        os.mkdir(d)
        warm_config = dict(cell.config, genome_bp=max(
            1, int(cell.config["genome_bp"] * WARM_SHARE)))
        warm, _bases = genomes.write_inputs(warm_config, cell.traffic, seed,
                                            d, index=len(pool))
        prefix = os.path.join(workdir, "job")
        out = prefix + command.OUTPUT
        argvs = [command.argv(fastas, prefix, options, extra, device)
                 for fastas, _b in pool]
        run = Run(kind)
        # each input's outputs by their digest (one copy of each kind)
        outputs = [{} for _ in pool]
        errors = []

        def keep(rec, i):
            text = compare.text_of(rec[2])
            key = None if text is None else hashlib.sha256(text).digest()
            held = outputs[i].setdefault(key, [text, 0])
            held[1] += 1
            if rec[4]:
                errors.append(rec[4])

        rec = program.job(command.argv(warm, prefix, options, extra, device),
                          out)
        if rec[4]:
            errors.append(rec[4])
        log("warm-up: %.6f s, route %s" % (rec[1] - rec[0],
                                           route_of(rec[3])))
        spans = Spans()
        if trace:
            spans.install()
            for mod in readers.values():
                spans.install(getattr(mod, "SPANS", ()))
            spans.take()
        try:
            run.setup_s = process_seconds()
            t_first = time.perf_counter()
            # at least one job on every input of the pool
            while (len(run.jobs) < len(pool)
                   or time.perf_counter() - t_first < seconds):
                i = len(run.jobs) % len(pool)
                rec = program.job(argvs[i], out)
                t0, t1, _data, stats, _err = rec
                run.jobs.append({"t0": t0, "t1": t1, "seconds": t1 - t0,
                                 "bases": pool[i][1], "input": i,
                                 "spans": spans.take(), "stats": stats,
                                 "route": route_of(stats)})
                keep(rec, i)
            peak = (torch.cuda.max_memory_allocated(0)
                    if device == "cuda" else 0)
            if trace:
                rec, run.trace = profile_job(program, spans,
                                             readers.values(), argvs[0], out)
                run.trace["job"] = {"spans": spans.take(), "stats": rec[3],
                                    "route": route_of(rec[3])}
                keep(rec, 0)
        finally:
            spans.remove()

        routes = sorted({j["route"] for j in run.jobs})
        log("cell %s, seed %d: %d jobs of %d bases in %.6f s (%s); job "
            "seconds %s; inputs %s; set-up %.6f s; route %s; device %s, "
            "memory peak %d"
            % (cell.name, seed, len(run.jobs),
               sum(j["bases"] for j in run.jobs), run.window_s,
               "traced" if trace else "untraced",
               " ".join("%.6f" % j["seconds"] for j in run.jobs),
               " ".join(str(j["input"]) for j in run.jobs),
               run.setup_s, "; ".join(routes), kind, peak))
        if device == "cuda":
            log("card: %s" % card_line())
        if run.trace:
            t = run.trace
            log("profiled job: %.6f s, device busy %.6f s (union; %.6f s "
                "summed), %d launches, %d host syncs, route %s; the port's "
                "kernels: %s"
                % (t["window_s"], t["busy_s"], t["device_sum_s"],
                   t["launches"], t["host_syncs"], t["job"]["route"],
                   ", ".join("%s %.6f s in %d launches" % (
                       k, *devtrace.kernel_seconds(t, k))
                       for k in PORT_KERNELS)))
        for err in errors[:3]:
            print(err, file=sys.stderr)

        metrics = {}
        for m in cell.metrics(trace):
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        # the check: the program's state freed, the references on the host
        program = None
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        wants = [compare.text_of(w) for w in
                 references(name, pool, options, workdir)]
        log("reference: %d inputs, %s jobs on them, %.6f s, %s bytes of "
            "output" % (len(pool), "/".join(
                str(sum(n for _t, n in o.values())) for o in outputs),
                time.perf_counter() - t0,
                "/".join(str(len(w)) for w in wants)))
        checks = compare.judge([(text, n, want) for o, want in
                                zip(outputs, wants) for text, n in o.values()])
        checks["jobs_failed"] = (len(errors), 0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    result = {
        "correct": compare.passes(checks),
        "attempted": len(run.jobs) + 1 + (run.trace is not None),
        "failed": len(errors),
        "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": peak},
    }
    if run.trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}
    return result


def main(args, root):
    """Run the cell and print the result; returns the exit code."""
    try:
        cell = cells.Cell(args.workload, root)
        result = run_cell(cell, args.seed, args.seconds, args.trace)
    except NoCard as exc:
        print("no result: %s" % exc, file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print("no result: the run loaded %s" % ", ".join(bad),
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print("%s %s limit %s" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
