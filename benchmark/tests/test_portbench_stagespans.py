"""The readers of the program's stage spans, on a synthetic run, and the
profiled job's trace read with and without the program's labels."""

import sys

import pytest

from conftest import ROOT

sys.path.insert(0, ROOT)

from benchmark import cells, devtrace, harness, stagespans  # noqa: E402
from reveal_tpu_torch.core import trace  # noqa: E402

TRACED = ("fasta_read_s", "gfa_write_s", "replay_s", "sync_wait_s",
          "multi_repair_s", "multi_chain_s", "multi_trim_s")


def _job(route, trace=None, devloop=None):
    stats = {"devloop": devloop or {}}
    if trace is not None:
        stats["trace"] = trace
    return {"route": route, "stats": stats, "spans": {}}


def test_readers_on_a_synthetic_run():
    run = harness.Run("cpu")
    run.jobs = [
        _job("multi", {"job": 1, "reads": 10, "wait": 0.5, "rem.read": 0.1,
                       "rem.write": 0.3, "rem.replay": 0.2,
                       "multi.repair": 4.0, "multi.chain": 2.0,
                       "multi.trim": 1.0}),
        _job("multi", {"job": 2, "reads": 12, "wait": 0.7, "rem.read": 0.3,
                       "rem.write": 0.5, "rem.replay": 0.4,
                       "multi.repair": 6.0, "multi.chain": 3.0,
                       "multi.trim": 2.0}),
        # a forest job: no multi stage, counted 0 in the all-route means
        _job("forest", {"job": 3, "reads": 0, "wait": 0.0, "rem.read": 0.2,
                        "rem.write": 0.1}, {"host_syncs": 70}),
        _job("forest", {"job": 4, "reads": 0, "wait": 0.3, "rem.read": 0.1,
                        "rem.write": 0.1, "rem.replay": 0.3},
             {"host_syncs": 90}),
    ]
    want = {"fasta_read_s": 0.175, "gfa_write_s": 0.25, "replay_s": 0.225,
            "sync_wait_s": 0.375, "multi_repair_s": 5.0, "multi_chain_s": 2.5,
            "multi_trim_s": 1.5, "forest_host_syncs": 80.0}
    for name, value in want.items():
        reader = cells.load_reader(name)
        assert reader.read(run) == pytest.approx(value), name
        if name in TRACED:
            assert stagespans.MODULE in reader.STATS
    # a run without tracing (or a program without the module) reads None
    run.jobs = [_job("multi"), _job("forest")]
    for name in want:
        assert cells.load_reader(name).read(run) is None, name


def test_spans_switch_tracing_for_the_traced_run_only():
    reader = cells.load_reader("multi_chain_s")
    assert getattr(reader, "PROBES", ())
    was = trace.enable(False)
    try:
        table = reader.SPANS
        assert trace.ON
        assert {label for _m, _a, label in table} == set(trace.LABELS)
        for module, attr, fn in reader.PROBES:
            assert (module, attr) == ("reveal_tpu_torch.cli", "main")
            fn((), {}, {})(0)
        assert not trace.ON
        with pytest.raises(AttributeError):
            reader.NO_SUCH_NAME
    finally:
        trace.enable(was)


class _Event:
    def __init__(self, name, start, dur, device="CPU", annotation=False):
        self._name, self._start, self._dur = name, start, dur
        self._device, self._annotation = device, annotation

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType." + self._device

    def is_user_annotation(self):
        return self._annotation

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur


def test_program_labels_change_no_device_number():
    """The same events read with the benchmark's labels and with the
    program's added: the same busy seconds, launches and kernel seconds;
    the idle time goes to the program's stages."""
    events = [
        _Event(devtrace.JOB, 0, 1000),
        _Event("multi_loop", 100, 800),
        _Event("multi.chain", 150, 300),
        _Event("multi.repair", 500, 300),
        # the ranges' shadows on the device timeline
        _Event("multi.chain", 160, 200, "CUDA", annotation=True),
        _Event("multi_loop", 120, 700, "CUDA", annotation=True),
        _Event("cudaLaunchKernel", 200, 5),
        _Event("cudaLaunchKernel", 600, 5),
        _Event("cudaStreamSynchronize", 610, 50),
        _Event("elementwise_kernel", 210, 40, "CUDA"),
        _Event("window_resolve_kernel", 620, 30, "CUDA"),
    ]
    plain = devtrace.summarize(devtrace.read_events(
        events, {"multi_loop", devtrace.JOB}))
    labelled = devtrace.summarize(devtrace.read_events(
        events, {"multi_loop", devtrace.JOB} | set(trace.LABELS)))
    for key in ("busy_s", "launches", "host_syncs", "kernels", "window_s",
                "device_sum_s", "device_ops"):
        assert plain[key] == labelled[key], key
    assert plain["busy_s"] == pytest.approx(70e-9)
    gaps = dict(labelled["idle_gaps"])
    assert set(gaps) == {"job", "multi_loop", "multi.chain", "multi.repair"}
    assert gaps["multi.chain"] == pytest.approx(260e-9)
    assert gaps["multi.repair"] == pytest.approx(270e-9)
    assert dict(plain["idle_gaps"])["multi_loop"] == pytest.approx(730e-9)
