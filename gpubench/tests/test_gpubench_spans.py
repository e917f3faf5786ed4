"""The per-layer metrics that read the program's spans and counters
(``gpubench/spans.py``), installed and read as a traced run does, on the CPU
at a tiny size: each reads a finite number in the cells the manifest lists
it in and nothing elsewhere; the loop's idle share sets the trace's kernels
against the spans on their shared clock."""

import math
from types import SimpleNamespace

import pytest
import torch

from gpubench import core
from gpubench.tests.test_gpubench_reference import tiny
from gpubench.trace import Trace, Tracer

CPU = torch.device("cpu")
MANIFEST = core.load_manifest()
SPAN_METRICS = [m for m in MANIFEST["per_layer"]
                if m["source"] in ("program_span", "program_counter")]
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def fake_trace(calls: int, kernels: list) -> Trace:
    return Trace(calls, 1.0, 0.5, kernels, [], [], {}, {})


@pytest.fixture(scope="module", params=CELLS)
def traced(request):
    """A cell at a tiny size: its set-up, every span metric installed, then
    two requests (one in the joint cell) as the traced segment."""
    from brdf_tpu_torch.utils import profiling

    cell = tiny(request.param)
    entry = core.entry_module(cell).Entry(cell, 2**31 + 7, CPU)
    entry.traffic = dict(entry.traffic, warm_calls=0, pool=1)
    entry.pool = 1
    entry.setup()
    tracer = Tracer()
    for m in SPAN_METRICS:
        core.metric_module(m["name"]).install(tracer)
    calls = 1 if cell.traffic["entry"] == "fit_joint_normalmap" else 2
    for i in range(calls):
        entry.request(i)
    records = dict(tracer.records)
    yield cell, calls, records
    profiling.enable(False)
    profiling.reset()


def test_each_metric_reads_where_it_is_listed(traced):
    cell, calls, records = traced
    run = SimpleNamespace(trace=fake_trace(calls, []), window=None)
    run.trace.records.update(records)
    for m in SPAN_METRICS:
        value = core.metric_module(m["name"]).read(run)
        if cell.name in m["workloads"]:
            assert value is not None and math.isfinite(value), m["name"]
        else:
            assert value is None, m["name"]


def test_loop_metrics_in_the_joint_cell(traced):
    from brdf_tpu_torch.utils import profiling

    cell, calls, records = traced
    if cell.traffic["entry"] != "fit_joint_normalmap":
        pytest.skip("the eager loop runs in the joint cell alone")
    passes = [s for s in profiling.records() if s.name == "lm.pass"]
    # one kernel over the first half of every pass: the device idles half of it
    kernels = [("k", s.start_ns * 1e-9, (s.end_ns - s.start_ns) * 0.5e-9) for s in passes]
    run = SimpleNamespace(trace=fake_trace(calls, kernels), window=None)
    run.trace.records.update(records)

    def read(name):
        return core.metric_module(name).read(run)

    assert read("host_syncs_per_fit") == len(passes) + 3
    assert read("loop_idle_share") == pytest.approx(50.0, abs=1e-3)
    assert 0.0 < read("loop_active_share") <= 100.0
    assert read("loop_pass_ms") == pytest.approx(
        sum(s.end_ns - s.start_ns for s in passes) * 1e-6 / len(passes))
    run.trace = fake_trace(calls, [])
    run.trace.records.update(records)
    assert read("loop_idle_share") == 100.0


def test_no_reading_without_a_trace():
    run = SimpleNamespace(trace=None, window=None)
    for m in SPAN_METRICS:
        assert core.metric_module(m["name"]).read(run) is None
