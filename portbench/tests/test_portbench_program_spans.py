"""The port's own spans in traced runs: what ``run_cell`` collects agrees
with the benchmark's spans taken from outside, the five readers on
hand-made spans, and a traced run without the port's tracer."""
import sys
import time
from types import SimpleNamespace

import pytest

from portbench import harness, trace

READERS = ("tick_prep_ms", "sched_self_ms", "commit_wait_share", "query_wait_p95_ms",
           "drive_lock_wait_ms")


@pytest.fixture
def traced_on_cpu(monkeypatch):
    """Traced runs on the CPU: the device trace keeps its window and its
    switch of the port's tracer, and profiles nothing."""
    for name in ("_begin", "_sync", "_read"):
        monkeypatch.setattr(trace.DeviceTrace, name, lambda self: None)


def _traced(tiny_run, cell):
    run = tiny_run(cell, seconds=6.0, seed=2**31 + 31)
    run.trace = True
    return run, harness.run_cell(run, time.perf_counter())


@pytest.mark.parametrize("cell", ["dsmoe-chat", "glm-longdoc"])
def test_collected_spans_agree_with_spans_taken_from_outside(tiny_run, traced_on_cpu, cell):
    """Every ``decode.tick`` with active lanes is an outside ``engine.tick``
    with the same positions, one for one; every ``prefill.dispatch`` (not a
    chunk's resume) has an outside ``engine.prefill``'s prompt lengths and
    bucket; every span but the cross-thread waits joins the labels."""
    run, _result = _traced(tiny_run, cell)
    t0 = run.device_trace.t0
    spans = sorted(run.program_spans, key=lambda s: s.start)
    inside = [s.data["positions"] for s in spans
              if s.name == "decode.tick" and s.data["positions"]]
    outside = [[int(p) for p in d] for _n, _a, _b, _t, d in
               sorted(run.spans.named("engine.tick", t0), key=lambda s: s[1]) if d is not None]
    assert inside == outside and inside
    inside = sorted((tuple(s.data["prompts"]), tuple(s.data["shape"])) for s in spans
                    if s.name == "prefill.dispatch" and "resume" not in s.data)
    outside = sorted((tuple(d["prompts"]), tuple(d["shape"]))
                     for _n, _a, _b, _t, d in run.spans.named("engine.prefill", t0))
    assert inside == outside and inside
    labelled = {(n, a, b) for n, a, b, _t, _d in run.spans.items}
    for s in run.program_spans:
        assert ((s.name, s.start, s.end) in labelled) == (s.name not in harness.UNLABELLED)


@pytest.mark.parametrize("cell", ["dsmoe-apps", "dsmoe-chat", "glm-longdoc"])
def test_a_traced_run_reports_every_per_layer_metric_of_its_cell(tiny_run, traced_on_cpu,
                                                                  cell):
    """All but the device trace's own (this trace profiles nothing)."""
    run, result = _traced(tiny_run, cell)
    assert run.program_spans
    want = {m["name"] for m in harness.cell_metrics(run.bench, cell, "per_layer")
            if m["source"] != "device_trace"}
    assert want <= set(result["metrics"])
    assert sum(m.split(".")[0] in READERS for m in want) == (4 if cell == "dsmoe-apps" else 3)


@pytest.mark.parametrize("cell", ["dsmoe-apps", "dsmoe-chat"])
def test_without_the_port_s_tracer_a_traced_run_completes_and_reads_nothing(
        tiny_run, traced_on_cpu, monkeypatch, cell):
    import repro_torch.core.runtime  # noqa: F401 — the port, loaded before its tracer is hidden
    import repro_torch.serving.hir_bridge  # noqa: F401
    import repro_torch.serving.paged_kv  # noqa: F401
    import repro_torch.serving.scheduler  # noqa: F401
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert harness.port_tracer() is None
    run, result = _traced(tiny_run, cell)
    assert run.program_spans is None and "breakdown" in result
    assert harness.result_line(run, result, "cpu")["correct"]
    for name in READERS:
        assert harness.metric_reader(name)(run) is None
    assert not any(m.split(".")[0] in READERS for m in result["metrics"])
    assert "tick_ms." + cell.split("-")[1] in result["metrics"]


def _span(name, start, end, thread=1, sid=None, parent=None, **data):
    return SimpleNamespace(name=name, start=start, end=end, thread=thread, id=sid,
                           parent=parent, data=data)


def _run(spans, lo=0.0, hi=10.0):
    run = SimpleNamespace(program_spans=spans, layer_window=lambda: (lo, hi))
    run.program_named = lambda name: harness.Run.program_named(run, name)
    return run


def test_tick_prep_is_the_mean_prep_of_ticks_with_active_lanes():
    spans = [_span("decode.tick", 1.0, 1.1, sid=1, positions=[5, 9]),
             _span("decode.prep", 1.0, 1.002, parent=1),
             _span("decode.tick", 2.0, 2.1, sid=2, positions=[]),
             _span("decode.prep", 2.0, 2.0001, parent=2),          # no active lane
             _span("decode.tick", 3.0, 3.1, sid=3, positions=[6]),
             _span("decode.prep", 3.0, 3.004, parent=3),
             _span("decode.tick", -1.0, -0.9, sid=4, positions=[1]),
             _span("decode.prep", -1.0, -0.99, parent=4)]          # before the window
    assert harness.metric_reader("tick_prep_ms.chat")(_run(spans)) == pytest.approx(3.0)


def test_sched_self_is_a_tick_less_the_engine_spans_on_its_thread():
    spans = [_span("scheduler.tick", 1.0, 1.010, thread=1),
             _span("decode.tick", 1.002, 1.005, thread=1),
             _span("decode.wait", 1.003, 1.005, thread=1),        # inside decode.tick
             _span("prefill.commit", 1.006, 1.007, thread=1),
             _span("prefill.dispatch", 1.001, 1.009, thread=2),  # another thread
             _span("scheduler.tick", 2.0, 2.002, thread=1),
             _span("scheduler.tick", 11.0, 11.5, thread=1)]      # after the window
    value = harness.metric_reader("sched_self_ms.longdoc")(_run(spans))
    assert value == pytest.approx((6.0 + 2.0) / 2)


def test_commit_wait_share_is_clipped_to_the_window():
    spans = [_span("commit.wait", -1.0, 1.0), _span("commit.wait", 4.0, 6.0),
             _span("commit.wait", 9.5, 12.0), _span("commit.insert", 6.0, 7.0)]
    assert harness.metric_reader("commit_wait_share.chat")(_run(spans)) == pytest.approx(35.0)
    assert harness.metric_reader("commit_wait_share.chat")(_run([])) is None


def test_query_wait_p95_over_the_waits_inside_the_window():
    import numpy as np
    waits = [0.1 * k for k in range(1, 21)]
    spans = [_span("runtime.queued", 1.0, 1.0 + w) for w in waits]
    spans.append(_span("runtime.queued", -5.0, 0.5))   # submitted before the window
    spans.append(_span("runtime.queued", 9.0, 11.0))   # taken after it
    value = harness.metric_reader("query_wait_p95_ms.apps")(_run(spans))
    assert value == pytest.approx(1e3 * np.percentile(waits, 95))


def test_drive_lock_wait_is_the_mean_over_drives():
    spans = [_span("bridge.drive", 1.0, 3.0, sid=1),
             _span("bridge.lock_wait", 1.0, 2.5, parent=1),
             _span("bridge.drive", 4.0, 4.5, sid=2),
             _span("bridge.drive", -2.0, 1.0, sid=3),       # before the window
             _span("bridge.lock_wait", -2.0, 0.5, parent=3),
             _span("bridge.drive", 9.0, 14.0, sid=4),       # past its close
             _span("bridge.lock_wait", 9.0, 13.0, parent=4)]
    assert harness.metric_reader("drive_lock_wait_ms.apps")(_run(spans)) == pytest.approx(750.0)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_nothing_without_the_port_s_spans(name):
    assert harness.metric_reader(name)(_run(None)) is None
