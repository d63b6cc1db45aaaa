"""The port's tracer (:mod:`repro_torch.tracing`) and the spans it records
at the layer boundaries: off it records nothing; on, spans nest by thread,
name their cause across threads, sit on ``time.perf_counter``, and a
scheduler tick over a small CPU ``PagedInferenceEngine`` gives the tree
the module docstring lists.  The spans carry the same positions, prompt
lengths and buckets as spans taken around the engine's methods from
outside, so either can stand for the other."""
from __future__ import annotations

import dataclasses
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core.runtime import AsyncQueryRuntime
from repro_torch.core.strategies import OneOrAll, PureAsync
from repro_torch.kernels import registry
from repro_torch.models.registry import get_arch
from repro_torch.serving import graphs
from repro_torch.serving.hir_bridge import SchedulerQueryService, TraceSimEngine
from repro_torch.serving.paged_kv import PagedInferenceEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

# The spans the benchmark records around the port from outside.
BENCHMARK_SPANS = {"engine.tick", "engine.prefill", "engine.commit", "sched.tick",
                   "svc.drive", "idle"}


def _port_span_names() -> list[str]:
    """Every span name the port's sources pass to the tracer."""
    call = re.compile(r"tracing\.(?:span|finish)\(.*?\"([a-z]+\.[a-z_]+)\"")
    names = set()
    for path in SRC.rglob("*.py"):
        names.update(call.findall(path.read_text()))
    return sorted(names)


PORT_SPANS = _port_span_names()


@pytest.fixture
def traced():
    """Tracing on for the test, with nothing recorded before it; off after."""
    tracing.collect()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.collect()


def _by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing_and_returns_the_shared_noop():
    assert not tracing.enabled()
    a, b = tracing.span("x"), tracing.span("y", n=1)
    assert a is b
    with a as sp:
        sp.set(n=2)
        tracing.end_at("x", 0.0)
        tracing.start("k")
        tracing.finish("k", "z")
        t = threading.Thread(target=lambda: None)
        tracing.handoff(t)
        t.start()
        t.join(10)
    assert not t.is_alive() and not hasattr(t, "_tracing_cause")
    assert tracing.collect() == []


def test_nesting_gives_parent_ids(traced):
    with tracing.span("outer", k=1) as outer:
        with tracing.span("inner") as inner:
            inner.set(n=2)
        with tracing.span("second"):
            pass
    spans = tracing.collect()
    assert [s.name for s in spans] == ["outer", "inner", "second"]
    assert outer.parent is None and outer.data == {"k": 1}
    assert inner.parent == outer.id and inner.data == {"n": 2}
    assert spans[2].parent == outer.id
    assert len({s.id for s in spans}) == 3
    assert {s.thread for s in spans} == {threading.get_ident()}
    assert tracing.collect() == []


@pytest.mark.parametrize("link", ["parent", "handoff"])
def test_a_span_on_another_thread_names_its_cause(traced, link):
    """``parent=`` and :func:`tracing.handoff` both make a span opened on
    a new thread a child of the span that caused it."""
    seen = {}

    def work():
        seen["thread"] = threading.get_ident()
        with tracing.span("child", parent=cause if link == "parent" else None):
            with tracing.span("grandchild"):
                pass

    with tracing.span("cause") as cause:
        t = threading.Thread(target=work)
        if link == "handoff":
            tracing.handoff(t)
        t.start()
        t.join(10)
    assert not t.is_alive()
    spans = _by_name(tracing.collect())
    child, grand = spans["child"][0], spans["grandchild"][0]
    assert child.parent == cause.id and grand.parent == child.id
    assert child.thread == grand.thread == seen["thread"] != cause.thread
    assert cause.id != child.id


def test_timestamps_are_perf_counter_readings(traced):
    t0 = time.perf_counter()
    with tracing.span("timed"):
        time.sleep(0.001)
    t1 = time.perf_counter()
    with tracing.span("given", start=t0):
        tracing.end_at("given", t1)
        tracing.end_at("other", 0.0)  # not the innermost: ignored
    tracing.start(("wait", 1))
    t2 = time.perf_counter()
    done = threading.Thread(target=tracing.finish, args=(("wait", 1), "waited"), kwargs={"k": 1})
    done.start()
    done.join(10)
    t3 = time.perf_counter()
    spans = _by_name(tracing.collect())
    timed = spans["timed"][0]
    assert t0 <= timed.start < timed.end <= t1 and timed.end - timed.start >= 0.001
    assert (spans["given"][0].start, spans["given"][0].end) == (t0, t1)
    waited = spans["waited"][0]
    assert t1 <= waited.start <= t2 <= waited.end <= t3
    assert waited.data == {"k": 1} and waited.thread != threading.get_ident()


@pytest.fixture(scope="module")
def small():
    arch = get_arch("llama3-8b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    return arch, arch.init(seed=0, device="cpu")


def _engine(small, **kw):
    arch, params = small
    return PagedInferenceEngine(arch, params, n_lanes=2, max_prompt_len=16, max_len=32,
                                page_size=8, device="cpu", **kw)


def _requests(lengths, max_new=3, start=0):
    rng = np.random.default_rng(7)
    return [Request(rid=start + i, prompt=rng.integers(1, 200, size=n).astype(np.int32),
                    max_new_tokens=max_new) for i, n in enumerate(lengths)]


def _children(spans, parent) -> list[str]:
    return [s.name for s in sorted(spans, key=lambda s: s.start) if s.parent == parent.id]


def test_a_scheduler_tick_gives_the_tree(small, traced):
    """Inline admission then a decode: ``scheduler.tick`` ⊃
    ``scheduler.admit`` ⊃ ``prefill.dispatch``, ``prefill.commit`` and
    ``scheduler.decode`` ⊃ ``decode.tick`` ⊃ prep, launch, wait."""
    eng = _engine(small)
    sched = ContinuousBatchingScheduler(eng, strategy=OneOrAll())
    for r in _requests([5, 7]):
        sched.submit(r)
    sched.tick()
    spans = tracing.collect()
    named = _by_name(spans)
    (tick,) = named["scheduler.tick"]
    assert tick.parent is None
    assert tick.data == {"tick": 1, "admitted": 2, "committed": 0, "aborted": 0}
    assert _children(spans, tick) == ["scheduler.admit", "scheduler.decode",
                                      "scheduler.finish"]
    (admit,) = named["scheduler.admit"]
    assert _children(spans, admit) == ["prefill.dispatch", "prefill.commit"]
    (dispatch,) = named["prefill.dispatch"]
    assert dispatch.data == {"rids": [0, 1], "prompts": [5, 7], "shape": (2, 8)}
    assert _children(spans, dispatch) == ["prefill.pad", "prefill.hold", "prefill.launch"]
    (commit,) = named["prefill.commit"]
    assert commit.data == {"rids": [0, 1], "n": 2}
    assert _children(spans, commit) == ["commit.wait", "commit.insert"]
    (decode,) = named["scheduler.decode"]
    assert _children(spans, decode) == ["decode.tick"]
    (dtick,) = named["decode.tick"]
    assert dtick.data == {"positions": [5, 7]}
    assert _children(spans, dtick) == ["decode.prep", "decode.launch", "decode.wait"]
    for s in spans:
        assert s.start <= s.end
        if s.parent is not None:
            up = next(p for p in spans if p.id == s.parent)
            assert up.start <= s.start and s.end <= up.end, (s, up)


def test_overlap_links_the_speculative_prefill_to_its_tick(small, traced):
    """With ``overlap=True`` the speculation thread's ``prefill.dispatch``
    has the tick's ``scheduler.speculate`` as its parent, and the next
    tick's ``scheduler.settle`` commits it: ``prefill.commit`` ⊃
    ``commit.wait``."""
    eng = _engine(small)
    sched = ContinuousBatchingScheduler(eng, strategy=PureAsync(), overlap=True)
    for r in _requests([6, 4]):
        sched.submit(r)
    sched.tick()  # one admitted inline, the other dispatched as a bet
    sched.tick()  # settle: the bet lands
    for task in list(sched._staged):
        task.join()
    spans = tracing.collect()
    named = _by_name(spans)
    specs = {s.id: s for s in named["scheduler.speculate"]}
    dispatch = [s for s in named["prefill.dispatch"] if s.parent in specs]
    assert len(dispatch) == 1
    spec = specs[dispatch[0].parent]
    assert spec.parent == named["scheduler.tick"][0].id and dispatch[0].thread != spec.thread
    assert dispatch[0].data["rids"] == [1]
    assert _children(spans, dispatch[0]) == ["prefill.pad", "prefill.hold", "prefill.launch"]
    settles = {s.id: s for s in named["scheduler.settle"]}
    (commit,) = [s for s in named["prefill.commit"] if s.parent in settles]
    assert commit.data == {"rids": [1], "n": 1} and commit.thread == spec.thread
    assert _children(spans, commit) == ["commit.wait", "commit.insert"]
    ticks = named["scheduler.tick"]
    assert [t.data["committed"] for t in ticks] == [0, 1]


def _wrap_like_the_benchmark(eng, out: dict) -> None:
    """Spans around the engine's methods from outside, as the benchmark
    takes them: the active lanes' positions before each decode tick (none
    where no lane is active), each dispatch's prompt lengths and bucket."""
    tick, dispatch = eng.decode_tick, eng.prefill_dispatch

    def decode_tick():
        pos = eng.lengths[eng.active].astype(np.int64)
        t0 = time.perf_counter()
        res = tick()
        out["ticks"].append((t0, pos.tolist() if len(pos) else None))
        return res

    def prefill_dispatch(requests, *a, **k):
        t0 = time.perf_counter()
        staged = dispatch(requests, *a, **k)
        out["prefills"].append((t0, [len(r.prompt) for r in requests], tuple(staged.shape)))
        return staged

    eng.decode_tick, eng.prefill_dispatch = decode_tick, prefill_dispatch


@pytest.mark.parametrize("overlap", [False, True])
def test_spans_agree_with_spans_taken_from_outside(small, traced, overlap):
    """Over a drained run, ``decode.tick`` spans with active lanes are the
    outside spans with positions, one for one and with the same positions;
    ``prefill.dispatch`` spans (not chunk resumes) have the outside spans'
    prompt lengths and buckets."""
    eng = _engine(small)
    outside = {"ticks": [], "prefills": []}
    _wrap_like_the_benchmark(eng, outside)
    sched = ContinuousBatchingScheduler(eng, strategy=PureAsync(), overlap=overlap)
    for r in _requests([3, 9, 12, 5], max_new=4):
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained()
    for task in list(sched._staged):
        task.join()
    named = _by_name(tracing.collect())
    inside = [s.data["positions"] for s in named["decode.tick"] if s.data["positions"]]
    assert inside == [p for _t, p in sorted(outside["ticks"]) if p is not None]
    assert len(inside) > 3
    dispatches = sorted((s for s in named["prefill.dispatch"] if "resume" not in s.data),
                        key=lambda s: s.start)
    assert [(s.data["prompts"], s.data["shape"]) for s in dispatches] == \
        [(p, shape) for _t, p, shape in sorted(outside["prefills"])]
    assert len(dispatches) == 4


def test_a_chunked_resume_is_a_dispatch_span(small, traced):
    eng = _engine(small)
    staged = eng.prefill_dispatch(_requests([14]), chunk=4)
    while not eng.prefill_resume(staged):
        pass
    spans = tracing.collect()
    resumes = [s for s in spans if s.name == "prefill.dispatch" and s.data.get("resume")]
    assert len(resumes) == 3 and all(s.data["rids"] == [0] for s in resumes)
    for s in resumes:
        assert _children(spans, s) == ["prefill.hold", "prefill.launch"]


def test_the_first_call_on_the_card_is_a_graph_build(monkeypatch, traced):
    """A step's first call on the card (its recording stood in for) is one
    ``graph.build`` span over the run and the recording, with the step's
    function and key; a replay records none."""
    kernel = registry.get("batched_gather").kernel

    class Recorded:
        def replay(self):
            pass

    def record(self):
        time.sleep(0.002)
        self.graph, self.tally, self._graph_out = Recorded(), {kernel: 1}, (torch.zeros(1),)
        self.parts.update(record=0.002, instantiate=0.0)

    monkeypatch.setattr(graphs.CompiledStep, "_record", record)
    inp = graphs.StaticInputs({"x": (1,)}, torch.device("cpu"))

    def prefill():
        return (inp["x"] * 2,)

    step = graphs.CompiledStep(prefill, inp, [], torch.device("cuda"), pool=object())
    step.key = (2, 16)
    t0 = time.perf_counter()
    step()
    t1 = time.perf_counter()
    step()
    registry.reset_launches()
    (build,) = tracing.collect()
    assert build.name == "graph.build" and build.data == {"step": "prefill", "key": (2, 16)}
    assert t0 <= build.start and build.end <= t1 and build.end - build.start >= 0.002


class _Echo:
    """A query service that answers each query with its parameters."""

    def execute(self, query_name, params):
        return tuple(params)

    def execute_batch(self, query_name, params_list):
        return [tuple(p) for p in params_list]


def test_runtime_queue_waits_carry_handle_keys(traced):
    rt = AsyncQueryRuntime(_Echo(), n_threads=2, strategy=OneOrAll())
    try:
        handles = [rt.submit(f"q{i % 2}", (i,)) for i in range(12)]
        handles.append(rt.submit("q0", (0,)))  # the same query: coalesced or queued again
        assert [rt.fetch(h) for h in handles] == [(i,) for i in range(12)] + [(0,)]
    finally:
        rt.shutdown()
    named = _by_name(tracing.collect())
    queued = named["runtime.queued"]
    keys = [s.data["key"] for s in queued]
    assert len(keys) == len(set(keys)) and set(keys) <= {h.key for h in handles}
    assert set(keys) >= {h.key for h in handles[:12]}
    assert all(s.data["lane"] in ("q0", "q1") and s.start <= s.end for s in queued)
    batched = {k for s in named["runtime.batch"] for k in s.data["keys"]}
    assert set(keys) <= batched
    assert sum(s.data["size"] for s in named["runtime.batch"]) >= 12


def test_a_bridge_drive_holds_its_lock_wait(traced):
    svc = SchedulerQueryService(TraceSimEngine(sleep=lambda s: None), max_new_tokens=2)
    assert len(svc.execute_batch("t", [(1,), (2,), (3,)])) == 3
    spans = tracing.collect()
    named = _by_name(spans)
    (drive,) = named["bridge.drive"]
    assert drive.data == {"rids": [1, 2, 3], "cohort": 3}
    (wait,) = named["bridge.lock_wait"]
    assert wait.parent == drive.id and drive.start <= wait.start <= wait.end <= drive.end
    assert all(t.parent == drive.id for t in named["scheduler.tick"])


def test_the_sources_name_the_spans_the_tracer_documents():
    documented = set(re.findall(r"``([a-z]+\.[a-z_]+)``", tracing.__doc__))
    assert set(PORT_SPANS) == documented - {"time.perf_counter"}
    assert len(PORT_SPANS) == 22


@pytest.mark.parametrize("name", PORT_SPANS)
def test_no_port_span_is_named_like_a_benchmark_span(name):
    assert name not in BENCHMARK_SPANS
    assert name.split(".")[0] in {"scheduler", "decode", "prefill", "commit", "graph",
                                  "runtime", "bridge"}
    assert f"``{name}``" in tracing.__doc__
