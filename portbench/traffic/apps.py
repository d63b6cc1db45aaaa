"""Application programs: closed-loop clients, each running the paper's app
programs one after another, transformed by ``transform_program``.

The stack is the paper's: ``Interpreter`` over one shared
``AsyncQueryRuntime``, over ``SchedulerQueryService`` (one scheduler drive
per cohort of a query template), over the cell's ``PagedInferenceEngine``.
A cell's ``traffic`` holds ``clients``, ``programs`` (the app programs of
``repro_torch.core.app_traces`` each client runs in turn, from its own
offset), each program's input sizes as ``{input: [min, max]}``,
``runtime`` (``n_threads`` and the strategy), ``max_new_tokens`` and
``pool_seed``.  Sizes are a fixed list per client drawn from
``pool_seed``; the run's seed draws the input values (and the weights), so
every seed offers the same work.  A query counts when
the application's fetch (or blocking execute) returns it, and the answer it
returns is checked against what the engine served for its prompt.
"""
from __future__ import annotations

import sys
import threading
import time

import numpy as np

from portbench.serving import build_engine, build_strategy, instrument_engine, prefill_groups
from portbench.spans import wrap
from portbench.trace import TRACE_SECONDS

__all__ = ["plan", "Driver"]

PER_CLIENT = 64
VALUE_MOD = 10007


def plan(traffic: dict, seed: int) -> list[list[tuple[str, dict]]]:
    """Per client, its (program, inputs) in order; an input list's length
    lies in the program's stated range."""
    pool = np.random.default_rng(traffic["pool_seed"])
    rng = np.random.default_rng([int(seed), 0xA995])
    names = list(traffic["programs"])
    out = []
    for c in range(traffic["clients"]):
        runs = []
        for k in range(PER_CLIENT):
            name = names[(c + k) % len(names)]
            inputs = {}
            for key, (lo, hi) in traffic["programs"][name].items():
                n = int(pool.integers(lo, hi + 1))
                inputs[key] = [int(v) for v in rng.integers(1, VALUE_MOD, size=n)]
            runs.append((name, inputs))
        out.append(runs)
    return out


class _Counted:
    """The application's view of the runtime: each returned query counts,
    at the time it returns, and its answer is kept with its template and
    parameters (``answers``) for the check."""

    def __init__(self, rt, run, answers: list):
        self.rt, self.run, self.answers = rt, run, answers
        self._asked: dict = {}   # id(handle) -> (handle, query, params)

    def submit(self, query_name, params):
        handle = self.rt.submit(query_name, params)
        if handle is not None:
            self._asked[id(handle)] = (handle, query_name, tuple(params))
        return handle

    def fetch(self, handle):
        out = self.rt.fetch(handle)
        if handle is not None:
            _h, name, params = self._asked.pop(id(handle))
            self._returned(name, params, out)
        return out

    def execute(self, query_name, params):
        out = self.rt.execute(query_name, params)
        self._returned(query_name, tuple(params), out)
        return out

    def _returned(self, name, params, out) -> None:
        now = time.perf_counter()
        self.run.queries.append(now)
        self.answers.append((now, name, params, out))


class Driver:
    """Clients running transformed app programs against one runtime."""

    def __init__(self, run, params):
        from repro_torch.core import app_traces
        from repro_torch.core.hir import transform_program
        from repro_torch.core.runtime import AsyncQueryRuntime
        from repro_torch.serving.hir_bridge import SchedulerQueryService
        self.run = run
        traffic = run.cell["traffic"]
        self.engine = build_engine(run, params)
        instrument_engine(run, self.engine)
        self.svc = SchedulerQueryService(self.engine, max_new_tokens=traffic["max_new_tokens"])
        wrap(self.svc, "execute_batch", run.spans, "svc.drive")
        wrap(self.svc, "execute", run.spans, "svc.drive")
        rt_spec = traffic["runtime"]
        self.rt = AsyncQueryRuntime(self.svc, n_threads=rt_spec["n_threads"],
                                    strategy=build_strategy(rt_spec["strategy"]))
        self.programs = {name: transform_program(getattr(app_traces, name)().program)
                         for name in traffic["programs"]}
        self.templates = sorted({q for name in traffic["programs"]
                                 for q in _queries(getattr(app_traces, name)().program)})
        self.clients = plan(traffic, run.seed)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._errors: list[BaseException] = []
        self._done_at_close: set = set()
        self._answers: list = []   # (returned at, query, params, answer)

    def warmup(self) -> None:
        """Pin every query template at the largest cohort the engine takes
        (``n_lanes`` prompts of the bridge's length for one parameter),
        then one drive, which records the tick's graph."""
        from repro_torch.serving.hir_bridge import _prompt_for
        from repro_torch.serving.request import Request
        n = self.engine.n_lanes
        for t in self.templates:
            reqs = [Request(rid=-1, prompt=_prompt_for(t, (k,)), max_new_tokens=1, template=t)
                    for k in range(n)]
            self.engine.prefill_dispatch(reqs, template=t)
        self.svc.execute_batch(self.templates[0], [(k,) for k in range(n)])

    def _client(self, c: int) -> None:
        from repro_torch.core.hir import Interpreter
        view = _Counted(self.rt, self.run, self._answers)
        k = 0
        while not self._stop.is_set():
            name, inputs = self.clients[c][k % len(self.clients[c])]
            k += 1
            try:
                Interpreter(view).run(self.programs[name],
                                      {key: list(v) for key, v in inputs.items()})
            except Exception as e:  # noqa: BLE001 — a failed program, counted and reported
                self._errors.append(e)
                self.run.failed += 1
                return

    def window(self, seconds: float) -> None:
        run = self.run
        st = self.svc.stats
        self._threads = [threading.Thread(target=self._client, args=(c,), daemon=True,
                                          name=f"portbench-client-{c}")
                         for c in range(len(self.clients))]
        run.t0 = t0 = time.perf_counter()
        run.counters["drives0"], run.counters["requests0"] = st.round_trips, st.requests
        for t in self._threads:
            t.start()
        if run.device_trace is not None:
            time.sleep(max(0.0, seconds - TRACE_SECONDS))
            run.device_trace.start()
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        run.t1 = time.perf_counter()
        run.counters["drives1"], run.counters["requests1"] = st.round_trips, st.requests
        self._done_at_close = {id(r) for _n, a, _b, _t, d in run.spans.named("engine.prefill", t0)
                               for r in d["requests"] if r.done}
        self._stop.set()
        if run.device_trace is not None and run.device_trace.t0 is not None:
            run.device_trace.stop()
        run.attempted = sum(1 for q in run.queries if t0 <= q <= run.t1) + run.failed

    def quiesce(self) -> None:
        """Let every client finish the program it is in, then stop the
        runtime's workers."""
        for t in self._threads:
            t.join()
        self.rt.drain()
        self.rt.shutdown()
        for e in self._errors:
            print(f"portbench: a client's program failed: {e!r}", file=sys.stderr)

    def served(self) -> list:
        groups = prefill_groups(self.run)
        out = {}
        for _n, _a, _b, _t, d in self.run.spans.named("engine.prefill", self.run.t0):
            for r in d["requests"]:
                if id(r) in self._done_at_close:
                    out[id(r)] = (np.asarray(r.prompt), list(r.generated[: r.max_new_tokens]),
                                  groups[id(r)])
        return list(out.values())

    def checks(self) -> dict:
        """Whether each query returned in the window got its own answer: the
        tokens the engine served for that query's prompt (its template and
        the bridge's encoding of its parameters).  An answer that no request
        of that prompt was served is misdelivered."""
        from repro_torch.serving.hir_bridge import _prompt_for
        run = self.run
        served: dict = {}
        for _n, _a, _b, _t, d in run.spans.named("engine.prefill", run.t0):
            for r in d["requests"]:
                key = (r.template, np.asarray(r.prompt, np.int32).tobytes())
                served.setdefault(key, set()).add(tuple(int(x) for x in r.generated))
        wrong = sum(
            1 for t, name, params, out in self._answers if run.t0 <= t <= run.t1
            and (out is None or tuple(int(x) for x in out) not in served.get(
                (name, _prompt_for(name, params).tobytes()), ())))
        return {"misdelivered": {"value": wrong, "limit": 0}}

    def close(self) -> None:
        self.engine = self.svc = self.rt = None
        self._answers = []


def _queries(stmts) -> set:
    """Query names anywhere in a program's statements."""
    from repro_torch.core.hir import Call, Loop, Query
    out = set()
    for s in getattr(stmts, "body", stmts):
        if isinstance(s, Query):
            out.add(s.query_name)
        elif isinstance(s, Loop):
            out |= _queries(s.body)
        elif isinstance(s, Call):
            out |= _queries(s.proc.body)
    return out
