"""What the serving traffic kinds share: the stack built from a cell's file,
the benchmark's spans around it, and requests seen from outside.

A request's first token and its end are the times at which the benchmark
sees them, after the scheduler tick that produced them returns: what a
client polling the server would see.  Nothing is read from the port's own
timestamps for an end-to-end metric.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from portbench.spans import wrap

__all__ = ["Tracked", "Tracker", "build_engine", "build_strategy", "instrument_engine",
           "prefill_groups", "synchronize"]


def synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_strategy(spec: dict):
    """``{"name": <class in repro_torch.core.strategies>, "args": {...}}``."""
    from repro_torch.core import strategies
    return getattr(strategies, spec["name"])(**spec.get("args", {}))


def build_engine(run, params):
    """The cell's ``PagedInferenceEngine`` over the served weights."""
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    return PagedInferenceEngine(run.arch, params, device=run.device, **run.cell["engine"])


def instrument_engine(run, engine) -> None:
    """Spans around the engine's decode tick (with the positions of its
    active lanes' new tokens), prefill dispatch (with its requests' prompt
    lengths and the padded shape) and commit."""
    def lanes(*_a, **_k):
        return engine.lengths[engine.active].astype(np.int64)

    def tick_data(positions, out, *_a, **_k):
        return positions if len(positions) else None

    def staged(_s, out, requests, *_a, **_k):
        return {"prompts": [len(r.prompt) for r in requests], "shape": tuple(out.shape),
                "requests": list(requests)}

    wrap(engine, "decode_tick", run.spans, "engine.tick", before=lanes, after=tick_data)
    wrap(engine, "prefill_dispatch", run.spans, "engine.prefill", after=staged)
    wrap(engine, "commit_prefill", run.spans, "engine.commit")


class Tracked:
    """One request as the benchmark sees it."""

    __slots__ = ("req", "due", "first", "done", "seen", "client")

    def __init__(self, req, due: float, client: Optional[int] = None):
        self.req = req
        self.due = due
        self.first: Optional[float] = None
        self.done: Optional[float] = None
        self.seen = 0
        self.client = client


class Tracker:
    """Requests submitted to a scheduler and not yet seen to finish."""

    def __init__(self, run, sched):
        self.run = run
        self.sched = sched
        self.live: list[Tracked] = []
        self.all: list[Tracked] = []
        self.on_done: Optional[Callable[[Tracked, float], None]] = None

    def submit(self, req, due: float, client: Optional[int] = None) -> Tracked:
        req.metrics.arrival = due
        tr = Tracked(req, due, client)
        self.sched.submit(req)
        self.live.append(tr)
        self.all.append(tr)
        return tr

    def tick(self) -> None:
        """One scheduler tick, then what it produced, seen now."""
        t0 = time.perf_counter()
        self.sched.tick()
        now = time.perf_counter()
        self.run.spans.add("sched.tick", t0, now)
        new = 0
        keep = []
        finished = []
        for tr in self.live:
            n = len(tr.req.generated)
            if n > tr.seen:
                new += n - tr.seen
                tr.seen = n
                if tr.first is None:
                    tr.first = now
            if n >= tr.req.max_new_tokens:
                tr.done = now
                finished.append(tr)
            else:
                keep.append(tr)
        self.live = keep
        if new:
            self.run.tokens.append((now, new))
        if self.on_done is not None:
            for tr in finished:
                self.on_done(tr, now)

    def quiesce(self) -> None:
        """Wait for the scheduler's speculative prefill threads, so that no
        thread of the port runs after the window."""
        for task in list(getattr(self.sched, "_staged", ())):
            task.join()

    def served(self, t0: float, t1: float) -> list:
        """(prompt, served tokens, request) of every request seen to finish
        in [t0, t1]."""
        return [(np.asarray(tr.req.prompt), list(tr.req.generated[: tr.req.max_new_tokens]),
                 tr.req) for tr in self.all if tr.done is not None and t0 <= tr.done <= t1]


def prefill_groups(run) -> dict:
    """{id(request): padded prompt length of its last prefill dispatch}, from
    the benchmark's spans: the length over which the configuration's MoE
    capacity is stated."""
    out = {}
    for _n, _a, _b, _t, data in sorted(run.spans.named("engine.prefill"), key=lambda s: s[1]):
        for r in data["requests"]:
            out[id(r)] = data["shape"][1]
    return out
