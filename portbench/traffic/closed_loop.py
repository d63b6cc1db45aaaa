"""Closed-loop serving traffic: clients that each send their next request
as soon as the previous one has finished.

A cell's ``traffic`` holds ``clients``, ``prompt`` and ``output`` as
``{"min", "max"}`` of uniform lengths, ``max_total`` (prompt + output),
``template`` and ``pool_seed``.  Each client's sequence of sizes is one
fixed list drawn from ``pool_seed``; the run's seed draws the prompt
tokens (and the weights), so every seed offers the same work.  Set-up
drives the largest prompt bucket once, then fills the lanes with every
client's first request, so the window starts with a backlog and every
lane busy.
"""
from __future__ import annotations

import time

import numpy as np

from portbench.serving import (Tracker, build_engine, build_strategy, instrument_engine,
                               prefill_groups)
from portbench.trace import TRACE_SECONDS

__all__ = ["plan", "Driver"]

PER_CLIENT = 16


def plan(traffic: dict, seed: int, vocab: int) -> list[list[dict]]:
    """Per client, its requests ``{"prompt", "max_new"}`` in order."""
    pool = np.random.default_rng(traffic["pool_seed"])
    rng = np.random.default_rng([int(seed), 0xC10])
    p, o = traffic["prompt"], traffic["output"]
    out = []
    for _c in range(traffic["clients"]):
        prompts = pool.integers(p["min"], p["max"] + 1, size=PER_CLIENT)
        outputs = np.minimum(pool.integers(o["min"], o["max"] + 1, size=PER_CLIENT),
                             traffic["max_total"] - prompts)
        out.append([{"prompt": rng.integers(0, vocab, size=int(prompts[j])).astype(np.int32),
                     "max_new": int(outputs[j])} for j in range(PER_CLIENT)])
    return out


class Driver:
    """``ContinuousBatchingScheduler`` over the cell's ``PagedInferenceEngine``,
    fed by closed-loop clients."""

    def __init__(self, run, params):
        from repro_torch.serving.scheduler import ContinuousBatchingScheduler
        self.run = run
        cell = run.cell
        self.engine = build_engine(run, params)
        instrument_engine(run, self.engine)
        sched = cell["scheduler"]
        self.sched = ContinuousBatchingScheduler(
            self.engine, strategy=build_strategy(sched["strategy"]),
            overlap=sched.get("overlap", False))
        self.tracker = Tracker(run, self.sched)
        self.tracker.on_done = self._next
        self.clients = plan(cell["traffic"], run.seed, run.model["vocab_size"])
        self._sent = [0] * len(self.clients)
        self._rid = 0
        self.template = cell["traffic"]["template"]

    def _submit(self, client: int, due: float) -> None:
        from repro_torch.serving.request import Request
        seq = self.clients[client]
        r = seq[self._sent[client] % len(seq)]
        self._sent[client] += 1
        self._rid += 1
        self.tracker.submit(Request(rid=self._rid, prompt=r["prompt"], max_new_tokens=r["max_new"],
                                    template=self.template), due, client)

    def _next(self, tr, now: float) -> None:
        if tr.client is not None:
            self._submit(tr.client, now)

    def warmup(self) -> None:
        """The largest prompt bucket once (it pins the template's shape and
        records the prefill's graph and the tick's), then every client's
        first request, ticking until every lane holds one."""
        from repro_torch.serving.request import Request
        w = self.run.cell["warmup"]
        rng = np.random.default_rng([self.run.seed, 0x3A3])
        prompt = rng.integers(0, self.run.model["vocab_size"], size=w["prompt"]).astype(np.int32)
        self.tracker.submit(Request(rid=0, prompt=prompt, max_new_tokens=2,
                                    template=self.template), time.perf_counter())
        while self.tracker.live:
            self.tracker.tick()
        now = time.perf_counter()
        for c in range(len(self.clients)):
            self._submit(c, now)
        n_lanes = self.engine.n_lanes
        while int(self.engine.active.sum()) < min(n_lanes, len(self.clients)):
            self.tracker.tick()
        self.run.tokens.clear()

    def window(self, seconds: float) -> None:
        run, tracker = self.run, self.tracker
        t0 = time.perf_counter()
        t_end = t0 + seconds
        t_trace = t_end - TRACE_SECONDS if run.device_trace is not None else None
        run.t0 = t0
        run.requests = tracker.all
        n0 = sum(self._sent) - len(tracker.live)
        while True:
            now = time.perf_counter()
            if t_trace is not None and now >= t_trace:
                run.device_trace.start()
                t_trace = None
            if now >= t_end:
                break
            tracker.tick()
        run.t1 = time.perf_counter()
        if run.device_trace is not None and run.device_trace.t0 is not None:
            run.device_trace.stop()
        run.attempted = sum(self._sent) - n0

    def quiesce(self) -> None:
        self.tracker.quiesce()

    def served(self) -> list:
        groups = prefill_groups(self.run)
        return [(p, t, groups[id(r)]) for p, t, r in self.tracker.served(self.run.t0, self.run.t1)]

    def close(self) -> None:
        self.engine = self.sched = self.tracker = None
