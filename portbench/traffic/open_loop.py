"""Open-loop serving traffic: independent users whose requests fall due on
a schedule, whether or not earlier ones have finished.

A cell's ``traffic`` holds ``rate`` (requests/s), ``cv`` (the coefficient
of variation of gamma inter-arrival times; 1 is Poisson), ``prompt`` and
``output`` as ``{"median", "sigma", "min", "max"}`` of clipped lognormals,
``templates`` as ``{name: share}`` and ``pool_seed``.  A run of S seconds
is ``round(rate * S)`` requests, all due inside the window.  Their due
times, sizes and templates are one fixed schedule drawn from
``pool_seed``; the run's seed draws the prompt tokens (and the weights),
so every seed offers the same work and the spread of a tail between runs
is the system's, not the schedule's.  Each request is timed from its due
time.
"""
from __future__ import annotations

import math
import time

import numpy as np

from portbench.serving import (Tracker, build_engine, build_strategy, instrument_engine,
                               prefill_groups)
from portbench.trace import TRACE_SECONDS

__all__ = ["plan", "Driver"]


def _lognormal(rng, spec: dict, n: int) -> np.ndarray:
    x = rng.lognormal(math.log(spec["median"]), spec["sigma"], size=n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def plan(traffic: dict, seed: int, seconds: float, vocab: int) -> list[dict]:
    """The run's requests: ``{"due", "prompt", "max_new", "template"}``
    sorted by due time (seconds from the window's start)."""
    n = max(1, round(traffic["rate"] * seconds))
    pool = np.random.default_rng(traffic["pool_seed"])
    k = 1.0 / traffic["cv"] ** 2
    gaps = pool.gamma(k, 1.0 / (k * traffic["rate"]), size=n)
    prompts = _lognormal(pool, traffic["prompt"], n)
    outputs = _lognormal(pool, traffic["output"], n)
    names = sorted(traffic["templates"])
    counts = [round(traffic["templates"][t] * n) for t in names]
    counts[-1] = n - sum(counts[:-1])
    templates = pool.permutation(np.repeat(np.arange(len(names)), counts))
    due = seconds * (np.cumsum(gaps) - gaps) / gaps.sum()
    rng = np.random.default_rng([int(seed), 0xA11])
    return [{"due": float(due[i]),
             "prompt": rng.integers(0, vocab, size=int(prompts[i])).astype(np.int32),
             "max_new": int(outputs[i]), "template": names[templates[i]]} for i in range(n)]


class Driver:
    """``ContinuousBatchingScheduler`` over the cell's ``PagedInferenceEngine``."""

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
        self.plan = plan(cell["traffic"], run.seed, run.seconds, run.model["vocab_size"])
        self._rid = 0

    def _request(self, prompt, max_new: int, template: str):
        from repro_torch.serving.request import Request
        self._rid += 1
        return Request(rid=self._rid, prompt=prompt, max_new_tokens=max_new, template=template)

    def warmup(self) -> None:
        """Drive each template's largest (batch, prompt) bucket once, which
        pins it and records the prefill's graph and the tick's."""
        w = self.run.cell["warmup"]
        rng = np.random.default_rng([self.run.seed, 0x3A3])
        vocab = self.run.model["vocab_size"]
        now = time.perf_counter()
        for t in sorted(self.run.cell["traffic"]["templates"]):
            for _ in range(w["batch"]):
                prompt = rng.integers(0, vocab, size=w["prompt"]).astype(np.int32)
                self.tracker.submit(self._request(prompt, 2, t), now)
        while self.tracker.live:
            self.tracker.tick()
        self.tracker.quiesce()
        self.tracker.all.clear()
        self.run.tokens.clear()

    def window(self, seconds: float) -> None:
        run, tracker = self.run, self.tracker
        t0 = time.perf_counter()
        t_end = t0 + seconds
        t_trace = t_end - TRACE_SECONDS if run.device_trace is not None else None
        run.t0 = t0
        run.requests = tracker.all
        reqs, i = self.plan, 0
        while True:
            now = time.perf_counter()
            if t_trace is not None and now >= t_trace:
                run.device_trace.start()
                t_trace = None
                now = time.perf_counter()
            if now >= t_end:
                break
            while i < len(reqs) and t0 + reqs[i]["due"] <= now:
                r = reqs[i]
                tracker.submit(self._request(r["prompt"], r["max_new"], r["template"]),
                               t0 + r["due"])
                i += 1
            if tracker.live:
                tracker.tick()
            else:
                wake = min(t0 + reqs[i]["due"] if i < len(reqs) else t_end, t_end,
                           t_trace if t_trace is not None else t_end)
                time.sleep(max(0.0, wake - now))
                run.spans.add("idle", now, time.perf_counter())
        run.t1 = time.perf_counter()
        if run.device_trace is not None and run.device_trace.t0 is not None:
            run.device_trace.stop()
        run.attempted = i

    def quiesce(self) -> None:
        self.tracker.quiesce()

    def served(self) -> list:
        groups = prefill_groups(self.run)
        return [(p, t, groups[id(r)]) for p, t, r in self.tracker.served(self.run.t0, self.run.t1)]

    def close(self) -> None:
        self.engine = self.sched = self.tracker = None
