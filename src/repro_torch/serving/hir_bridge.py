"""HIR → serving bridge: run transformed query programs on the scheduler.

The transformation layer rewrites application programs so their queries
arrive in cohorts instead of one-at-a-time; the serving layer's
:class:`~repro.serving.scheduler.ContinuousBatchingScheduler` is what turns
a cohort into one shared decode stream.  This module closes the loop:

* :class:`TraceSimEngine` — a deterministic latency-model engine (same
  admission surface the scheduler binds elsewhere) whose every token is a
  pure function of ``(template, prompt, position)``, so "bit-identical
  outputs" is a meaningful assertion rather than a tautology;
* :class:`SchedulerQueryService` — a
  :class:`~repro.core.services.QueryService`-shaped facade that maps each
  HIR query to one generation request.  ``execute`` drives the scheduler
  for a single request (the synchronous tax: one full drive per query);
  ``execute_batch`` submits the whole cohort and drains once (the
  transformed win: prefill amortized per template, decode ticks shared
  across lanes).  ``stats.round_trips`` counts *scheduler drives*, the
  serving analogue of the paper's round-trip count.

``benchmarks/bench_lanes.py`` Part 10 runs the app-shaped traces from
:mod:`repro.core.app_traces` through this bridge, synchronous oracle vs.
``transform_program`` output, and gates the tokens/s ratio and the
round-trip ratio in CI.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np

from repro_torch.serving.engine import KVPartition
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler
from repro_torch.core.strategies import OneOrAll

__all__ = ["TraceSimEngine", "SchedulerQueryService"]

_TOK_MOD = 50021


def _prompt_for(query_name: str, params: Sequence) -> np.ndarray:
    """Deterministic prompt encoding of one HIR query."""
    vals = [len(params)] + [int(p) % _TOK_MOD for p in params]
    return np.asarray(vals, dtype=np.int32)


def _tok(template: str, prompt: np.ndarray, i: int) -> int:
    """Token ``i`` of a request: pure function of identity and position."""
    base = int(np.sum(prompt.astype(np.int64) * 31)) % _TOK_MOD
    off = sum(ord(c) for c in template)
    return (base * 7 + off * 13 + i * 101) % _TOK_MOD


class _Staged:
    """Staged prefill (mirrors the sim engines' staged shape)."""

    __slots__ = ("template", "requests")

    def __init__(self, template, requests):
        self.template = template
        self.requests = list(requests)


class TraceSimEngine:
    """Latency-model serving engine with deterministic token emission.

    Costs follow the two-resource model of the other sim engines: a
    per-template prefill profile ``(fixed_s, per_item_s)`` paid per
    dispatch, and a decode tick costing ``decode_base + n_active *
    decode_per_lane`` — so batched admission amortizes the fixed prefill
    cost AND shares decode ticks, which is exactly the advantage the
    transformed program is supposed to harvest.  Unlike those engines,
    every emitted token is :func:`_tok` of the request's identity, so two
    runs that claim the same outputs must have generated the same tokens.
    """

    def __init__(self, n_lanes: int = 8,
                 profiles: Optional[dict] = None,
                 default_profile: tuple = (8e-4, 1e-4),
                 decode_base: float = 1.2e-3,
                 decode_per_lane: float = 5e-5,
                 sleep=None):
        import time

        self.partition = KVPartition(n_lanes)
        self.profiles = dict(profiles or {})
        self.default_profile = default_profile
        self.decode_base = decode_base
        self.decode_per_lane = decode_per_lane
        self.active: dict[int, Request] = {}  # lane -> request
        self.prefill_time = 0.0
        self.decode_steps = 0
        self._sleep = sleep if sleep is not None else time.sleep

    @property
    def kv(self):
        """The KVView the scheduler binds."""
        return self.partition

    @property
    def n_free(self):
        """Free decode lanes."""
        return self.partition.n_free

    def n_free_for(self, template):
        """Lanes ``template`` may draw."""
        return self.partition.n_free_for(template)

    def prefill_dispatch(self, requests, template=None):
        """Pay the profile's prefill cost and stage the cohort."""
        fixed, per = self.profiles.get(template, self.default_profile)
        dt = fixed + per * len(requests)
        self.prefill_time += dt
        self._sleep(dt)
        return _Staged(template, requests)

    def commit_prefill(self, staged, n=None):
        """Bind staged requests to lanes; prefill emits token 0
        deterministically (the sim engines emit a literal 0 here)."""
        reqs = staged.requests if n is None else staged.requests[:n]
        for r in reqs:
            lane = self.partition.alloc(staged.template)
            r.lane = lane
            r.generated.append(_tok(r.template, r.prompt, 0))
            self.active[lane] = r
        return (len(staged.requests), 8)

    def admit(self, requests, template=None):
        """Synchronous admission: dispatch + commit inline."""
        return self.commit_prefill(self.prefill_dispatch(requests, template))

    def decode_tick(self):
        """One decode step over every active lane: each lane's next token
        is a pure function of its request, never of co-batched lanes."""
        if not self.active:
            return {}
        self._sleep(self.decode_base + self.decode_per_lane * len(self.active))
        self.decode_steps += 1
        return {lane: _tok(r.template, r.prompt, len(r.generated))
                for lane, r in self.active.items()}

    def retire(self, lane):
        """Release a lane back to its pool."""
        self.active.pop(lane, None)
        self.partition.release(lane)


class _DriveStats:
    """Counters the equivalence/bench layers read off the service."""

    def __init__(self):
        self.round_trips = 0       # scheduler drives
        self.single_drives = 0
        self.batch_drives = 0
        self.requests = 0
        self.tokens = 0

    def __int__(self):
        return self.round_trips


class SchedulerQueryService:
    """QueryService facade over a :class:`ContinuousBatchingScheduler`.

    One *drive* = submit a cohort, ``producer_done()``, ``run_until_
    drained()``.  ``execute`` pays a whole drive for one request —
    faithfully modelling what a synchronous program does to a serving
    stack — while ``execute_batch`` amortizes a single drive across the
    cohort.  Results are the request's full generated-token tuple, so
    bit-identity of observables means bit-identity of generations.

    The engine persists across drives (lanes fully drain between them);
    each drive gets a fresh scheduler so no cross-drive queue state leaks.
    A lock serializes drives — the async runtime's workers may race
    single consumer-side executes against a producer batch.
    """

    def __init__(self, engine: Optional[TraceSimEngine] = None,
                 max_new_tokens: int = 4,
                 strategy_factory=OneOrAll):
        self.engine = engine if engine is not None else TraceSimEngine()
        self.max_new_tokens = max_new_tokens
        self.strategy_factory = strategy_factory
        self.stats = _DriveStats()
        self._rid = 0
        self._lock = threading.Lock()

    def _drive(self, query_name: str, params_list: Sequence) -> list:
        with self._lock:
            reqs = []
            for params in params_list:
                self._rid += 1
                reqs.append(Request(
                    rid=self._rid,
                    prompt=_prompt_for(query_name, params),
                    max_new_tokens=self.max_new_tokens,
                    template=query_name,
                ))
            sched = ContinuousBatchingScheduler(
                self.engine, strategy=self.strategy_factory())
            for r in reqs:
                sched.submit(r)
            sched.producer_done()
            sched.run_until_drained()
            self.stats.round_trips += 1
            self.stats.requests += len(reqs)
            self.stats.tokens += sum(len(r.generated) for r in reqs)
            return [tuple(r.generated) for r in reqs]

    def execute(self, query_name: str, params):
        """One query, one full scheduler drive (the synchronous tax)."""
        self.stats.single_drives += 1
        return self._drive(query_name, [params])[0]

    def execute_batch(self, query_name: str, params_list):
        """A cohort of queries in one shared drive (the transformed win)."""
        self.stats.batch_drives += 1
        return self._drive(query_name, list(params_list))
