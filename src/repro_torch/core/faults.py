"""Deterministic fault injection: ChaosService / ChaosEngine.

Chaos wrappers plug UNDER the runtime (any
:class:`~repro.core.services.QueryService`) and under the serving engine
(:class:`~repro.serving.engine.InferenceEngine` or any duck-typed
stand-in) and inject failures from a **seeded schedule** — every decision
is a pure hash of ``(seed, decision kind, identity)``
(:func:`~repro.core.resilience.hash_unit`), never global RNG state, so a
chaos run replays bit-identically regardless of thread interleaving and a
CI failure reproduces locally from the seed alone.

Three fault kinds, mirroring what production services actually do:

* **poisoned params** (``fail_rate``): a deterministic subset of
  ``(query_name, params)`` identities *always* fails with
  :class:`InjectedParamError` — the "genuinely failing request" whose
  exception must reach exactly its own fetch point.  A batch containing
  any poisoned param raises :class:`InjectedBatchFault` (statement-level
  poisoning, like a DB driver failing the whole multi-row statement) —
  the runtime's fission-retry splits the batch to isolate the culprits.
* **transient faults** (``transient_rate``): a subset of identities fails
  its first ``transient_repeats`` attempts with :class:`InjectedFault`
  and then succeeds — what retry/backoff exists to absorb.
* **latency spikes** (``latency_rate``/``latency``): a seeded fraction of
  calls sleeps before executing — what deadlines and stragglers absorb.

:class:`ChaosEngine` additionally injects serving-side faults: a seeded
fraction of decode ticks raises :class:`~repro.core.resilience.LaneError`
for a deterministic victim lane (the crash-recovery/quarantine path), and
a seeded fraction of prefill dispatches raises :class:`InjectedFault`
(the spec-thread crash / admission-retry path).

``REPRO_CHAOS_SEED`` is the CI knob: :func:`chaos_seed` reads it so the
chaos job can run the same suites under two different schedules.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

from repro_torch.core.resilience import LaneError, NonRetryableError, hash_unit

__all__ = [
    "ChaosEngine",
    "ChaosPlan",
    "ChaosService",
    "InjectedBatchFault",
    "InjectedFault",
    "InjectedParamError",
    "chaos_seed",
]


def chaos_seed(default: int = 0) -> int:
    """The chaos schedule seed: ``REPRO_CHAOS_SEED`` env, else ``default``."""
    return int(os.environ.get("REPRO_CHAOS_SEED", default))


class InjectedFault(RuntimeError):
    """A transient injected failure (succeeds on retry)."""


class InjectedParamError(NonRetryableError, RuntimeError):
    """A deterministically-failing param's own exception.

    Carries the identity it was injected for, so tests can assert each
    failed request raised exactly *its* exception and no one else's."""

    def __init__(self, query_name: str, params):
        super().__init__(f"injected failure for {query_name!r} {params!r}")
        self.query_name = query_name
        self.params = params


class InjectedBatchFault(RuntimeError):
    """A batch-level failure: >= 1 param in the batch is poisoned.

    Statement-level poisoning (the whole multi-param call fails); the
    runtime's fission-retry isolates which params are actually bad."""

    def __init__(self, query_name: str, n_bad: int, n_total: int):
        super().__init__(
            f"injected batch failure for {query_name!r}: "
            f"{n_bad}/{n_total} params poisoned")
        self.query_name = query_name
        self.n_bad = n_bad
        self.n_total = n_total


class ChaosPlan:
    """One seeded fault schedule, shared by service and engine wrappers.

    Stateless decisions (:meth:`poisoned`, latency draws) are pure
    hashes; the only state is the per-identity attempt counter behind
    transient faults (fail the first k attempts, then succeed), which is
    keyed by request identity — not call order — so concurrent retries
    still converge on the same schedule."""

    def __init__(self, seed: int = 0, fail_rate: float = 0.0,
                 transient_rate: float = 0.0, transient_repeats: int = 2,
                 latency_rate: float = 0.0, latency: float = 0.001,
                 decode_fault_rate: float = 0.0,
                 prefill_fault_rate: float = 0.0):
        for name in ("fail_rate", "transient_rate", "latency_rate",
                     "decode_fault_rate", "prefill_fault_rate"):
            v = locals()[name]
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        self.seed = seed
        self.fail_rate = fail_rate
        self.transient_rate = transient_rate
        self.transient_repeats = transient_repeats
        self.latency_rate = latency_rate
        self.latency = latency
        self.decode_fault_rate = decode_fault_rate
        self.prefill_fault_rate = prefill_fault_rate
        self._lock = threading.Lock()
        self._attempts: dict = {}

    # ------------------------------------------------------- service faults
    def poisoned(self, query_name: str, params) -> bool:
        """Whether this identity ALWAYS fails (deterministic in the seed)."""
        return hash_unit(self.seed, "poison", query_name,
                         params) < self.fail_rate

    def fault_for(self, query_name: str, params) -> Optional[BaseException]:
        """The exception (if any) attempt-N of this identity should raise."""
        if self.poisoned(query_name, params):
            return InjectedParamError(query_name, params)
        if hash_unit(self.seed, "transient", query_name,
                     params) < self.transient_rate:
            key = (query_name, params)
            with self._lock:
                n = self._attempts[key] = self._attempts.get(key, 0) + 1
            if n <= self.transient_repeats:
                return InjectedFault(
                    f"transient fault #{n} for {query_name!r} {params!r}")
        return None

    def latency_for(self, kind: str, index: int) -> float:
        """Injected sleep for call ``index`` of ``kind`` (0.0 = none)."""
        if hash_unit(self.seed, "latency", kind, index) < self.latency_rate:
            return self.latency
        return 0.0

    # -------------------------------------------------------- engine faults
    def decode_fault(self, tick: int) -> bool:
        """Whether decode tick ``tick`` should crash one lane."""
        return hash_unit(self.seed, "decode", tick) < self.decode_fault_rate

    def pick(self, kind: str, index: int, n: int) -> int:
        """Deterministic victim choice among ``n`` candidates."""
        return int(hash_unit(self.seed, "pick", kind, index) * n) % n


class ChaosService:
    """A :class:`~repro.core.services.QueryService` wrapper injecting the
    plan's faults ahead of the inner service.

    Poisoned params raise their own :class:`InjectedParamError` on the
    single-execute path; a batch containing any poisoned or
    currently-transient param raises (the param's own error for a 1-param
    batch, :class:`InjectedBatchFault` otherwise) so the runtime's
    fission-retry has something to isolate.  Injection counters are on
    the wrapper (``injected_single`` / ``injected_batch`` /
    ``injected_sleeps``); everything else proxies to the inner service.
    """

    def __init__(self, inner, plan: ChaosPlan):
        self.inner = inner
        self.plan = plan
        self.injected_single = 0
        self.injected_batch = 0
        self.injected_sleeps = 0
        self._calls = 0
        self._lock = threading.Lock()

    def _tick(self, kind: str) -> None:
        with self._lock:
            self._calls += 1
            n = self._calls
        dt = self.plan.latency_for(kind, n)
        if dt > 0.0:
            self.injected_sleeps += 1
            time.sleep(dt)

    def execute(self, query_name: str, params) -> object:
        """Single execution, behind the plan's faults for this identity."""
        self._tick("single")
        err = self.plan.fault_for(query_name, params)
        if err is not None:
            self.injected_single += 1
            raise err
        return self.inner.execute(query_name, params)

    def execute_batch(self, query_name: str, params_list) -> list:
        """Batched execution; any faulty member poisons the whole call."""
        self._tick("batch")
        errs = [self.plan.fault_for(query_name, p) for p in params_list]
        bad = [e for e in errs if e is not None]
        if bad:
            self.injected_batch += 1
            if len(params_list) == 1:
                raise bad[0]
            raise InjectedBatchFault(query_name, len(bad), len(params_list))
        return self.inner.execute_batch(query_name, params_list)

    def __getattr__(self, name):
        return getattr(self.inner, name)


# attributes ChaosEngine keeps on itself; everything else proxies inward
_CHAOS_ENGINE_SELF = frozenset(
    {"_engine", "plan", "injected_decode_faults", "injected_prefill_faults",
     "_decode_calls", "_prefill_calls"})


class ChaosEngine:
    """A serving-engine proxy injecting decode/prefill faults.

    A seeded fraction of :meth:`decode_tick` calls raises
    :class:`~repro.core.resilience.LaneError` for a deterministically
    chosen *active* lane BEFORE the device step runs (no token is
    half-emitted), exercising the scheduler's quarantine + KV-salvage +
    requeue recovery.  A seeded fraction of prefill dispatches (and
    ``admit``) raises :class:`InjectedFault`, exercising the spec-crash
    abort and the admission retry path.  All other attribute access —
    reads AND writes (e.g. the scheduler installing ``on_lane_evicted``)
    — proxies to the wrapped engine, so the wrapper is drop-in for any
    engine the scheduler accepts."""

    def __init__(self, engine, plan: ChaosPlan):
        object.__setattr__(self, "_engine", engine)
        object.__setattr__(self, "plan", plan)
        object.__setattr__(self, "injected_decode_faults", 0)
        object.__setattr__(self, "injected_prefill_faults", 0)
        object.__setattr__(self, "_decode_calls", 0)
        object.__setattr__(self, "_prefill_calls", 0)

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __setattr__(self, name, value):
        if name in _CHAOS_ENGINE_SELF:
            object.__setattr__(self, name, value)
        else:
            setattr(self._engine, name, value)

    def _active_lanes(self) -> list:
        act = getattr(self._engine, "active", None)
        if act is None:
            return []
        # Engines expose occupancy either as a boolean vector indexed by
        # lane (the JAX engine) or as a set of active lane ids (sim
        # engines) — accept both so the wrapper stays drop-in.
        if isinstance(act, (set, frozenset)):
            return sorted(int(lane) for lane in act)
        try:
            return [int(i) for i, on in enumerate(act) if on]
        except TypeError:
            return []

    def _template_of(self, lane: int) -> Optional[str]:
        # best effort: engines don't track templates per lane; the
        # scheduler resolves the request from its own running table.
        return None

    def decode_tick(self):
        """One decode step — or an injected single-lane crash."""
        self._decode_calls += 1
        n = self._decode_calls
        if self.plan.decode_fault(n):
            lanes = self._active_lanes()
            if lanes:
                victim = lanes[self.plan.pick("victim", n, len(lanes))]
                self.injected_decode_faults += 1
                raise LaneError(victim, self._template_of(victim),
                                reason=f"injected decode fault (tick {n})")
        dt = self.plan.latency_for("decode", n)
        if dt > 0.0:
            time.sleep(dt)
        return self._engine.decode_tick()

    def _prefill_fault(self, template) -> None:
        self._prefill_calls += 1
        n = self._prefill_calls
        if hash_unit(self.plan.seed, "prefill",
                     n) < self.plan.prefill_fault_rate:
            self.injected_prefill_faults += 1
            raise InjectedFault(
                f"injected prefill fault #{n} ({template!r})")

    def admit(self, requests, template=None):
        """Synchronous admission, behind the plan's prefill faults."""
        self._prefill_fault(template)
        return self._engine.admit(requests, template=template)

    def prefill_dispatch(self, requests, template=None, chunk=None):
        """Split-path dispatch, behind the plan's prefill faults."""
        self._prefill_fault(template)
        if chunk is None:
            return self._engine.prefill_dispatch(requests, template=template)
        return self._engine.prefill_dispatch(requests, template=template,
                                             chunk=chunk)
