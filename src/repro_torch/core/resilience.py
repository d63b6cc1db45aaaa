"""Failure-domain primitives: retry, deadlines, circuit breakers.

The paper's transformation is only *correct* if the asynchronous program
preserves the synchronous program's exception semantics — a query that
would have raised at its call site must raise at the corresponding fetch
point, and nowhere else.  This module supplies the policy objects the
runtime and the serving scheduler use to keep that guarantee under real
failures, and to degrade gracefully instead of wedging:

* :class:`RetryPolicy` — bounded retries with exponential backoff and
  *deterministic* jitter (hash-derived, so chaos runs replay exactly),
  plus a per-lane :class:`RetryBudget` token bucket that prevents retry
  storms: retries spend tokens, successes earn them back.
* :class:`CircuitBreaker` — the classic closed → open → half-open state
  machine, per lane.  A tripped lane is *shed* to a direct synchronous
  execution path (graceful degradation: no batching, no retries) while
  half-open probes test whether the lane has recovered.
* :class:`Resilience` — the one config object bundling the knobs
  (``retry_budget``, ``deadline``, ``breaker_threshold``, …; see
  ``docs/TUNING.md``); :class:`FailureDomain` instantiates per-lane
  breaker/budget state from it.
* Typed exceptions: :class:`DeadlineExceeded` (raised at the fetch
  point when a request's deadline lapses), :class:`ServiceCardinalityError`
  (a service returned the wrong number of batch results — a protocol
  violation delivered to every waiter instead of stranding them),
  :class:`LaneError` (a device-step failure attributable to one serving
  lane; the scheduler quarantines the lane and salvages its KV), and
  :class:`LaneFailedError` (a lane whose every submission fails, surfaced
  by ``run_until_drained`` with the template and last exception).

Exceptions deriving :class:`NonRetryableError` are never retried — the
failure is deterministic, so a retry only burns budget.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Optional

__all__ = [
    "CircuitBreaker",
    "DeadlineExceeded",
    "FailureDomain",
    "LaneError",
    "LaneFailedError",
    "NonRetryableError",
    "Resilience",
    "RetryBudget",
    "RetryPolicy",
    "ServiceCardinalityError",
]


def hash_unit(*parts) -> float:
    """Deterministic hash of ``parts`` mapped to ``[0, 1)``.

    The jitter/chaos randomness source: derived from the *identity* of
    the decision (seed, key, attempt index), never from global RNG state
    or wall clock, so a seeded run replays bit-identically regardless of
    thread interleaving.
    """
    h = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0**64


class NonRetryableError(Exception):
    """Marker base: failures that are deterministic (retry cannot help)."""


class DeadlineExceeded(NonRetryableError, RuntimeError):
    """A request's deadline lapsed before its result arrived.

    Raised *at the fetch point* (the paper's exception-semantics
    contract): the submitting code sees it exactly where the synchronous
    program would have blocked."""

    def __init__(self, query_name: str, deadline: float, waited: float):
        super().__init__(
            f"deadline of {deadline:.3f}s exceeded fetching {query_name!r} "
            f"(waited {waited:.3f}s)")
        self.query_name = query_name
        self.deadline = deadline
        self.waited = waited


class ServiceCardinalityError(NonRetryableError, RuntimeError):
    """``execute_batch`` returned the wrong number of results.

    A mid-fanout ``IndexError`` from a short result list used to kill the
    worker thread and strand every fetcher; validating the cardinality up
    front turns the protocol violation into an error delivered to each
    waiter."""

    def __init__(self, query_name: str, expected: int, got: int):
        super().__init__(
            f"service returned {got} results for a {expected}-param batch "
            f"of {query_name!r}")
        self.query_name = query_name
        self.expected = expected
        self.got = got


class LaneError(RuntimeError):
    """A device-step failure attributable to ONE serving lane.

    Raised by engines (or :class:`~repro.core.faults.ChaosEngine`) when a
    decode step fails in a way that identifies the offending lane; the
    scheduler's recovery path quarantines exactly that lane, salvages its
    KV through the spill machinery, and re-queues its request — the rest
    of the batch keeps decoding."""

    def __init__(self, lane: int, template: Optional[str] = None,
                 reason: str = "device step failed"):
        super().__init__(f"lane {lane} ({template!r}): {reason}")
        self.lane = lane
        self.template = template


class LaneFailedError(RuntimeError):
    """A serving lane whose every submission is failing.

    The named replacement for the generic stuck-lane diagnosis: carries
    the template and the last underlying exception so the operator sees
    *which* traffic class is down and *why*."""

    def __init__(self, template: str, failures: int,
                 last_error: Optional[BaseException]):
        super().__init__(
            f"lane {template!r} failed {failures} consecutive submissions; "
            f"last error: {last_error!r}")
        self.template = template
        self.failures = failures
        self.last_error = last_error


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and deterministic jitter.

    ``max_attempts`` counts the first try; ``backoff_for(attempt)`` grows
    ``backoff_base * backoff_multiplier**(attempt-1)`` capped at
    ``backoff_max``, jittered DOWN by up to ``jitter`` (a fraction of the
    interval) via :func:`hash_unit` — deterministic per (key, attempt),
    so seeded chaos runs replay while concurrent retries still decorrelate.
    ``retry_budget``/``budget_earn`` parameterize each lane's
    :class:`RetryBudget` token bucket.
    """

    max_attempts: int = 3
    backoff_base: float = 0.0005
    backoff_multiplier: float = 2.0
    backoff_max: float = 0.05
    jitter: float = 0.5
    retry_budget: float = 64.0
    budget_earn: float = 0.25

    def is_retryable(self, exc: BaseException) -> bool:
        """Whether a retry could plausibly succeed (deterministic
        failures — :class:`NonRetryableError` — never retry)."""
        return not isinstance(exc, NonRetryableError)

    def backoff_for(self, attempt: int, key=None) -> float:
        """Sleep before retry ``attempt`` (1-based), jittered."""
        base = min(self.backoff_max,
                   self.backoff_base * self.backoff_multiplier ** (attempt - 1))
        if self.jitter <= 0.0:
            return base
        return base * (1.0 - self.jitter * hash_unit("backoff", key, attempt))

    def sleep_backoff(self, attempt: int, key=None) -> float:
        """Sleep the backoff for retry ``attempt`` and return it.  Lives
        here — not in the runtime — because backing off IS retry policy:
        the runtime's own waits stay purely signal-driven (no timed sleeps
        in the quota/fetch paths), and this is the one deliberate timed
        pause in the system."""
        delay = self.backoff_for(attempt, key)
        if delay > 0.0:
            time.sleep(delay)
        return delay


class RetryBudget:
    """Token bucket bounding a lane's retries (anti-retry-storm).

    Retries spend one token; successes earn ``earn`` back (capped at
    ``cap``).  When the bucket is dry the failure is delivered instead of
    retried — under a full outage the lane degrades to fail-fast rather
    than multiplying load on the struggling service."""

    def __init__(self, cap: float, earn: float = 0.25):
        self._cap = max(0.0, float(cap))
        self._earn = max(0.0, float(earn))
        self._tokens = self._cap
        self._lock = threading.Lock()

    def try_spend(self) -> bool:
        """Take one token; ``False`` when the budget is exhausted."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def earn(self) -> None:
        """Credit one success back toward the cap."""
        with self._lock:
            self._tokens = min(self._cap, self._tokens + self._earn)

    @property
    def tokens(self) -> float:
        """Current token balance (introspection)."""
        with self._lock:
            return self._tokens


class CircuitBreaker:
    """Per-lane circuit breaker: closed → open → half-open → closed.

    ``threshold`` consecutive failures trip the breaker (state ``open``);
    for ``cooldown`` seconds :meth:`allow` answers ``"shed"`` — callers
    route the lane to their degraded path.  After the cooldown the
    breaker goes half-open and :meth:`allow` grants up to ``probes``
    concurrent ``"probe"`` calls through the normal path; a probe success
    closes the breaker, a probe failure re-opens it (fresh cooldown).
    Thread-safe; ``transitions`` records every state change (chaos tests
    assert the trip → half-open → close sequence)."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int = 8, cooldown: float = 0.05,
                 probes: int = 1, on_trip=None):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = threshold
        self.cooldown = cooldown
        self.probes = max(1, probes)
        self.on_trip = on_trip
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0       # consecutive failures while closed
        self._open_until = 0.0
        self._probing = 0        # outstanding half-open probes
        self.trips = 0
        self.transitions: list[str] = []

    @property
    def state(self) -> str:
        """Current state (``closed`` / ``open`` / ``half_open``)."""
        with self._lock:
            return self._state

    def _transition(self, state: str) -> None:
        self._state = state
        self.transitions.append(state)

    def allow(self) -> str:
        """Admission decision for one submission: ``"closed"`` (normal
        path), ``"probe"`` (half-open trial through the normal path), or
        ``"shed"`` (degraded path — the breaker is open)."""
        with self._lock:
            if self._state == self.CLOSED:
                return self.CLOSED
            if self._state == self.OPEN:
                if time.monotonic() < self._open_until:
                    return "shed"
                self._transition(self.HALF_OPEN)
                self._probing = 0
            # half-open: bounded concurrent probes, everyone else sheds
            if self._probing < self.probes:
                self._probing += 1
                return "probe"
            return "shed"

    def record_success(self) -> None:
        """Feedback: a normal-path (or probe) call succeeded."""
        with self._lock:
            self._failures = 0
            if self._state != self.CLOSED:
                self._transition(self.CLOSED)
                self._probing = 0

    def record_failure(self) -> None:
        """Feedback: a normal-path (or probe) call failed."""
        trip = False
        with self._lock:
            if self._state == self.HALF_OPEN:
                # failed probe: straight back to open, fresh cooldown
                self._transition(self.OPEN)
                self._open_until = time.monotonic() + self.cooldown
                self._probing = 0
                self.trips += 1
                trip = True
            elif self._state == self.CLOSED:
                self._failures += 1
                if self._failures >= self.threshold:
                    self._transition(self.OPEN)
                    self._open_until = time.monotonic() + self.cooldown
                    self.trips += 1
                    trip = True
        if trip and self.on_trip is not None:
            self.on_trip()


@dataclasses.dataclass(frozen=True)
class Resilience:
    """The failure-domain configuration (see ``docs/TUNING.md``).

    ``breaker_threshold=None`` disables circuit breaking; ``deadline``
    is the default per-request deadline in seconds (``None`` = no
    deadline; ``submit(..., deadline=)`` overrides per request);
    ``fission=False`` keeps batch-wide error delivery (every waiter of a
    failed batch gets the batch's exception) instead of isolating
    failing params by binary fission-retry.  The serving knobs:
    ``quarantine_ticks`` holds a crashed lane out of allocation after
    recovery; ``lane_fail_threshold`` consecutive failures on one
    template raise :class:`LaneFailedError`."""

    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    deadline: Optional[float] = None
    breaker_threshold: Optional[int] = 8
    breaker_cooldown: float = 0.05
    breaker_probes: int = 1
    fission: bool = True
    quarantine_ticks: int = 8
    lane_fail_threshold: int = 32


class FailureDomain:
    """Per-lane breaker + retry-budget registry for one runtime/scheduler.

    Lazily creates a :class:`CircuitBreaker` and :class:`RetryBudget`
    per lane key from the :class:`Resilience` config; ``on_trip`` (if
    given) is invoked once per breaker trip — runtimes wire it to their
    ``breaker_trips`` counter."""

    def __init__(self, config: Resilience, on_trip=None):
        self.config = config
        self.retry = config.retry
        self._on_trip = on_trip
        self._lock = threading.Lock()
        self._breakers: dict = {}
        self._budgets: dict = {}

    def breaker(self, key) -> Optional[CircuitBreaker]:
        """This lane's breaker (``None`` when breaking is disabled)."""
        if self.config.breaker_threshold is None:
            return None
        br = self._breakers.get(key)
        if br is None:
            with self._lock:
                br = self._breakers.get(key)
                if br is None:
                    br = self._breakers[key] = CircuitBreaker(
                        threshold=self.config.breaker_threshold,
                        cooldown=self.config.breaker_cooldown,
                        probes=self.config.breaker_probes,
                        on_trip=self._on_trip,
                    )
        return br

    def budget(self, key) -> RetryBudget:
        """This lane's retry-token bucket (created on first use)."""
        b = self._budgets.get(key)
        if b is None:
            with self._lock:
                b = self._budgets.get(key)
                if b is None:
                    b = self._budgets[key] = RetryBudget(
                        self.retry.retry_budget, self.retry.budget_earn)
        return b

    def snapshot(self) -> dict:
        """Per-lane breaker states + budget balances (introspection)."""
        with self._lock:
            return {
                "breakers": {k: b.state for k, b in self._breakers.items()},
                "budgets": {k: b.tokens for k, b in self._budgets.items()},
            }
