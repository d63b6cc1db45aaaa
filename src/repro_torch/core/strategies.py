"""Batch-size decision strategies for asynchronous batching (paper §5.2.3).

A free worker thread observes the pending-request queue and asks its
strategy *how many requests to take*.  The strategies are exactly the
paper's:

* :class:`PureAsync` — always take 1 (plain asynchronous submission, §3).
* :class:`PureBatch` — take everything, but only once the producer is done
  (classic batching of [1]: one set-oriented execution of the whole loop).
* :class:`OneOrAll` — ``n == 1 → 1`` else take all ``n`` (§5.2.3).
* :class:`LowerThreshold` — take all when ``n > bt`` (``bt ≥ 3``, motivated
  by batching's 3 round trips: param insert, batched query, cleanup), else
  take 1 (§5.2.3).
* :class:`GrowingUpperThreshold` — cap the batch at a doubling upper bound
  so early batches stay small (better time-to-first-response) while later
  batches amortize (§5.2.3).  Orthogonal to the lower threshold; the class
  composes both, as the paper notes.

Beyond the paper's static strategies:

* :class:`AdaptiveCost` — learns the service's cost structure online.  The
  paper fixes ``bt >= 3`` from SQL's 3-round-trip batch overhead; a generic
  service (Web API, model server) has an *unknown* fixed overhead ``F`` and
  per-item cost ``c`` for batches, and single-request latency ``s``.  The
  runtime reports every call's ``(batch_size, duration)`` back through
  :meth:`observe`; the strategy fits ``T_batch(n) = F + n·c`` by
  exponentially-weighted least squares and keeps an EWMA of ``s``, then
  batches exactly when predicted batch time beats individual submission:
  ``F + n·c < n·s  ⇔  n > F/(s − c)`` — a *learned* lower threshold.  When
  the serving scheduler also reports decode-tick durations, their EWMA
  ``d`` enters the comparison as a per-call occupancy amortized by the
  batch (``n > (F + d)/(s + d − c)``), so decode-heavy lanes batch sooner.

``decide`` receives the full queue state; returning ``0`` means "wait".
Since the lock-sharded runtime, "wait" is event-driven, not polled: a
lane whose strategy answered ``0`` is parked and re-asked when that
lane's queue state changes (a new submission, a straggler re-enqueue) or
when ``producer_done`` fires — never on a timer.  A custom strategy's
``0`` must therefore be a function of the observed backlog/producer
state, not of wall-clock time alone, or its lane can park indefinitely.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

__all__ = [
    "BatchingStrategy",
    "PureAsync",
    "PureBatch",
    "OneOrAll",
    "LowerThreshold",
    "GrowingUpperThreshold",
    "AdaptiveCost",
    "from_name",
]


class BatchingStrategy:
    """Decide how many pending requests a free worker should take.

    ``decide`` returning ``0`` parks the lane until its queue state
    changes (new submission / straggler re-enqueue / ``producer_done``) —
    the runtime does not re-poll on a timer, so ``0`` must follow from
    the arguments, not from wall-clock time (see module docstring).
    """

    def decide(self, n_pending: int, producer_done: bool) -> int:
        """How many of ``n_pending`` requests to take now (0 = wait)."""
        raise NotImplementedError

    def reset(self) -> None:
        """Clear per-run state (e.g. a growing threshold, learned fits)."""

    def observe(self, batch_size: int, duration: float) -> None:
        """Feedback from the runtime after each service call.  Static
        strategies ignore it; adaptive ones learn from it."""

    def observe_decode(self, duration: float) -> None:
        """Serving-side feedback: one decode tick's duration while this
        strategy's lane had requests running.  Static strategies ignore it;
        adaptive ones track the lane's steady-state per-token cost."""

    def observe_abort(self, duration: float, depth: int = 1) -> None:
        """Serving-side feedback: a speculative prefill for this strategy's
        lane was dispatched (paying ``duration`` seconds of prefill) but
        aborted before commit — the lane it bet on was never freed, or the
        requests were retired/evicted first — so the work was wasted.
        ``depth`` is the bet's pipeline depth: how many tick boundaries it
        sat staged (1 for the single-bet pipeline), i.e. how long it held
        promised lane capacity that admission could not use.  Each aborted
        bet reports separately, attributed with ITS depth.  Static
        strategies ignore the call; adaptive ones fold the depth-scaled
        wasted time into the lane's fixed cost so a lane whose
        speculations keep missing batches later instead of speculating
        harder."""

    def observe_failure(self, duration: float) -> None:
        """Failure feedback: a service call (or serving submission) for
        this strategy's lane failed after ``duration`` seconds.  Failed
        calls never feed :meth:`observe` (a fast-failing service would
        corrupt the learned latencies), but they are not free either —
        the time was spent and the work must be redone.  Static
        strategies ignore the call; adaptive ones fold the wasted time
        into the lane's fixed cost (like the abort penalty), so a flaky
        lane demands a deeper backlog before batching — each batch risks
        a larger redo."""


@dataclasses.dataclass
class PureAsync(BatchingStrategy):
    """Always take one pending request (plain asynchronous submission, §3)."""

    def decide(self, n_pending: int, producer_done: bool) -> int:
        """One request whenever any is pending."""
        return 1 if n_pending >= 1 else 0


@dataclasses.dataclass
class PureBatch(BatchingStrategy):
    """The [1] baseline: a single set-oriented execution of all requests."""

    def decide(self, n_pending: int, producer_done: bool) -> int:
        """Everything at once — but only after the producer finished."""
        if producer_done and n_pending >= 1:
            return n_pending
        return 0


@dataclasses.dataclass
class OneOrAll(BatchingStrategy):
    """Take one when one is pending, everything otherwise (§5.2.3)."""

    def decide(self, n_pending: int, producer_done: bool) -> int:
        """One when one is pending; the whole backlog otherwise."""
        if n_pending == 0:
            return 0
        return 1 if n_pending == 1 else n_pending


@dataclasses.dataclass
class LowerThreshold(BatchingStrategy):
    """Take all iff ``n > bt``; else take one.  The paper derives ``bt >= 3``
    from batching's fixed 3-round-trip overhead."""

    bt: int = 3

    def __post_init__(self):
        if self.bt < 3:
            raise ValueError("batching threshold bt must be >= 3 (paper §5.2.3)")

    def decide(self, n_pending: int, producer_done: bool) -> int:
        """All pending iff the backlog exceeds ``bt``; one otherwise."""
        if n_pending == 0:
            return 0
        return n_pending if n_pending > self.bt else 1


class GrowingUpperThreshold(BatchingStrategy):
    """Bound batches by an upper threshold that doubles whenever a batch of
    exactly the current threshold size is emitted.  Optionally composed with
    a lower threshold (``bt``): below ``bt`` requests go out individually.
    """

    def __init__(self, initial_upper: int = 200, bt: int | None = None, growth: int = 2):
        if bt is not None and bt < 3:
            raise ValueError("batching threshold bt must be >= 3 (paper §5.2.3)")
        self.initial_upper = initial_upper
        self.bt = bt
        self.growth = growth
        self._lock = threading.Lock()
        self._upper = initial_upper

    def reset(self) -> None:
        """Shrink the upper threshold back to its initial value."""
        with self._lock:
            self._upper = self.initial_upper

    @property
    def upper(self) -> int:
        """The current (doubling) upper batch-size threshold."""
        with self._lock:
            return self._upper

    def decide(self, n_pending: int, producer_done: bool) -> int:
        """Up to the current upper threshold; a full-threshold batch
        doubles the threshold for the batches after it (Fig. 10 ramp)."""
        if n_pending == 0:
            return 0
        if self.bt is not None and n_pending <= self.bt:
            return 1
        with self._lock:
            if n_pending <= self._upper:
                return n_pending
            take = self._upper
            # A full-threshold batch was just formed: grow for future batches.
            self._upper *= self.growth
            return take

    def __repr__(self) -> str:
        return (
            f"GrowingUpperThreshold(initial_upper={self.initial_upper}, "
            f"bt={self.bt}, growth={self.growth})"
        )


class AdaptiveCost(BatchingStrategy):
    """Cost-model-based adaptive batching (learned lower threshold).

    Model (times in seconds, learned online from :meth:`observe`):

      * ``s``  — EWMA latency of single-request executions;
      * ``F, c`` — intercept/slope of ``T_batch(n) = F + n·c``, fit by
        exponentially-decayed least squares over batched executions;
      * ``d``  — EWMA decode-tick latency from :meth:`observe_decode`
        (serving feedback; 0 until the scheduler reports any).

    Draining ``n`` pending requests costs ``n·s`` submitted individually
    (one connection, serialized) vs ``F + n·c`` as one set-oriented call, so
    batching wins iff ``n > F/(s − c)``.  ``decide`` takes everything when
    the backlog clears that learned threshold, else one.

    **Decode occupancy.**  In continuous batching one decode tick serves the
    whole admitted batch at once, so a batch pays the expected decode
    occupancy ``d`` ONCE per service call — exactly like the fixed prefill
    cost ``F`` — while ``n`` individually-submitted requests each pay their
    own ``d``.  With decode evidence the comparison becomes
    ``F + n·c + d  <  n·(s + d)``, i.e. a *learned* threshold
    ``(F + d)/(s + d − c)``: a decode-heavy lane (large ``d``) batches
    sooner, because its per-request cost is dominated by decode ticks that
    batching amortizes.  Without decode evidence (``d`` unobserved) the
    threshold reduces to the paper-style ``F/(s − c)``.

    Until ``min_samples`` observations of each kind exist the strategy
    *explores*: it alternates single executions and take-all batches so both
    sides of the model get data (and batch sizes vary enough to identify the
    slope).  If the data says batching never pays (``s <= c``) it degrades
    to pure async.
    """

    def __init__(self, alpha: float = 0.3, min_samples: int = 3,
                 max_take: Optional[int] = None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self.min_samples = min_samples
        self.max_take = max_take
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Forget all learned evidence (per-run state)."""
        with getattr(self, "_lock", threading.Lock()):
            self._s: Optional[float] = None  # EWMA single latency
            self._d: Optional[float] = None  # EWMA decode-tick latency (serving)
            self._ab: Optional[float] = None  # EWMA wasted spec-prefill time
            self._ab_depth: Optional[float] = None  # EWMA aborted-bet depth
            self._fl: Optional[float] = None  # EWMA wasted failed-call time
            self._n_single = 0
            self._n_batch = 0
            self.aborts = 0  # speculative prefills wasted (observe_abort calls)
            self.failures = 0  # failed service calls (observe_failure calls)
            # decayed least-squares moments for T(n) = F + n*c
            self._w = self._sn = self._st = self._snt = self._snn = 0.0
            self._explore_flip = False

    # ------------------------------------------------------------- learning
    def observe(self, batch_size: int, duration: float) -> None:
        """Fold one service call's ``(batch_size, duration)`` into the model:
        size-1 calls update the single-latency EWMA ``s``; larger ones feed
        the decayed least-squares fit of ``T_batch(n) = F + n·c``.  Each
        *successful* batch also decays the abort penalty (see
        :meth:`observe_abort`) — speculation that has started landing again
        stops being taxed."""
        with self._lock:
            if batch_size <= 1:
                self._n_single += 1
                self._s = (
                    duration if self._s is None
                    else (1 - self.alpha) * self._s + self.alpha * duration
                )
                return
            self._n_batch += 1
            if self._ab:
                self._ab *= 1 - self.alpha  # a landed batch: decay the penalty
            if self._fl:
                self._fl *= 1 - self.alpha  # a healthy call: decay the penalty
            d = 1 - self.alpha  # decay old evidence
            self._w = self._w * d + 1.0
            self._sn = self._sn * d + batch_size
            self._st = self._st * d + duration
            self._snt = self._snt * d + batch_size * duration
            self._snn = self._snn * d + batch_size * batch_size

    def observe_decode(self, duration: float) -> None:
        """Fold one decode-tick duration into the lane's decode EWMA ``d``."""
        with self._lock:
            self._d = (
                duration if self._d is None
                else (1 - self.alpha) * self._d + self.alpha * duration
            )

    def observe_abort(self, duration: float, depth: int = 1) -> None:
        """Charge one wasted speculative prefill to this lane's cost model.

        The wasted cost is the dispatch ``duration`` scaled by the bet's
        pipeline ``depth``: a bet that sat staged for ``d`` tick
        boundaries also held promised lane capacity for ``d`` ticks that
        admission could not use, so a depth-4 miss is charged four times
        the depth-1 miss of the same dispatch — deep pipelines that keep
        missing throttle themselves faster than shallow ones.  The scaled
        cost enters an EWMA ``ab`` that is added to the fixed cost in
        :attr:`threshold` (``(F + d + ab)/(s + d − c)``): the lane
        effectively pays its wasted speculation as extra per-batch setup,
        demanding a deeper backlog before batching/speculating again.
        Successful batches decay the penalty back toward zero
        (:meth:`observe`).  ``abort_depth`` tracks the EWMA of reported
        depths (introspection: how deep this lane's misses run)."""
        cost = duration * max(1, depth)
        with self._lock:
            self.aborts += 1
            self._ab = (
                cost if self._ab is None
                else (1 - self.alpha) * self._ab + self.alpha * cost
            )
            self._ab_depth = (
                float(depth) if self._ab_depth is None
                else (1 - self.alpha) * self._ab_depth + self.alpha * depth
            )

    def observe_failure(self, duration: float) -> None:
        """Charge one failed service call's wasted time to the model.

        Failure feedback enters the same way abort feedback does: an EWMA
        ``fl`` added to the fixed cost in :attr:`threshold`
        (``(F + d + ab + fl)/(s + d − c)``), so a flaky lane batches
        later — every batch on it risks ``fl`` seconds of redone work —
        and successful calls decay the penalty back toward zero
        (:meth:`observe`)."""
        with self._lock:
            self.failures += 1
            self._fl = (
                duration if self._fl is None
                else (1 - self.alpha) * self._fl + self.alpha * duration
            )

    @property
    def failure_penalty(self) -> float:
        """Current EWMA of wasted failed-call time (0.0 when no failure
        has been observed, or once healthy calls decayed it away)."""
        with self._lock:
            return self._fl or 0.0

    @property
    def abort_penalty(self) -> float:
        """Current EWMA of wasted speculative-prefill time (depth-scaled;
        0.0 when no abort has been observed, or once successful batches
        have decayed the penalty away)."""
        with self._lock:
            return self._ab or 0.0

    @property
    def abort_depth(self) -> Optional[float]:
        """EWMA of the pipeline depth at which this lane's speculative
        bets abort (``None`` until any abort is observed) — introspection
        for tuning ``spec_depth``: a lane whose misses run deep wastes
        promised capacity for longer per miss."""
        with self._lock:
            return self._ab_depth

    @property
    def decode_latency(self) -> Optional[float]:
        """EWMA of observed decode-tick durations for this lane (``None``
        until the scheduler reports any) — the per-token side of the lane's
        cost model, alongside the prefill ``F + n·c`` fit."""
        with self._lock:
            return self._d

    def estimates(self) -> Optional[tuple]:
        """``(F, c, s)`` once enough evidence exists, else ``None``."""
        with self._lock:
            if (self._s is None or self._n_single < self.min_samples
                    or self._n_batch < self.min_samples or self._w <= 0):
                return None
            mean_n = self._sn / self._w
            mean_t = self._st / self._w
            var_n = self._snn / self._w - mean_n * mean_n
            if var_n <= 1e-12:  # all batches same size: slope unidentifiable
                return None
            cov = self._snt / self._w - mean_n * mean_t
            c = cov / var_n
            f = mean_t - c * mean_n
            return max(f, 0.0), max(c, 0.0), self._s

    @property
    def threshold(self) -> Optional[float]:
        """The learned batching threshold ``(F + d + ab + fl)/(s + d − c)``
        — decode occupancy ``d``, the speculative-abort penalty ``ab``
        and the failure penalty ``fl`` are amortized by the batch like
        the fixed cost, each individual submission paying its own
        (``F/(s − c)`` while no decode ticks, aborts or failures have
        been observed).  ``inf`` when batching never pays; ``None`` while
        still exploring."""
        est = self.estimates()
        if est is None:
            return None
        f, c, s = est
        d = self.decode_latency or 0.0
        ab = self.abort_penalty
        fl = self.failure_penalty
        if s + d <= c:
            return float("inf")
        return (f + d + ab + fl) / (s + d - c)

    # ------------------------------------------------------------- decision
    def decide(self, n_pending: int, producer_done: bool) -> int:
        """Take everything when the backlog clears the learned threshold,
        one otherwise; alternate single/take-all while still exploring."""
        if n_pending == 0:
            return 0
        cap = self.max_take or n_pending
        bt = self.threshold
        if bt is None:  # explore: feed both sides of the cost model
            if n_pending == 1:
                return 1
            with self._lock:
                self._explore_flip = not self._explore_flip
                take_all = self._explore_flip
            return min(n_pending, cap) if take_all else 1
        if bt == float("inf"):
            return 1
        return min(n_pending, cap) if n_pending > bt else 1

    def __repr__(self) -> str:
        return (f"AdaptiveCost(alpha={self.alpha}, "
                f"min_samples={self.min_samples}, threshold={self.threshold})")


def from_name(name: str, **kw) -> BatchingStrategy:
    """Construct a strategy by its CLI/benchmark name (see ``table``)."""
    table = {
        "async": PureAsync,
        "batch": PureBatch,
        "one_or_all": OneOrAll,
        "lower_threshold": LowerThreshold,
        "growing_upper": GrowingUpperThreshold,
        "adaptive": AdaptiveCost,
    }
    try:
        return table[name](**kw)
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; one of {sorted(table)}") from None
