"""Continuous batching scheduler — the paper's §5.2 as ML serving.

The decode loop has a *true-dependence cycle* (token t+1 needs token t), so
device-level Rule A cannot fission it — exactly the paper's inapplicable
case (§4.1).  The paper's answer is runtime **asynchronous batching**: keep
requests flowing through a queue and let free capacity decide, adaptively,
between latency (serve one now) and throughput (batch many).  Continuous
batching in LLM serving is that same decision made per engine tick, and the
paper's strategies transfer verbatim:

  admission per tick = strategy.decide(queue_length, producer_done)

  * PureAsync        → admit one request at a time (latency-optimal ttft
                       for the head of the queue, poor throughput)
  * OneOrAll         → admit everything waiting
  * LowerThreshold   → admit all only when the backlog exceeds bt (batch
                       setup — a prefill dispatch — costs ~3 decode ticks)
  * GrowingUpper     → cap admissions at a doubling threshold: small early
                       batches protect time-to-first-token, large late
                       batches protect throughput (Fig. 10's ramp)
  * AdaptiveCost     → learns prefill fixed-vs-per-item cost from observed
                       admit() durations and batches when it pays

Like the sharded :class:`~repro.core.runtime.AsyncQueryRuntime`, pending
requests are held in one lane per :attr:`Request.template`: each admission
batch is drawn from a single template's lane (homogeneous prompts bucket
tighter in the padded prefill), and mixed traffic classes stop head-of-line
blocking each other.  The strategy is consulted per lane; admission
round-robins over lanes while engine slots remain free.

With a :class:`~repro.core.lane_policy.LanePolicy` (``policy=``), each
template lane is asked its OWN strategy (hot templates learn a per-lane
AdaptiveCost model, cold ones stay pure-async), lanes are visited in
weighted-fair order instead of round-robin, and both prefill (admit) and
decode-tick durations feed back into that lane's cost model.  Admission
also passes the template to :meth:`InferenceEngine.admit`, which pins one
compiled prefill shape per template and — with ``kv_shares`` — bounds the
batch by that template's reserved + shared KV lanes
(:meth:`InferenceEngine.n_free_for`), so a burst on one template cannot
evict or starve the others' cache residency.

Admission consumes the same :class:`~repro.core.concurrency.ReadyLanes`
structure the lock-sharded runtime's workers drain: lanes with queued
requests sit in a duplicate-suppressed ready queue, each tick pops lanes
(weighted-fair under a policy, FIFO/round-robin otherwise) only while
engine slots remain free, and lanes with leftover backlog are re-queued —
a tick never scans lanes that have nothing to admit.

**Speculative prefill overlap** (``overlap=True``) — the paper's core
claim, applied to the tick loop itself: results should already be fetched
by the time they are consumed, so the *next* batch's prefill should be in
flight while the *current* decode tick runs, not after it.  Each tick
becomes a two-stage pipeline:

  commit(staged) → admit → speculate(dispatch next lane's prefill)
                                      ∥ decode tick t
  commit at tick t+1's boundary ──────┘

The scheduler peeks (without popping — :meth:`ReadyLanes.peek`) the next
ready lane, sizes a batch against the lanes that are free now *plus* the
lanes decode is about to retire (the speculation), and dispatches its
padded prefill on a separate thread through
:meth:`InferenceEngine.prefill_dispatch` while :meth:`decode_tick` runs.
At the next tick boundary the staged KV is committed into lanes
(:meth:`InferenceEngine.commit_prefill`).  If the bet missed — the lanes
it counted on were never freed, or freed into another template's
reservation — the uncommitted requests go back to the head of their queue
and the wasted prefill time feeds the lane's own cost model via
``observe_abort``, so chronically-missing lanes speculate less.

**Depth-k speculation** (``spec_depth=k``, default 1) generalizes the
single staged bet to a bounded pipeline: up to ``k`` dispatched-but-
uncommitted prefills ride in flight at once, each sized against the free
lanes MINUS the capacity already promised to older staged bets (older
bets claim their lanes first; a younger bet may only count lanes the
older ones cannot take).  Bets settle oldest-first at every tick
boundary; when an older bet misses, younger bets survive only while
their template's own reserved lanes still cover them — an uncovered
younger bet aborts immediately (its lane's ``observe_abort`` is charged
with the bet's pipeline depth) rather than wasting further boundaries.
Depth pays off when prefill capacity is separate from decode (the
disaggregated shape): ``k`` prefills progress concurrently under one
decode stream, submitting well AHEAD of the consumption point exactly as
the paper's §5.1 thread does for queries.

**Chunked prefill** (``chunk_tokens=n``) keeps one huge prompt from
stalling the pipeline: a prompt wider than ``n`` is dispatched alone and
processed as resumable chunks (:meth:`InferenceEngine.prefill_resume`) —
one chunk per tick boundary rides the speculation thread under that
tick's decode, and the bet commits when the last chunk lands.  Younger
bets queue behind it (commits stay oldest-first) but decode never stops.

**Host KV spill** (engine ``kv_spill=HostSpillPool(...)``): a straggler
force-retire stages the lane's KV to host memory instead of dropping it
(``stats.kv_spilled``); when the request is re-admitted, admission
restores the KV into a fresh lane and generation RESUMES
(``stats.kv_restored``) — no re-prefill, no token restart.  Requests
with staged KV are kept out of speculative prefill batches (the restore
path is strictly cheaper).

The scheduler records the per-tick admission trace (= Fig. 10 batch sizes,
also split per lane) and per-request ttft/latency (= Fig. 11
time-to-k-th-response).

Straggler mitigation: a lane whose request exceeds ``lane_timeout`` decode
ticks is force-retired and the request re-queued (re-submission, as in the
runtime's fetch-timeout path).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

from repro_torch import tracing
from repro_torch.core.concurrency import ReadyLanes
from repro_torch.core.lane_policy import LanePolicy
from repro_torch.core.resilience import (
    FailureDomain,
    LaneError,
    LaneFailedError,
    Resilience,
)
from repro_torch.core.strategies import BatchingStrategy, PureAsync
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.request import Request

__all__ = ["ContinuousBatchingScheduler"]


@dataclasses.dataclass
class SchedulerStats:
    """Per-scheduler counters and traces (one instance per scheduler)."""

    admission_trace: list = dataclasses.field(default_factory=list)  # (tick, n)
    # per-template (tick, n) admission traces (runtime lane analogue)
    lane_admissions: dict = dataclasses.field(default_factory=dict)
    decode_ticks: int = 0
    completed: int = 0
    requeued: int = 0
    # speculative-prefill pipeline (overlap=True)
    spec_dispatched: int = 0  # requests whose prefill was dispatched early
    spec_committed: int = 0   # of those, committed into KV lanes
    spec_aborted: int = 0     # of those, re-queued (the bet missed)
    spec_chunks: int = 0      # chunked-prefill resume steps processed
    # host KV spill (engine kv_spill=HostSpillPool)
    kv_spilled: int = 0       # evicted lanes whose KV was staged to host
    kv_restored: int = 0      # re-admissions served by a restore (no prefill)
    # prefix-granular KV sharing (engine prefix_share=True): admissions
    # that aliased a resident page-aligned prompt prefix instead of
    # recomputing it (mirrored from the engine's own counter each tick)
    prefix_hits: int = 0
    # failure domain (resilience=Resilience(...))
    quarantined: int = 0      # lanes held out after a device-step crash
    decode_retries: int = 0   # decode ticks re-run after a transient fault
    prefill_retries: int = 0  # admit() calls re-run after a transient fault
    spec_crashes: int = 0     # spec-thread dispatches that raised (aborted)
    breaker_trips: int = 0    # per-template circuit-breaker trips


class _SpecTask:
    """One in-flight speculative prefill (one bet of the depth-k pipeline).

    The dispatch runs on its own daemon thread so the host-side padding +
    device dispatch overlaps the main thread's decode tick; the main
    thread settles bets at tick boundaries, oldest-first.  At most
    ``spec_depth`` tasks are in flight, so a plain thread per dispatch
    costs nothing worth pooling.  A chunked task (``chunk`` set and an
    oversized prompt) is re-armed by :meth:`advance` once per boundary
    until every chunk has been folded in; ``duration`` accumulates across
    chunks so the cost model sees the bet's full dispatch time."""

    __slots__ = ("template", "batch", "chunk", "staged", "duration", "error",
                 "age", "_thread")

    def __init__(self, engine, template: str, batch: list,
                 chunk: Optional[int] = None):
        self.template = template
        self.batch = batch
        self.chunk = chunk
        self.staged = None
        self.duration = 0.0
        self.error: Optional[BaseException] = None
        self.age = 0  # tick boundaries this bet has been in flight
        self._spawn(engine)

    def _spawn(self, engine) -> None:
        self._thread = threading.Thread(
            target=self._run, args=(engine,), daemon=True,
            name="cbs-spec-prefill",
        )
        tracing.handoff(self._thread)
        self._thread.start()

    def _run(self, engine) -> None:
        t0 = time.perf_counter()
        try:
            if self.staged is None:
                if self.chunk is None:
                    self.staged = engine.prefill_dispatch(
                        self.batch, template=self.template)
                else:
                    self.staged = engine.prefill_dispatch(
                        self.batch, template=self.template, chunk=self.chunk)
            else:
                engine.prefill_resume(self.staged)
        except BaseException as e:  # noqa: BLE001 — surfaced at commit
            self.error = e
        self.duration += time.perf_counter() - t0

    @property
    def finished(self) -> bool:
        """Whether the current dispatch/resume thread has returned (a
        non-blocking check — younger bets are only committed when they
        have already finished, never waited on)."""
        return not self._thread.is_alive()

    @property
    def complete(self) -> bool:
        """Whether the staged prefill is commit-eligible: dispatched, and
        (for a chunked bet) every chunk folded in.  Engines without chunk
        support stage complete results in one dispatch."""
        return (self.staged is not None
                and getattr(self.staged, "complete", True))

    def advance(self, engine) -> None:
        """Re-arm a chunked task: fold the next chunk on a fresh spec
        thread (it overlaps the decode tick now starting)."""
        self._spawn(engine)

    def join(self) -> None:
        """Block until the dispatch thread has finished (commit boundary)."""
        self._thread.join()


class ContinuousBatchingScheduler:
    """Per-template admission + one batched decode step per tick.

    Parameters
    ----------
    engine:
        The lane-holding engine.  Any object with the
        :class:`InferenceEngine` admission/decode surface works; the
        ``overlap=True`` pipeline additionally needs the split dispatch
        path (``prefill_dispatch`` / ``commit_prefill`` / ``n_free_for``).
    strategy / policy:
        One global :class:`BatchingStrategy`, or a per-lane
        :class:`LanePolicy` (mutually exclusive).
    lane_timeout:
        Decode ticks before a running request is force-retired and
        re-queued (straggler mitigation); ``None`` disables.  With an
        engine spill pool the retired lane's KV is staged to host memory
        and the re-queued request resumes on re-admission.
    overlap:
        Enable the speculative prefill/decode pipeline (module docstring).
    spec_depth:
        Maximum staged speculative prefills in flight (default 1 — the
        single-bet pipeline).  Values above 1 need ``overlap=True`` and
        pay off when prefill hardware is separate from decode.
    chunk_tokens:
        Split any prompt wider than this into resumable prefill chunks
        (one per tick boundary) so a single huge prompt overlaps decode
        instead of stalling the commit boundary.  Needs ``overlap=True``
        and an engine with ``prefill_resume``; ``None`` disables.
    resilience:
        A :class:`~repro.core.resilience.Resilience` config enabling the
        failure domain: transient admit/decode faults are retried with
        backoff, a device-step :class:`~repro.core.resilience.LaneError`
        quarantines the crashed lane (KV salvaged via the spill pool when
        one exists) and re-queues its request at the head, a spec-thread
        crash aborts that bet cleanly instead of wedging the pipeline,
        and a per-template circuit breaker sheds chronically-failing
        lanes' speculation.  A template whose submissions fail
        ``lane_fail_threshold`` times consecutively raises a typed
        :class:`~repro.core.resilience.LaneFailedError` naming the
        template and last exception.  ``None`` (default) keeps the
        legacy fail-fast behavior: any engine exception propagates.
    """

    def __init__(
        self,
        engine: InferenceEngine,
        strategy: Optional[BatchingStrategy] = None,
        lane_timeout: Optional[int] = None,
        policy: Optional[LanePolicy] = None,
        overlap: bool = False,
        spec_depth: int = 1,
        chunk_tokens: Optional[int] = None,
        resilience: Optional[Resilience] = None,
    ):
        if policy is not None and strategy is not None:
            raise ValueError(
                "pass either a global `strategy` or a per-lane `policy`, not both"
            )
        self.engine = engine
        self.policy = policy
        self.strategy = strategy or PureAsync()
        self.strategy.reset()
        self.overlap = overlap
        if overlap and not hasattr(engine, "prefill_dispatch"):
            raise ValueError(
                "overlap=True needs an engine with the split dispatch path "
                "(prefill_dispatch/commit_prefill/n_free_for)"
            )
        if spec_depth < 1:
            raise ValueError("spec_depth must be >= 1")
        if spec_depth > 1 and not overlap:
            raise ValueError("spec_depth > 1 needs overlap=True")
        if chunk_tokens is not None:
            if chunk_tokens < 1:
                raise ValueError("chunk_tokens must be >= 1")
            if not overlap:
                raise ValueError("chunk_tokens needs overlap=True")
            if not hasattr(engine, "prefill_resume"):
                raise ValueError(
                    "chunk_tokens needs an engine with prefill_resume "
                    "(resumable chunked prefill)"
                )
        self.spec_depth = spec_depth
        self.chunk_tokens = chunk_tokens
        # The one capacity surface (:class:`repro.serving.kv.KVView`):
        # engines expose it as ``engine.kv``; duck-typed bench/test engines
        # without one are consumed directly (they mirror the same names).
        self._kv = getattr(engine, "kv", None) or engine
        # Page-pressure evictions (paged engine oversubscription): the
        # engine notifies synchronously AT eviction time — before the freed
        # lane can be reallocated to a new request — so the victim's
        # running-table entry is cleared while it still refers to the
        # evicted request.  Engines without the hook never evict mid-decode.
        if hasattr(engine, "on_lane_evicted"):
            engine.on_lane_evicted = self._lane_evicted
        # Engines predating KV partitioning expose only the global n_free;
        # treat every template as drawing from one shared pool there.
        self._free_for = getattr(self._kv, "n_free_for",
                                 lambda tmpl: self._kv.n_free)
        # template -> pending requests; insertion-ordered for round-robin
        self.queues: "OrderedDict[str, deque[Request]]" = OrderedDict()
        self.running: dict[int, Request] = {}  # lane -> request
        self.stats = SchedulerStats()
        self.lane_timeout = lane_timeout
        self._lane_age: dict[int, int] = {}
        # Lanes with queued requests (same structure the runtime's workers
        # drain): FIFO pop + tail re-push is round-robin over busy lanes;
        # with a policy the pop is weighted-fair.  Single-threaded here, so
        # its lock is never contended.
        self._ready = ReadyLanes()
        self._warm_shapes: set = set()  # prefill buckets already compiled
        self._producer_done = False
        # The speculation pipeline: up to spec_depth in-flight bets,
        # oldest first (index 0 settles at the next tick boundary).
        self._staged: "deque[_SpecTask]" = deque()
        # Failure domain (resilience=Resilience(...)): breakers + retry
        # budgets per template, consecutive-failure records, and lanes
        # held in quarantine until a decode-tick deadline.
        self.resilience = resilience
        self._fd = (
            FailureDomain(resilience, on_trip=self._on_breaker_trip)
            if resilience is not None else None
        )
        self._lane_failures: dict[str, tuple] = {}  # tmpl -> (n, last exc)
        self._quarantine_release: dict[int, int] = {}  # lane -> release tick

    # ------------------------------------------------------------------ api
    def submit(self, request: Request) -> None:
        """Queue one request on its template's lane."""
        q = self.queues.get(request.template)
        if q is None:
            q = self.queues[request.template] = deque()
        q.append(request)
        self._ready.push(request.template)
        if self.policy is not None:
            self.policy.note_submit(request.template)

    @property
    def n_queued(self) -> int:
        """Requests waiting in lanes (staged/running not counted)."""
        return sum(len(q) for q in self.queues.values())

    def producer_done(self) -> None:
        """Signal that no more requests are coming (lets PureBatch-style
        strategies drain the tail)."""
        self._producer_done = True

    def run_until_drained(self, max_ticks: int = 100_000) -> list[Request]:
        """Tick until every submitted request has finished (or raise after
        ``max_ticks`` with a diagnosis of what is stuck)."""
        done: list[Request] = []
        for _ in range(max_ticks):
            if (not self.n_queued and not self.running
                    and not self._staged):
                if self._producer_done:
                    break
            done.extend(self.tick())
        else:
            if self.n_queued or self.running or self._staged:
                if self._lane_failures:
                    # An all-failing lane is a NAMED condition, not a
                    # generic stuck-lane timeout: surface which template
                    # is down and the exception its submissions die with.
                    tmpl, (n, exc) = max(self._lane_failures.items(),
                                         key=lambda kv: kv[1][0])
                    raise LaneFailedError(tmpl, n, exc)
                stuck_queued = {t: len(q) for t, q in self.queues.items() if q}
                stuck_running = {
                    lane: r.template for lane, r in sorted(self.running.items())
                }
                staged = (", staged spec prefills on "
                          f"{[t.template for t in self._staged]!r}"
                          if self._staged else "")
                raise RuntimeError(
                    f"run_until_drained exhausted max_ticks={max_ticks} with "
                    f"work still pending: queued per template {stuck_queued}, "
                    f"running lanes {stuck_running}{staged} "
                    f"({self.stats.completed} completed, "
                    f"{self.stats.requeued} requeued, "
                    f"{self.stats.spec_aborted} spec-aborted). A lane that "
                    "never finishes usually means the engine stopped emitting "
                    "tokens for it, max_new_tokens exceeds the tick budget, "
                    "or kv_shares leaves its template no admissible lane."
                )
        return done

    def _lane_evicted(self, lane: int, rid, template, spilled: bool) -> None:
        """Engine callback: ``lane``'s KV was evicted mid-decode by page
        pressure (oversubscribed paged pool).  The engine already spilled
        the KV to host (when a spill pool accepts it) and retired the
        lane; this hook re-queues the request at the head of its template
        lane — exactly the straggler re-queue path, minus the retire the
        engine performed itself.  With staged KV the re-admission restores
        and RESUMES; without, the partial generation is cleared and the
        re-admission re-prefills from scratch (greedy decode regenerates
        the same tokens, so end-to-end output is unchanged)."""
        r = self.running.pop(lane, None)
        if r is None:
            return
        if r.rid != rid:  # stale identity: not the request we were told of
            self.running[lane] = r
            return
        self._lane_age.pop(lane, None)
        if spilled:
            self.stats.kv_spilled += 1
        else:
            r.generated.clear()
        r.lane = None
        q = self.queues.get(r.template)
        if q is None:
            q = self.queues[r.template] = deque()
        q.appendleft(r)
        self._ready.push(r.template)
        self.stats.requeued += 1

    # ------------------------------------------------------- failure domain
    def _on_breaker_trip(self) -> None:
        self.stats.breaker_trips += 1

    def _record_lane_failure(self, tmpl, exc: BaseException) -> None:
        """Count a consecutive submission failure against ``tmpl`` (with
        its last exception, for the typed lane-down diagnosis)."""
        if tmpl is None:
            tmpl = "default"
        n, _ = self._lane_failures.get(tmpl, (0, None))
        self._lane_failures[tmpl] = (n + 1, exc)

    def _record_lane_success(self, tmpl) -> None:
        """A successful submission resets ``tmpl``'s consecutive-failure
        record."""
        self._lane_failures.pop(tmpl if tmpl is not None else "default", None)

    def _check_lane_health(self) -> None:
        """Raise a typed :class:`LaneFailedError` for any template whose
        consecutive submission failures crossed the threshold — the named
        all-failing-lane diagnosis, instead of requeueing forever and
        dying as a generic stuck-lane timeout."""
        if self.resilience is None:
            return
        limit = self.resilience.lane_fail_threshold
        if limit is None:
            return
        for tmpl, (n, exc) in self._lane_failures.items():
            if n >= limit:
                raise LaneFailedError(tmpl, n, exc)

    def _release_quarantine(self) -> None:
        """Return quarantined lanes whose cooldown (in decode ticks) has
        elapsed to their home pools."""
        if not self._quarantine_release:
            return
        unq = getattr(self._kv, "unquarantine", None)
        due = [lane for lane, t in self._quarantine_release.items()
               if self.stats.decode_ticks >= t]
        for lane in due:
            del self._quarantine_release[lane]
            if unq is not None:
                unq(lane)

    def _quarantine_lane(self, err: LaneError) -> None:
        """Crash-safe lane recovery: the device step raised for one lane.
        Salvage the request's KV through the spill pool when one exists
        (re-admission restores and RESUMES — no token restart), re-queue
        the request at the head of its lane, and hold the lane itself out
        of circulation for ``quarantine_ticks`` decode ticks so a
        lane-correlated fault (bad page, wedged stream) doesn't
        immediately poison the next admission."""
        lane = err.lane
        self.stats.quarantined += 1
        r = self.running.pop(lane, None)
        self._lane_age.pop(lane, None)
        if r is not None:
            spill = getattr(self.engine, "spill", None)
            if spill is not None:
                spilled = spill(lane, key=r.rid, template=r.template)
            else:
                self.engine.retire(lane)
                spilled = False
            if spilled:
                self.stats.kv_spilled += 1
            else:
                r.generated.clear()
            r.lane = None
            self._requeue_front(r.template, [r])
            self.stats.requeued += 1
            self._record_lane_failure(r.template, err)
        else:
            try:
                self.engine.retire(lane)
            except Exception:  # noqa: BLE001 — lane may already be free
                pass
        ticks = self.resilience.quarantine_ticks
        quarantine = getattr(self._kv, "quarantine", None)
        if ticks and quarantine is not None:
            try:
                quarantine(lane)
            except ValueError:
                return  # lane not free (engine state diverged): no holdout
            self._quarantine_release[lane] = self.stats.decode_ticks + ticks

    def _decode_with_recovery(self) -> dict:
        """One decode step under the failure domain: a
        :class:`LaneError` quarantines the named lane and re-runs the
        step for the surviving lanes (the crash consumed no tick — other
        requests lose no token); any other exception is retried with
        backoff while the policy allows, then propagates."""
        fd = self._fd
        if fd is None:
            return self.engine.decode_tick()
        policy = fd.retry
        crashes = 0
        attempt = 0
        while True:
            try:
                return self.engine.decode_tick()
            except LaneError as e:
                crashes += 1
                self.stats.decode_retries += 1
                self._quarantine_lane(e)
                if crashes > len(self.running) + 8:
                    raise  # runaway: every retry crashes a new lane
                continue
            except BaseException as e:  # noqa: BLE001 — bounded retry
                attempt += 1
                if (not policy.is_retryable(e)
                        or attempt >= max(1, policy.max_attempts)):
                    raise
                self.stats.decode_retries += 1
                policy.sleep_backoff(attempt, "decode")

    def _admit_with_retry(self, fresh: list, tmpl):
        """Synchronous admission under the failure domain: transient
        faults retry with backoff; success/failure feeds the template's
        breaker and consecutive-failure record.  Raises the last
        exception on final failure (the caller re-queues the batch)."""
        fd = self._fd
        if fd is None:
            return self.engine.admit(fresh, template=tmpl)
        policy = fd.retry
        breaker = fd.breaker(tmpl)
        last = None
        for attempt in range(max(1, policy.max_attempts)):
            if attempt > 0:
                self.stats.prefill_retries += 1
                policy.sleep_backoff(attempt, tmpl)
            try:
                shape = self.engine.admit(fresh, template=tmpl)
            except BaseException as e:  # noqa: BLE001 — bounded retry
                last = e
                if breaker is not None:
                    breaker.record_failure()
                if not policy.is_retryable(e):
                    break
                continue
            if breaker is not None:
                breaker.record_success()
            self._record_lane_success(tmpl)
            return shape
        self._record_lane_failure(tmpl, last)
        raise last

    # ------------------------------------------------- speculative pipeline
    def _strategy_for(self, tmpl: str) -> BatchingStrategy:
        return (self.policy.strategy_for(tmpl) if self.policy is not None
                else self.strategy)

    def _requeue_front(self, tmpl: str, batch: list) -> None:
        """Return an uncommitted speculative batch to the head of its lane
        (these requests were next in line; they must not lose their turn).
        The overlap markers are reset: metrics describe the attempt that
        finally lands, and this one did not."""
        q = self.queues.get(tmpl)
        if q is None:
            q = self.queues[tmpl] = deque()
        for r in reversed(batch):
            r.metrics.speculative = False
            q.appendleft(r)
        self._ready.push(tmpl)

    def _land_batch(self, tmpl: str, strat: BatchingStrategy, batch: list,
                    shape, duration: float) -> None:
        """Shared bookkeeping for a batch that just entered KV lanes —
        identical for synchronous admission and speculative commit, so the
        two paths cannot drift.

        Cost-model feedback is warm-shape guarded: the first dispatch of a
        padded bucket pays XLA compilation, an outlier that would blow up
        the learned fixed cost, so only steady-state durations are
        observed, sized by the bucket the device actually dispatched.
        ``duration`` is what the scheduler actually paid for the batch:
        the inline admit time on the synchronous path, dispatch + the
        commit-side materialization wait on the speculative one."""
        if shape in self._warm_shapes:
            strat.observe(shape[0], duration)
        else:
            self._warm_shapes.add(shape)
        if self.policy is not None:
            self.policy.charge(tmpl, len(batch))
        now = time.perf_counter()
        for r in batch:
            r.metrics.first_token = now  # prefill emits token 0
            self.running[r.lane] = r
            self._lane_age[r.lane] = 0
        self.stats.admission_trace.append((self.stats.decode_ticks, len(batch)))
        self.stats.lane_admissions.setdefault(tmpl, []).append(
            (self.stats.decode_ticks, len(batch)))

    def _reservation_covers(self, task: _SpecTask) -> bool:
        """Whether ``task``'s template's OWN reserved lanes can hold its
        whole batch right now — the survival test for a younger bet after
        an older bet missed: reserved lanes cannot be taken by any other
        template, so a covered bet is still a sound speculation.  Engines
        without per-template pools (no ``n_free_for``) report zero
        reserved lanes, so their younger bets abort on a miss —
        conservative, and settled the same way a depth-1 miss is."""
        reserved_free = self._free_for(task.template) - self._free_for(None)
        return len(task.batch) <= max(0, reserved_free)

    def _promised_against(self, tmpl: str) -> int:
        """Free-lane capacity already promised to in-flight staged bets
        that a new bet for ``tmpl`` must not count again.

        An older bet on the SAME template claims its whole batch from the
        pools ``tmpl`` draws on; an older bet on ANOTHER template claims
        only its spill-over into the shared pool (whatever its own
        reserved lanes cannot hold) — its reserved draw can never collide
        with ``tmpl``.  Engines without per-template pools see every claim
        as shared."""
        shared_free = self._free_for(None)
        n = 0
        for task in self._staged:
            if task.template == tmpl:
                n += len(task.batch)
            else:
                reserved_free = max(
                    0, self._free_for(task.template) - shared_free)
                n += max(0, len(task.batch) - reserved_free)
        return n

    def _abort_task(self, task: _SpecTask, requeues: list,
                    n_committed: int = 0) -> None:
        """Charge a missed bet and record its re-queue.

        The uncommitted requests are appended to ``requeues`` rather than
        re-queued immediately: the commit boundary settles bets
        oldest-first, and naive immediate ``appendleft`` would stack a
        younger same-template batch ON TOP of the older one it arrived
        behind — the caller flushes ``requeues`` youngest-first so the
        oldest aborted batch ends up at the very head.  A fully-wasted
        bet feeds its lane's ``observe_abort`` with the bet's accumulated
        dispatch time AND its pipeline depth (``age``): a bet that sat
        staged for d boundaries also held promised capacity for d ticks,
        so deep misses raise the lane's learned threshold faster.  A
        partial commit still used the dispatch — no penalty."""
        aborted = task.batch[n_committed:]
        if not aborted:
            return
        requeues.append((task.template, aborted))
        self.stats.spec_aborted += len(aborted)
        if n_committed == 0:
            depth = max(1, task.age)
            if self.policy is not None:
                self.policy.observe_abort(task.template, task.duration,
                                          depth=depth)
            else:
                self._strategy_for(task.template).observe_abort(
                    task.duration, depth=depth)

    def _flush_requeues(self, requeues: list) -> None:
        """Apply a boundary's aborted-bet re-queues YOUNGEST-first, so the
        oldest bet's requests (which arrived first) end at the queue
        head — FIFO arrival order survives a multi-bet abort cascade."""
        for tmpl, batch in reversed(requeues):
            self._requeue_front(tmpl, batch)

    def _commit_speculative(self) -> None:
        """Tick-boundary settlement of the speculation pipeline.

        Bets settle OLDEST-FIRST.  The oldest bet is joined (its dispatch
        had a full decode tick to finish) and committed once its whole
        batch fits; a bet whose capacity has not materialized yet may wait
        up to ``spec_depth`` boundaries (the horizon it was sized
        against), after which the shortfall is a MISS: the fitting prefix
        commits, the rest aborts to the head of its queue.  Younger bets
        may commit at the same boundary — but only after every older bet
        fully committed, and only if their own dispatch already finished
        (they are never waited on).  After a miss, a younger bet survives
        only while its template's reserved lanes still cover it
        (:meth:`_reservation_covers`); an uncovered bet aborts NOW,
        feeding ``observe_abort`` with its pipeline depth, instead of
        wasting further boundaries.  An incomplete chunked bet is advanced
        one chunk (overlapping the coming decode tick) and keeps its
        position; younger bets stay queued behind it."""
        if not self._staged:
            return
        tasks = list(self._staged)
        self._staged.clear()
        keep: list[_SpecTask] = []
        requeues: list = []  # (template, batch) per aborted bet, oldest first
        blocked = False  # an older bet is still in flight / mid-chunk
        missed = False   # an older bet aborted requests at this boundary
        for i, task in enumerate(tasks):
            task.age += 1
            if i == 0:
                task.join()
            if missed and not self._reservation_covers(task):
                self._abort_task(task, requeues)
                continue
            if blocked or (i > 0 and not task.finished):
                keep.append(task)
                blocked = True
                continue
            if task.error is not None:
                if self._fd is not None:
                    # Spec-thread crash: abort THIS bet cleanly (requests
                    # back to their queue head, abort-time charged to the
                    # lane's cost model, breaker fed) and keep settling —
                    # the pipeline must not wedge on one dead thread.
                    self.stats.spec_crashes += 1
                    breaker = self._fd.breaker(task.template)
                    if breaker is not None:
                        breaker.record_failure()
                    self._record_lane_failure(task.template, task.error)
                    self._abort_task(task, requeues)
                    missed = True
                    blocked = True
                    continue
                requeues.append((task.template, task.batch))
                self._flush_requeues(requeues)
                keep.extend(tasks[i + 1:])
                self._staged.extend(keep)
                raise task.error
            if not task.complete:  # chunked: fold the next chunk this tick
                # Fused megabatch first: a paged engine can adopt the next
                # chunk INTO this tick's decode dispatch (one device
                # program per boundary instead of decode + spec-thread
                # resume); engines without stage_chunk — or ticks it
                # declines (no active decode batch) — keep the
                # spec-thread resume path.
                stage = getattr(self.engine, "stage_chunk", None)
                if stage is None or not stage(task.staged):
                    task.advance(self.engine)
                self.stats.spec_chunks += 1
                keep.append(task)
                blocked = True
                continue
            tmpl = task.template
            fit = min(len(task.batch), self._free_for(tmpl))
            if fit < len(task.batch) and task.age < self.spec_depth:
                # The bet was sized against capacity materializing up to
                # spec_depth ticks out; within that horizon a shortfall is
                # "not yet", not a miss — wait for a later boundary rather
                # than splitting the batch or aborting.  (depth 1: age is
                # already 1 at the first boundary, so bets settle
                # immediately — the single-bet pipeline's semantics.)
                keep.append(task)
                blocked = True
                continue
            strat = self._strategy_for(tmpl)
            committed = task.batch[:fit]
            if committed:
                t0 = time.perf_counter()
                shape = self.engine.commit_prefill(task.staged, n=fit)
                commit_dt = time.perf_counter() - t0
                self._land_batch(tmpl, strat, committed, shape,
                                 task.duration + commit_dt)
                self.stats.spec_committed += fit
                if self._fd is not None:
                    breaker = self._fd.breaker(tmpl)
                    if breaker is not None:
                        breaker.record_success()
                    self._record_lane_success(tmpl)
            if fit < len(task.batch):
                self._abort_task(task, requeues, n_committed=fit)
                # Younger bets stop committing at this boundary: the
                # aborted requests are going back to their queue head, and
                # a younger same-template commit would overtake them.
                missed = True
                blocked = True
        self._flush_requeues(requeues)
        self._staged.extend(keep)

    def _dispatch_speculative(self, select) -> None:
        """Fill the speculation pipeline: pick speculable ready lanes
        (peek — a lane we decline keeps its queue position) and dispatch
        their prefills on spec threads until ``spec_depth`` bets are in
        flight, each sized against free lanes plus the lanes this tick's
        decode is about to retire MINUS the capacity already promised to
        older staged bets — the bets ``_commit_speculative`` settles
        oldest-first at later boundaries.

        The scan consults each ready lane at most once per tick, in the
        pick order admission would use (weighted-fair under a policy,
        FIFO otherwise), by filtering already-declined lanes out of the
        peek's candidate set — so one permanently-starved head lane
        cannot blind the speculator to dispatchable lanes behind it, in
        EITHER pick discipline, and declined lanes are never reordered.
        A lane whose head prompt exceeds ``chunk_tokens`` dispatches the
        whole run of consecutive oversized head prompts as one batched
        chunked bet (one resumable part per prompt); a lane whose next
        requests have spilled KV staged is declined (the admission-time
        restore is strictly cheaper than a re-prefill)."""
        ben = getattr(self._kv, "benefits",
                      getattr(self.engine, "lane_benefits", None))
        has_spill = getattr(self.engine, "has_spill", None)
        consulted: set = set()

        def next_candidate(keys: list):
            cand = [k for k in keys if k not in consulted]
            if not cand:
                return None  # peek passes this through: scan exhausted
            return cand[0] if select is None else select(cand)

        while len(self._staged) < self.spec_depth:
            tmpl = self._ready.peek(select=next_candidate)
            if tmpl is None or tmpl in consulted:
                # None: nothing ready / every ready lane declined.  A
                # consulted key can still surface via peek's single-entry
                # short-circuit (select is bypassed at len 1): same exit.
                return
            consulted.add(tmpl)
            q = self.queues.get(tmpl)
            if not q:
                # Stale entry (lane drained since the push): discard it —
                # the targeted pop removes exactly this key.
                self._ready.pop(select=lambda keys, t=tmpl: t, block=False)
                continue
            if self._fd is not None:
                breaker = self._fd.breaker(tmpl)
                if breaker is not None and breaker.allow() == "shed":
                    # Tripped breaker: no speculative bets on this
                    # template — it degrades to the synchronous admission
                    # path (whose successes/probes close the breaker).
                    continue
            # The speculative capacity: lanes free now, plus lanes whose
            # request reaches max_new_tokens within the pipeline's horizon
            # (``spec_depth`` decode ticks — a bet staged behind j older
            # bets commits ~j boundaries later, so a deeper pipeline may
            # bet on retirements further out) — counting only retirements
            # whose lane goes home to a pool this template can draw from
            # (engine.lane_benefits): a lane bound for another template's
            # reservation is a guaranteed miss, not a bet.  Lanes already
            # promised to older staged bets are subtracted
            # (``_promised_against``): an older bet claims its capacity
            # first, so a younger bet may only count what is left.  The
            # remaining optimism (a straggler that refuses to finish, an
            # engine that stops emitting, an engine without the
            # lane_benefits hint, a retirement double-counted across
            # bets) is what makes this a speculation, and the abort path
            # is what settles it.  Capacity is checked BEFORE the
            # strategy is consulted: decide() may be stateful
            # (AdaptiveCost's explore alternation), and a lane with no
            # speculative capacity must not consume a decision it cannot
            # act on.
            cap = (self._free_for(tmpl) + sum(
                1 for r in self.running.values()
                if (r.remaining <= self.spec_depth
                    and (ben is None or ben(r.lane, tmpl))))
                - self._promised_against(tmpl))
            if cap > 0:
                chunked = (self.chunk_tokens is not None
                           and len(q[0].prompt) > self.chunk_tokens)
                strat = self._strategy_for(tmpl)
                if chunked:
                    # Consecutive oversized head prompts admit as ONE
                    # batched chunk dispatch (each becomes its own
                    # resumable part; see StagedPrefill.parts) — an
                    # oversized burst no longer serializes one prompt
                    # per bet.  The run stops at the first prompt that
                    # fits a chunk so small prompts keep their ordinary
                    # padded-batch path.
                    n_over = 0
                    for r in q:
                        if len(r.prompt) > self.chunk_tokens:
                            n_over += 1
                        else:
                            break
                    take = min(strat.decide(len(q), self._producer_done),
                               n_over, cap)
                else:
                    take = min(strat.decide(len(q), self._producer_done),
                               len(q), cap)
                if take > 0 and has_spill is not None and any(
                        has_spill(q[i].rid) for i in range(take)):
                    take = 0  # restore at admission beats re-prefilling
                if take > 0:
                    self._dispatch_one(tmpl, q, take,
                                       chunked=chunked)
                    continue
            # Declined (strategy says wait / no capacity even
            # speculatively / spilled KV pending restore): leave the lane
            # exactly where it is and look at the next candidate.

    def _dispatch_one(self, tmpl: str, q: "deque[Request]", take: int,
                      chunked: bool) -> None:
        """Pop ``take`` requests off ``tmpl``'s lane and stage their
        prefill as one new speculation-pipeline bet."""
        self._ready.pop(select=lambda keys, t=tmpl: t, block=False)
        batch = [q.popleft() for _ in range(take)]
        if not q:
            del self.queues[tmpl]
        else:
            self._ready.push(tmpl)
        now = time.perf_counter()
        for r in batch:
            r.metrics.admitted = now
            r.metrics.speculative = True
        self._staged.append(_SpecTask(
            self.engine, tmpl, batch,
            chunk=self.chunk_tokens if chunked else None))
        self.stats.spec_dispatched += take

    # ----------------------------------------------------------------- tick
    def tick(self) -> list[Request]:
        """One scheduling round: commit the staged speculative prefill,
        admit per strategy (per lane), dispatch the next speculation, run
        one decode step."""
        with tracing.span("scheduler.tick") as sp:
            if tracing.enabled():
                st = self.stats
                sp.set(tick=st.decode_ticks + 1, admitted=len(st.admission_trace),
                       committed=st.spec_committed, aborted=st.spec_aborted)
            # 0) failure domain first: quarantined lanes whose cooldown has
            # elapsed rejoin their pools before admission counts free lanes,
            # and a template whose submissions keep failing surfaces as a
            # typed LaneFailedError rather than spinning forever.
            self._release_quarantine()
            self._check_lane_health()
            # 0.5) tick boundary: the previous tick's speculative prefill lands
            # (or aborts) before admission sees the free-lane picture.
            if self.overlap:
                with tracing.span("scheduler.settle"):
                    self._commit_speculative()

            # 1) admission — the paper's "how many requests does a free worker
            # take from the queue" decision.  Ready lanes are popped (weighted-
            # fair under a LanePolicy, round-robin otherwise) only while engine
            # slots remain free; each lane is consulted at most once per tick
            # and re-queued if it keeps a backlog, so a tick never scans lanes
            # with nothing to admit.
            # Weighted-fair selection costs a policy lock + O(n) scan per pop;
            # with uniform weights FIFO pop + tail re-push is equally fair
            # round-robin (same guard as the runtime worker's pop).
            select = (self.policy.lane_min
                      if self.policy is not None and self.policy.lane_weights
                      else None)
            with tracing.span("scheduler.admit"):
                has_spill = getattr(self.engine, "has_spill", None)
                consulted: set = set()
                repush: list = []
                while self._kv.n_free > 0:
                    tmpl = self._ready.pop(select=select, block=False)
                    if tmpl is None:
                        break
                    if tmpl in consulted:
                        repush.append(tmpl)
                        break
                    consulted.add(tmpl)
                    q = self.queues.get(tmpl)
                    if not q:
                        continue  # stale push: lane drained since
                    if (self.chunk_tokens is not None
                            and len(q[0].prompt) > self.chunk_tokens
                            and not (has_spill is not None
                                     and has_spill(q[0].rid))):
                        # Oversized head prompt: admitting it inline is exactly the
                        # stall chunking exists to avoid — leave the lane for the
                        # chunked speculative dispatch (step 1.5) instead.  An
                        # oversized request WITH staged spilled KV falls through:
                        # its restore path pays no prefill at all, and skipping it
                        # here while the spec path also declines spilled requests
                        # would starve it forever.
                        repush.append(tmpl)
                        continue
                    strat = self._strategy_for(tmpl)
                    want = strat.decide(len(q), self._producer_done)
                    # kv_shares: the batch is bounded by THIS template's admissible
                    # lanes (reserved + shared), not the global free count.
                    take = min(want, self._free_for(tmpl), len(q))
                    if take <= 0:
                        repush.append(tmpl)  # strategy says wait: stay scheduled
                        continue
                    batch = [q.popleft() for _ in range(take)]
                    if not q:
                        # GC drained lanes (mirrors the runtime): high-cardinality
                        # template churn must not grow the bookkeeping.
                        del self.queues[tmpl]
                    else:
                        repush.append(tmpl)
                    # Host-KV restore first: a re-admitted request whose spilled
                    # KV survived in the pool resumes decoding directly (no
                    # prefill, no token restart); only the rest go through the
                    # prefill batch.  A request whose entry was evicted (pool
                    # LRU/budget) restarts from scratch — its stale partial
                    # generation is cleared before the re-prefill.
                    restore = getattr(self.engine, "try_restore", None)
                    fresh: list = []
                    n_restored = 0
                    for r in batch:
                        lane = restore(r.rid, tmpl) if restore is not None else None
                        if lane is not None:
                            r.lane = lane
                            self.running[lane] = r
                            self._lane_age[lane] = 0
                            n_restored += 1
                            self.stats.kv_restored += 1
                        else:
                            if r.generated:
                                r.generated.clear()  # spill entry lost: restart
                            if (self.chunk_tokens is not None
                                    and len(r.prompt) > self.chunk_tokens):
                                # Oversized restart whose entry was evicted: back
                                # to the head — the chunk pipeline re-prefills it
                                # (its spill entry is gone, so the admission gate
                                # now routes it to the spec path, no starvation).
                                self._requeue_front(tmpl, [r])
                                continue
                            fresh.append(r)
                    if n_restored and self.policy is not None:
                        self.policy.charge(tmpl, n_restored)  # restored = service
                    if not fresh:
                        continue
                    now = time.perf_counter()
                    for r in fresh:
                        r.metrics.admitted = now
                    t0 = time.perf_counter()
                    try:
                        shape = self._admit_with_retry(fresh, tmpl)
                    except BaseException:
                        if self._fd is None:
                            raise
                        # Persistent admission failure: the batch goes back to the
                        # head of its lane (it was next in line) and the failure
                        # record / breaker absorb the feedback — _check_lane_health
                        # names the template if this never recovers.
                        self._requeue_front(tmpl, fresh)
                        self.stats.requeued += len(fresh)
                        continue
                    # Feedback goes to the deciding model (the lane's own under a
                    # policy); warm-shape guarding and the landing bookkeeping are
                    # shared with the speculative commit path.
                    self._land_batch(tmpl, strat, fresh, shape,
                                     time.perf_counter() - t0)
                for tmpl in repush:
                    self._ready.push(tmpl)
                hits = getattr(self.engine, "prefix_hits", None)
                if hits is not None:
                    self.stats.prefix_hits = hits

            # 1.5) speculation: while decode runs below, the next ready lanes'
            # prefills are already in flight on spec threads (up to
            # spec_depth staged bets).
            if self.overlap and len(self._staged) < self.spec_depth:
                with tracing.span("scheduler.speculate"):
                    self._dispatch_speculative(select)

            # 2) one batched decode step over all active lanes
            finished: list[Request] = []
            t0 = time.perf_counter()
            with tracing.span("scheduler.decode", start=t0):
                tokens = self._decode_with_recovery()
                decode_dt = time.perf_counter() - t0
                tracing.end_at("scheduler.decode", t0 + decode_dt)
            with tracing.span("scheduler.finish"):
                self.stats.decode_ticks += 1
                if self.policy is not None and tokens:
                    # Per-lane decode feedback: every template with a request in this
                    # tick's batch gets the tick duration — the per-token side of its
                    # cost model, next to the prefill F + n·c fit.
                    for tmpl in {r.template for r in self.running.values()}:
                        self.policy.observe_decode(tmpl, decode_dt)
                for lane, tok in tokens.items():
                    r = self.running.get(lane)
                    if r is None:
                        continue
                    r.generated.append(tok)
                    self._lane_age[lane] += 1
                    if r.done:
                        r.metrics.finished = time.perf_counter()
                        self.engine.retire(lane)
                        del self.running[lane]
                        finished.append(r)
                        self.stats.completed += 1
                    elif self.lane_timeout and self._lane_age[lane] > self.lane_timeout:
                        # Straggler: retire the lane, re-queue the request.  With
                        # an engine spill pool the lane's KV is staged to host
                        # memory and the partial generation is KEPT — re-admission
                        # restores and resumes; without one (or if the entry is
                        # later evicted) the re-admission re-prefills from scratch.
                        spill = getattr(self.engine, "spill", None)
                        if spill is not None:
                            spilled = spill(lane, key=r.rid, template=r.template)
                        else:
                            self.engine.retire(lane)
                            spilled = False
                        del self.running[lane]
                        if spilled:
                            self.stats.kv_spilled += 1
                        else:
                            r.generated.clear()
                        r.lane = None
                        rq = self.queues.get(r.template)
                        if rq is None:  # lane may have been GC'd since admission
                            rq = self.queues[r.template] = deque()
                        rq.appendleft(r)
                        self._ready.push(r.template)
                        self.stats.requeued += 1
            if tracing.enabled() and "tick" in sp.data:
                st, d = self.stats, sp.data
                committed = st.spec_committed - d["committed"]
                landed = sum(n for _t, n in st.admission_trace[d["admitted"]:])
                sp.set(admitted=landed - committed, committed=committed,
                       aborted=st.spec_aborted - d["aborted"])
            return finished
