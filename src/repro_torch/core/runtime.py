"""AsyncQueryRuntime — the paper's runtime asynchronous-submission framework
(§4.2, Fig. 3) with asynchronous batching (§5.2), generalized to a
**sharded, multi-lane** runtime for heterogeneous multi-tenant traffic.

The paper's runtime (and this module's first incarnation) keeps ONE FIFO
queue and batches "requests that share a query template, split at the first
boundary".  That is exact for the paper's setting — a single transformed
loop submits one template with varying params — but it head-of-line blocks
the moment two templates interleave: a strict A,B,A,B arrival order makes
every batch degenerate to size 1.  At production scale concurrent users
issue many templates at once, and SharedDB-style shared execution says the
win comes from batching *across* concurrent queries.  So:

  * **Lanes.**  Pending requests are sharded into one lane per query
    template (``query_name``).  Each lane batches independently, so mixed
    traffic batches per-template instead of serializing.  ``sharded=False``
    restores the paper's single-queue behaviour (one lane, batches split at
    template boundaries) for A/B comparison — see
    ``benchmarks/bench_lanes.py``.
  * **In-flight deduplication.**  Identical ``(query_name, params)``
    submissions coalesce onto one pending/in-flight service call whose
    result fans out to every attached handle (SharedDB-style sharing);
    ``stats.deduped`` counts coalesced submissions.  Pure queries only —
    disable with ``dedup=False`` for effectful services.
  * **Result cache.**  Opt-in LRU (``result_cache_size``) serving repeat
    submissions of already-completed requests without a service call
    (``stats.cache_hits``), with TTL expiry (``result_cache_ttl``) and an
    explicit :meth:`invalidate` hook for write-through services.
  * **Adaptive feedback.**  Every service call's ``(batch_size, duration)``
    is reported to ``strategy.observe`` so cost-learning strategies
    (:class:`~repro.core.strategies.AdaptiveCost`) can fit the service's
    fixed-vs-per-item cost model online.
  * **Per-lane policy** (``policy=``): a
    :class:`~repro.core.lane_policy.LanePolicy` replaces the one global
    strategy with per-lane instances, the one global ``max_pending`` with
    per-tenant / per-lane quotas (``submit(..., tenant=...)``), picks lanes
    by weighted fair queueing, and canonicalizes projection-only template
    variants onto one shared lane (explicitly via ``policy.share`` or
    auto-detected from ``policy.describe`` metadata).

**Lock-sharded hot path.**  Asynchronous submission only wins when
submission itself is cheap (the paper's whole premise), so since the
lock-sharding refactor NO global lock exists on the submit/fetch/worker
path.  Synchronization is sharded to match the sharded data:

  * each **lane** has its own lock guarding only its pending deque;
  * the **dedup registries** (queued/in-flight request identity) are
    striped across ``n_stripes`` locks keyed by request hash;
  * **handle state** (results, errors, pending metadata) is striped the
    same way, each stripe with its own condition variable — a delivery
    wakes only fetchers hashed to that stripe, not every blocked thread;
  * workers block on a :class:`~repro.core.concurrency.ReadyLanes` queue
    of lanes that have pending work (weighted-fair pop under a policy)
    instead of polling a global CV and scanning idle lanes;
  * **quota waits** sleep on per-tenant / per-lane
    :class:`~repro.core.concurrency.QuotaGate` condition variables and are
    woken by the release that frees a slot — no fixed-interval polling
    anywhere in the quota path;
  * batch deliveries are fanned out per stripe after the service call,
    outside any lane lock;
  * stats counters are :class:`~repro.core.concurrency.ShardedCounter`
    stripes, so producers do not convoy on bookkeeping.

Lock-ordering rules live in ROADMAP.md ("Locking model"); the frozen
global-lock PR 2 implementation survives as
:class:`~repro.core.runtime_baseline.GlobalLockRuntime` for the Part 5
contention benchmark's A/B.

The paper-facing API is unchanged:

  * ``submit(query_name, params) -> handle``  (non-blocking ``submitQuery``)
  * ``fetch(handle)`` blocks on the result cache keyed by loop context
  * a thread pool of ``n_threads`` workers ("connections") drains lanes,
    executing a take of 1 individually and k>1 as one set-oriented
    ``service.execute_batch`` (the runtime query rewrite), splitting the
    result set back per request.

Production extras carried over:

  * **straggler mitigation**: ``fetch`` past ``straggler_timeout``
    re-submits the request so another lane/connection retries; first
    result wins, duplicates are dropped idempotently.  The deadline is
    recomputed against the handle's own (canonical) lane after each
    resubmit, measured from when the duplicate is actually enqueued.
  * **bounded queue** (§8 memory overheads): ``submit`` blocks when more
    than ``max_pending`` requests are outstanding (producer back-off).
  * **batch-size traces**, also per lane (``stats.lane_traces``) for
    Fig. 10-style analysis of each template's ramp.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Optional

from repro_torch.core.concurrency import QuotaGate, ReadyLanes, ShardedCounter
from repro_torch.core.lane_policy import LanePolicy
from repro_torch.core.resilience import (DeadlineExceeded, FailureDomain,
                                   Resilience, ServiceCardinalityError)
from repro_torch.core.services import QueryService
from repro_torch.core.strategies import BatchingStrategy, PureAsync

__all__ = ["Handle", "AsyncQueryRuntime", "RuntimeStats"]

_SINGLE_LANE = "__single__"  # lane key in sharded=False compatibility mode


@dataclasses.dataclass(frozen=True)
class Handle:
    """Loop-context key for one submitted request (paper: ``ctx``)."""

    key: int
    query_name: str

    def __repr__(self) -> str:
        return f"<handle #{self.key} {self.query_name}>"


class RuntimeStats:
    """Runtime counters, striped across locks so the hot path never convoys
    on bookkeeping.  Fields compare/convert like numbers
    (:class:`~repro.core.concurrency.ShardedCounter`); ``snapshot`` returns
    plain JSON-safe values.  Trace lists rely on the GIL's atomic
    ``list.append``; per-lane trace lists are only appended under that
    lane's own lock."""

    _COUNTERS = (
        "submitted",
        "completed",
        "single_executions",
        "batch_executions",
        "resubmissions",
        "deduped",      # submissions coalesced onto a pending/in-flight call
        "cache_hits",   # submissions served from the completed-result LRU
        "cache_expired",  # LRU entries dropped because their TTL lapsed
        "shared",       # submissions rerouted onto a canonical lane (projection)
        "quota_waits",  # submissions that blocked on a quota / back-pressure bound
        # failure domain (resilience=Resilience(...)):
        "failures",     # service calls that raised (before any retry verdict)
        "retries",      # re-executions after a retryable failure
        "fissions",     # failed batches split to isolate failing params
        "breaker_trips",      # circuit breakers tripped closed -> open
        "shed_submissions",   # requests executed on the breaker's shed path
        "deadline_expired",   # handles resolved with DeadlineExceeded at fetch
    )

    def __init__(self):
        for name in self._COUNTERS:
            setattr(self, name, ShardedCounter())
        self.batch_trace: list = []  # (seq, size)
        # per-lane (seq, size) traces; lane key == query template (or __single__)
        self.lane_traces: dict = {}

    def snapshot(self) -> dict:
        """Plain JSON-safe copy of every counter and trace."""
        d = {name: int(getattr(self, name)) for name in self._COUNTERS}
        # dict()/list() copies are single C-level ops (no GIL release), so
        # snapshotting while workers insert new lanes cannot hit
        # "dictionary changed size during iteration".
        d["batch_trace"] = list(self.batch_trace)
        d["lane_traces"] = {k: list(v) for k, v in dict(self.lane_traces).items()}
        d["batch_sizes"] = [s for _, s in d["batch_trace"] if s > 1]
        d["mean_batch_size"] = self.mean_batch_size
        return d

    @property
    def mean_batch_size(self) -> float:
        """Mean take size over every execution (singles included)."""
        trace = self.batch_trace
        if not trace:
            return 0.0
        return sum(s for _, s in trace) / len(trace)


class _Entry:
    """One service call's worth of work: a params tuple plus every handle
    key whose submission coalesced onto it (dedup fan-out).  ``keys`` is
    mutated/snapshotted only under the request's req-stripe lock (or never
    shared, for unhashable params)."""

    __slots__ = ("keys", "query_name", "params")

    def __init__(self, key: int, query_name: str, params: tuple):
        self.keys = [key]
        self.query_name = query_name
        self.params = params


class _Lane:
    """One query template's pending deque behind its own lock."""

    __slots__ = ("key", "lock", "entries", "dead", "parked")

    def __init__(self, key: str):
        self.key = key
        self.lock = threading.Lock()
        self.entries: deque[_Entry] = deque()
        self.dead = False  # set (under lock) when GC'd out of the registry
        # parked: a worker consulted the strategy and was told to wait
        # (decide() <= 0 with work queued) — the next submit must re-queue
        # the lane so the strategy is re-asked with the larger backlog.
        self.parked = False


class _HandleStripe:
    """One stripe of handle-keyed state: results/errors plus pending
    metadata, with a condition variable that only this stripe's fetchers
    sleep on."""

    __slots__ = ("lock", "cv", "results", "errors", "pending")

    def __init__(self):
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.results: dict[int, Any] = {}
        self.errors: dict[int, BaseException] = {}
        self.pending: dict[int, _Pending] = {}


class _Pending:
    """Per-handle metadata while unresolved: where it runs, how to project
    its result, which quota slots to release on delivery, and the absolute
    monotonic deadline (``None`` = no deadline) after which ``fetch``
    resolves the handle with :class:`DeadlineExceeded`."""

    __slots__ = ("lane_query", "params", "projector", "slots", "deadline")

    def __init__(self, lane_query, params, projector, slots, deadline=None):
        self.lane_query = lane_query
        self.params = params
        self.projector = projector
        self.slots = slots
        self.deadline = deadline


class _ReqStripe:
    """One stripe of request-identity state (dedup registries)."""

    __slots__ = ("lock", "queued", "inflight")

    def __init__(self):
        self.lock = threading.Lock()
        self.queued: dict[tuple, _Entry] = {}
        self.inflight: dict[tuple, _Entry] = {}


class _ResultCache:
    """Sharded LRU + TTL result cache.  ``n_stripes=1`` (the default)
    preserves exact global LRU order; more stripes trade LRU exactness for
    lock spread (each stripe keeps its own LRU over ~size/n entries)."""

    def __init__(self, size: int, ttl: Optional[float], n_stripes: int = 1):
        n_stripes = max(1, min(n_stripes, size))
        self._locks = [threading.Lock() for _ in range(n_stripes)]
        self._maps: list[OrderedDict] = [OrderedDict() for _ in range(n_stripes)]
        self._cap = -(-size // n_stripes)  # ceil: total capacity >= size
        self._ttl = ttl

    def _idx(self, req: tuple) -> int:
        return hash(req) % len(self._maps)

    def get(self, req: tuple) -> tuple:
        """``(value, fresh, n_expired)`` — expires TTL'd entries on read."""
        i = self._idx(req)
        with self._locks[i]:
            m = self._maps[i]
            hit = m.get(req)
            if hit is None:
                return None, False, 0
            value, deadline = hit
            if deadline is not None and time.monotonic() >= deadline:
                del m[req]
                return None, False, 1
            m.move_to_end(req)
            return value, True, 0

    def put(self, req: tuple, value: Any) -> None:
        """Insert/refresh one entry (evicting LRU past stripe capacity)."""
        deadline = (time.monotonic() + self._ttl
                    if self._ttl is not None else None)
        i = self._idx(req)
        with self._locks[i]:
            m = self._maps[i]
            m[req] = (value, deadline)
            m.move_to_end(req)
            while len(m) > self._cap:
                m.popitem(last=False)

    def invalidate(self, query_name: Optional[str],
                   params: Optional[tuple], req_key_fn) -> int:
        """Drop everything / one template's entries / one entry; returns
        the number of entries removed."""
        if query_name is None:
            n = 0
            for lock, m in zip(self._locks, self._maps):
                with lock:
                    n += len(m)
                    m.clear()
            return n
        if params is not None:
            rk = req_key_fn(query_name, params)
            if rk is None:
                return 0
            i = self._idx(rk)
            with self._locks[i]:
                if rk in self._maps[i]:
                    del self._maps[i][rk]
                    return 1
            return 0
        n = 0
        for lock, m in zip(self._locks, self._maps):
            with lock:
                victims = [k for k in m if k[0] == query_name]
                for k in victims:
                    del m[k]
                n += len(victims)
        return n


class AsyncQueryRuntime:
    """The runtime library of §4.2 + §5.2, sharded into per-template lanes
    with lock-sharded synchronization (see module docstring).

    May be used directly (``submit``/``fetch``) or as the service behind the
    HIR :class:`~repro.core.hir.Interpreter` for transformed programs.
    """

    def __init__(
        self,
        service: QueryService,
        n_threads: int = 10,
        strategy: Optional[BatchingStrategy] = None,
        max_pending: Optional[int] = None,
        straggler_timeout: Optional[float] = None,
        sharded: bool = True,
        dedup: bool = True,
        result_cache_size: int = 0,
        result_cache_ttl: Optional[float] = None,
        policy: Optional[LanePolicy] = None,
        n_stripes: int = 16,
        result_cache_stripes: int = 1,
        resilience: Optional[Resilience] = None,
    ):
        if policy is not None and strategy is not None:
            raise ValueError(
                "pass either a global `strategy` or a per-lane `policy`, not both"
            )
        if n_stripes < 1:
            raise ValueError("n_stripes must be >= 1")
        self.service = service
        self.policy = policy
        self.strategy = strategy or PureAsync()
        self.strategy.reset()
        self.n_threads = n_threads
        self.max_pending = max_pending
        self.straggler_timeout = straggler_timeout
        self.sharded = sharded
        self.dedup = dedup

        # lane registry: lane key -> _Lane; lookups are lock-free dict reads,
        # creation/GC go through _lanes_lock (GC also takes the lane's lock).
        self._lanes: dict[str, _Lane] = {}
        self._lanes_lock = threading.Lock()
        self._ready = ReadyLanes()

        # striped handle/request state (power-of-two mask for cheap hashing)
        n_stripes = 1 << (n_stripes - 1).bit_length()
        self._stripe_mask = n_stripes - 1
        self._stripes = [_HandleStripe() for _ in range(n_stripes)]
        self._req_stripes = [_ReqStripe() for _ in range(n_stripes)]

        self._cache = (
            _ResultCache(result_cache_size, result_cache_ttl,
                         result_cache_stripes)
            if result_cache_size else None
        )

        # admission gates: created on demand per tenant / lane, plus one
        # global gate when max_pending bounds total outstanding requests.
        self._gates_lock = threading.Lock()
        self._tenant_gates: dict[str, QuotaGate] = {}
        self._lane_gates: dict[str, QuotaGate] = {}
        self._global_gate = QuotaGate() if max_pending is not None else None

        self._key_seq = itertools.count()   # handle keys (atomic under GIL)
        self._exec_seq = itertools.count()  # execution sequence for traces
        self._producer_done = False
        self._shutdown = False
        self._drain_cv = threading.Condition()
        self._drain_waiters = 0
        self.stats = RuntimeStats()

        # Failure domain (None = legacy semantics: no retries, a failed
        # batch delivers its one exception to every waiter).  With a
        # Resilience config the worker path retries with backoff under a
        # per-lane budget, fissions failed batches to isolate failing
        # params, sheds breaker-open lanes to direct synchronous
        # execution, and fetch enforces per-request deadlines.
        self.resilience = resilience
        self._fd = (
            FailureDomain(resilience,
                          on_trip=lambda: self.stats.breaker_trips.add())
            if resilience is not None else None
        )

        self._threads = [
            threading.Thread(target=self._worker, name=f"aqr-worker-{i}", daemon=True)
            for i in range(n_threads)
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------ API
    def submit(self, query_name: str, params: tuple,
               tenant: Optional[str] = None,
               deadline: Optional[float] = None) -> Handle:
        """Non-blocking query submission (``submitQuery``).  Blocks only at an
        admission bound: the global ``max_pending`` (§8 producer back-off), or
        — with a :class:`LanePolicy` — this tenant's / this lane's quota.
        Blocked submissions sleep on that bound's own condition variable and
        are woken by the release that frees a slot (never by a timer).

        With a policy, templates registered via ``policy.share`` (or
        auto-detected from ``policy.describe`` metadata) are canonicalized
        onto their shared lane here; the submission's own projection is
        applied at result fan-out.

        ``deadline`` (seconds, relative; default the resilience config's
        ``deadline``) bounds how long this handle's ``fetch`` waits: past
        it the handle resolves with a typed
        :class:`~repro.core.resilience.DeadlineExceeded` at its fetch
        point — the exception-semantics-preserving way to time out.
        """
        policy = self.policy
        if policy is None:
            lane_query, projector = query_name, None
        elif self.sharded:
            # One policy-lock acquisition per submit: resolve the shared
            # routing AND note the submission on the canonical lane in a
            # single critical section (the lane key IS the canonical query
            # when sharded).  The note lands before the quota wait below —
            # a blocked submission still warms its lane's temperature.
            lane_query, projector = policy.resolve_submit(query_name)
        else:
            # Single-queue compatibility mode: the lane key is not the
            # query name, so the fold doesn't apply — note the one lane.
            lane_query, projector = policy.resolve(query_name)
            policy.note_submit(_SINGLE_LANE)
        lk = self._lane_key(lane_query)

        slots = self._acquire_slots(lk, tenant)  # may block; raises on shutdown

        key = next(self._key_seq)
        handle = Handle(key, query_name)
        self.stats.submitted.add()
        self._producer_done = False
        if projector is not None:
            self.stats.shared.add()

        req = self._req_key(lane_query, params)
        stripe = self._handle_stripe(key)

        # 1) completed-result cache (SharedDB-style reuse across time)
        if req is not None and self._cache is not None:
            value, fresh, expired = self._cache.get(req)
            if expired:
                self.stats.cache_expired.add(expired)
            if fresh:
                self._deliver_cached(stripe, key, value, projector, slots)
                return handle

        # Register pending metadata BEFORE the key can become discoverable
        # through an entry, so a racing delivery always finds the projector
        # and the quota slots to release.
        eff = deadline
        if eff is None and self.resilience is not None:
            eff = self.resilience.deadline
        meta = _Pending(lane_query, params, projector, slots,
                        time.monotonic() + eff if eff is not None else None)
        with stripe.lock:
            stripe.pending[key] = meta

        # 2) in-flight/pending dedup (sharing across concurrent users)
        if req is not None and self.dedup:
            rs = self._req_stripe(req)
            value = None
            with rs.lock:
                live = rs.queued.get(req) or rs.inflight.get(req)
                if live is not None:
                    live.keys.append(key)
                    self.stats.deduped.add()
                    return handle
                # Re-probe the cache under the registry lock: _complete
                # caches BEFORE it unregisters, so an identical request
                # that just completed (after the optimistic probe above
                # missed) is guaranteed visible here — no gap in which a
                # twin re-executes.  Cache locks are leaves; ordering
                # req-stripe → cache is one-way.
                if self._cache is not None:
                    value, fresh, expired = self._cache.get(req)
                else:
                    fresh, expired = False, 0
                if not fresh:
                    entry = _Entry(key, lane_query, params)
                    # registered before the lane append: a worker cannot
                    # pick (and complete) the entry until it is in the
                    # lane, so the registry can never outlive a completed
                    # entry.
                    rs.queued[req] = entry
            if expired:
                self.stats.cache_expired.add(expired)
            if fresh:
                self._deliver_cached(stripe, key, value, projector, slots)
                return handle
        else:
            entry = _Entry(key, lane_query, params)

        # 3) enqueue on this template's lane
        self._append_entry(lk, entry)
        return handle

    def producer_done(self) -> None:
        """Signal that no more requests are coming (enables PureBatch and
        lets adaptive strategies drain the tail)."""
        self._producer_done = True
        # Wake parked lanes: a strategy that answered "wait" is re-asked now.
        self._ready.push_all(
            lk for lk, lane in list(self._lanes.items()) if lane.entries
        )

    def fetch(self, handle: Optional[Handle]) -> Any:
        """Blocking result fetch (``fetchResult`` / ``getResultSet(ctx)``).
        ``None`` handles (guarded-away submissions, Rule B) return ``None``.
        Waits only on the handle's own stripe CV — a delivery wakes this
        stripe's fetchers, not every blocked thread in the process.
        """
        if handle is None:
            return None
        key = handle.key
        stripe = self._handle_stripe(key)
        deadline = (
            time.monotonic() + self.straggler_timeout
            if self.straggler_timeout is not None
            else None
        )
        t_start = time.monotonic()
        with stripe.lock:
            meta = stripe.pending.get(key)
            req_deadline = meta.deadline if meta is not None else None
        while True:
            with stripe.lock:
                if key in stripe.errors:
                    raise stripe.errors[key]
                if key in stripe.results:
                    return stripe.results[key]
                if self._shutdown:
                    raise RuntimeError("runtime is shut down")
                now = time.monotonic()
                if req_deadline is not None and now >= req_deadline:
                    # Resolve the handle with a typed error AT ITS FETCH
                    # POINT (the paper's exception-semantics discipline
                    # applied to timeouts).  First resolver wins: pop the
                    # pending meta so a late worker delivery becomes an
                    # idempotent no-op and slots are released exactly once.
                    meta = stripe.pending.pop(key, None)
                    if meta is None:
                        continue  # delivery raced us; loop re-checks
                    err = DeadlineExceeded(handle.query_name, req_deadline,
                                           now - t_start)
                    stripe.errors[key] = err
                    stripe.cv.notify_all()
                else:
                    timeout = None
                    if deadline is not None:
                        timeout = deadline - now
                    if req_deadline is not None:
                        rem = req_deadline - now
                        timeout = rem if timeout is None else min(timeout, rem)
                    if timeout is None:
                        stripe.cv.wait()
                        continue
                    if timeout > 0:
                        stripe.cv.wait(timeout=timeout)
                        continue
                    if req_deadline is not None and deadline is not None \
                            and req_deadline <= deadline:
                        continue  # deadline branch handles it next pass
                    err = None
            if err is not None:
                # Deadline fired: release admission slots and account the
                # handle as completed (errored) outside the stripe lock.
                if meta.slots is not None:
                    self._release_slots(meta.slots)
                self.stats.deadline_expired.add()
                self.stats.completed.add()
                self._notify_drain()
                raise err
            # Straggler: re-enqueue OUTSIDE the stripe lock so the duplicate
            # goes through the normal lane path, then restart the clock
            # against the handle's own (canonical) lane from the moment the
            # duplicate is actually queued — not from when the timeout fired.
            self._resubmit(handle)
            deadline = time.monotonic() + self.straggler_timeout

    def execute(self, query_name: str, params: tuple) -> Any:
        """Synchronous single-query escape hatch (the HIR interpreter's
        untransformed path): delegates straight to the service, bypassing
        lanes, dedup and the cache."""
        return self.service.execute(query_name, params)

    def drain(self) -> None:
        """Block until every submitted request has a result."""
        self.producer_done()
        with self._drain_cv:
            self._drain_waiters += 1
            try:
                while int(self.stats.completed) < int(self.stats.submitted):
                    # Completions signal this CV whenever a drainer is
                    # registered; the timeout is a crash-safety net, not the
                    # wakeup mechanism.
                    self._drain_cv.wait(timeout=0.5)
            finally:
                self._drain_waiters -= 1

    def shutdown(self) -> None:
        """Stop the worker pool and wake every blocked fetcher / submitter /
        drainer (they observe the shutdown flag and raise).  Pending work is
        abandoned; call :meth:`drain` first for a clean stop."""
        self._shutdown = True
        self._ready.close()
        with self._gates_lock:
            gates = list(self._tenant_gates.values())
            gates += list(self._lane_gates.values())
        if self._global_gate is not None:
            gates.append(self._global_gate)
        for g in gates:
            g.notify_all()
        for stripe in self._stripes:
            with stripe.lock:
                stripe.cv.notify_all()
        with self._drain_cv:
            self._drain_cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.drain()
        self.shutdown()
        return False

    # ------------------------------------------------------------ internals
    def _req_key(self, query_name: str, params: tuple) -> Optional[tuple]:
        """Request identity for dedup/caching; None if params unhashable."""
        try:
            hash(params)
        except TypeError:
            return None
        return (query_name, params)

    def _lane_key(self, query_name: str) -> str:
        return query_name if self.sharded else _SINGLE_LANE

    def _handle_stripe(self, key: int) -> _HandleStripe:
        return self._stripes[key & self._stripe_mask]

    def _req_stripe(self, req: tuple) -> _ReqStripe:
        return self._req_stripes[hash(req) & self._stripe_mask]

    # ------------------------------------------------------------ cache API
    def invalidate(self, query_name: Optional[str] = None,
                   params: Optional[tuple] = None) -> int:
        """Explicit result-cache invalidation hook (the complement of TTL
        expiry, for services whose writes are visible to the caller).

        ``invalidate()`` drops everything; ``invalidate(q)`` drops every
        cached result of template ``q``; ``invalidate(q, params)`` drops one
        entry.  Shared (projection) variants resolve to their canonical
        template first.  Returns the number of entries dropped.
        """
        if self._cache is None:
            return 0
        if query_name is not None and self.policy is not None:
            query_name = self.policy.resolve(query_name)[0]
        return self._cache.invalidate(query_name, params, self._req_key)

    # ------------------------------------------------------- quota plumbing
    _GATE_SWEEP_AT = 1024  # registry size that triggers an idle-gate sweep

    def _gate(self, registry: dict, key: str) -> QuotaGate:
        gate = registry.get(key)
        if gate is None:
            with self._gates_lock:
                gate = registry.get(key)
                if gate is None:
                    if len(registry) >= self._GATE_SWEEP_AT:
                        # High-cardinality churn (per-entity lanes, one-shot
                        # tenants) must not grow the registries without
                        # bound: drop idle gates, amortized over creations.
                        for k, g in list(registry.items()):
                            if g.try_gc():
                                del registry[k]
                    gate = registry[key] = QuotaGate()
        return gate

    def _acquire_slots(self, lane_key: str, tenant: Optional[str]) -> tuple:
        """Reserve one slot at every admission bound that applies, blocking
        on the *full* bound's own CV.  Returns the gates holding a slot (to
        release at delivery).  To stay deadlock-free across bounds, slots
        already held are given back before sleeping, then the whole set is
        re-acquired — a blocked whale never pins a lane slot it cannot use.

        Registry-backed gates are re-validated after each acquire: a gate
        swept out of its registry between lookup and acquire no longer
        bounds anything, so the slot is given back and the live gate is
        re-resolved.
        """
        policy = self.policy
        if policy is not None:
            tq = policy.tenant_quota(tenant)
            lq = policy.lane_quota
        else:
            tq = lq = None
        if self._global_gate is None and tq is None and lq is None:
            if self._shutdown:
                raise RuntimeError("runtime is shut down")
            return ()

        acquired: list = []
        blocked = False
        try:
            while True:
                if self._shutdown:
                    raise RuntimeError("runtime is shut down")
                # (gate, limit, registry, key); registry None = never swept
                need: list = []
                if self._global_gate is not None:
                    need.append((self._global_gate, self.max_pending,
                                 None, None))
                if tq is not None:
                    need.append((self._gate(self._tenant_gates, tenant), tq,
                                 self._tenant_gates, tenant))
                if lq is not None:
                    need.append((self._gate(self._lane_gates, lane_key), lq,
                                 self._lane_gates, lane_key))
                full = None
                stale = False
                for gate, limit, registry, key in need:
                    if not gate.try_acquire(limit):
                        full = (gate, limit)
                        break
                    if registry is not None and registry.get(key) is not gate:
                        gate.release()  # swept while we acquired: re-resolve
                        stale = True
                        break
                    acquired.append(gate)
                if full is None and not stale:
                    slots = tuple(acquired)
                    acquired = []
                    return slots
                for g in acquired:
                    g.release()
                acquired = []
                if stale:
                    continue
                if not blocked:
                    blocked = True
                    self.stats.quota_waits.add()
                gate, limit = full
                gate.wait_below(limit, lambda: self._shutdown)
        finally:
            for g in acquired:  # only on exception paths
                g.release()

    def _release_slots(self, slots: tuple) -> None:
        for g in slots:
            g.release()

    # ------------------------------------------------------- lane plumbing
    def _append_entry(self, lane_key: str, entry: _Entry,
                      skip_if=None) -> bool:
        """Append under the lane lock and schedule the lane if needed.

        The ready push happens only on the empty→nonempty transition (or
        when the lane is parked): a nonempty lane is already covered — by
        its pending ready entry, or by the worker that left it nonempty
        and re-pushes it after releasing the lane lock.  This keeps the
        shared ready queue off the per-submission hot path once lanes are
        flowing.

        ``skip_if(lane)`` (checked under the lane lock) aborts the append
        — the straggler path uses it to avoid piling up duplicates of a
        handle that is already queued again.  Returns whether the entry
        was appended.
        """
        while True:
            lane = self._lanes.get(lane_key)
            if lane is None:
                with self._lanes_lock:
                    lane = self._lanes.get(lane_key)
                    if lane is None:
                        lane = self._lanes[lane_key] = _Lane(lane_key)
                        self.stats.lane_traces.setdefault(lane_key, [])
            with lane.lock:
                if lane.dead:
                    continue  # lost a race with GC: re-resolve the registry
                if skip_if is not None and skip_if(lane):
                    return False
                wake = not lane.entries or lane.parked
                lane.parked = False
                lane.entries.append(entry)
                break
        if wake:
            self._ready.push(lane_key)
        return True

    def _maybe_gc_lane(self, lane_key: str, lane: _Lane) -> None:
        """GC drained lanes so high-cardinality template churn doesn't grow
        the registry (traces keep the history).  ``dead`` closes the race
        with a submitter holding a stale reference: it re-resolves."""
        with self._lanes_lock:
            with lane.lock:
                if not lane.entries and self._lanes.get(lane_key) is lane:
                    lane.dead = True
                    del self._lanes[lane_key]

    def _resubmit(self, handle: Handle) -> bool:
        """Duplicate a straggler onto its own lane (dedup bypassed on
        purpose: the point is a racing duplicate call)."""
        key = handle.key
        stripe = self._handle_stripe(key)
        with stripe.lock:
            if key in stripe.results or key in stripe.errors:
                return False  # resolved while we were timing out
            meta = stripe.pending.get(key)
            if meta is None:
                return False
            lane_query, params = meta.lane_query, meta.params
        lk = self._lane_key(lane_query)
        appended = self._append_entry(
            lk, _Entry(key, lane_query, params),
            # already queued again (an earlier timeout's duplicate): skip
            skip_if=lambda lane: any(key in e.keys for e in lane.entries),
        )
        if appended:
            self.stats.resubmissions.add()
        return appended

    # ------------------------------------------------------- worker internals
    def _take(self, lane_key: str) -> Optional[tuple]:
        """Pop a batch from one ready lane under ITS lock only.  Returns
        ``(query_name, entries)`` or None (stale pop / strategy says wait —
        the next submit or ``producer_done`` re-queues the lane)."""
        lane = self._lanes.get(lane_key)
        if lane is None:
            return None
        first_q: Optional[str] = None
        picked: list[_Entry] = []
        with lane.lock:
            if not lane.dead and lane.entries:
                strategy = (self.policy.strategy_for(lane_key)
                            if self.policy is not None else self.strategy)
                take = strategy.decide(len(lane.entries), self._producer_done)
                if take <= 0:
                    # Strategy says wait.  Park: the next submit (or
                    # producer_done) re-queues the lane so the strategy is
                    # re-asked with the larger backlog.
                    lane.parked = True
                    return None
                lane.parked = False
                take = min(take, len(lane.entries))
                # Batches must share a query template.  Sharded lanes are
                # homogeneous by construction; the single-queue compatibility
                # mode splits at the first boundary (the paper's behaviour).
                first_q = lane.entries[0].query_name
                while lane.entries and len(picked) < take:
                    if lane.entries[0].query_name != first_q:
                        break
                    entry = lane.entries.popleft()
                    rk = self._req_key(entry.query_name, entry.params)
                    if rk is not None and self.dedup:
                        rs = self._req_stripe(rk)
                        with rs.lock:
                            if rs.queued.get(rk) is entry:
                                del rs.queued[rk]
                            if rk not in rs.inflight:
                                rs.inflight[rk] = entry
                    picked.append(entry)
                if self.policy is not None and self.policy.lane_weights:
                    self.policy.charge(lane_key, len(picked))
                seq = next(self._exec_seq)
                self.stats.batch_trace.append((seq, len(picked)))
                self.stats.lane_traces.setdefault(lane_key, []).append(
                    (seq, len(picked)))
                if len(picked) == 1:
                    self.stats.single_executions.add()
                else:
                    self.stats.batch_executions.add()
            more = bool(lane.entries) and not lane.dead
        if more:
            # Leftover backlog: stay scheduled so another worker (or this
            # one, next round) keeps draining the lane.
            self._ready.push(lane_key)
        elif not lane.dead:
            # A submit racing this GC re-resolves the registry and pushes
            # the lane ready itself, so no pick is ever stranded.
            self._maybe_gc_lane(lane_key, lane)
        if picked:
            return first_q, picked
        return None

    def _observe(self, lane_key: str, batch_size: int, duration: float) -> None:
        """Route service-call feedback to the deciding model: the lane's own
        (policy mode) or the global strategy."""
        if self.policy is not None:
            self.policy.observe(lane_key, batch_size, duration)
        else:
            self.strategy.observe(batch_size, duration)

    def _observe_failure(self, lane_key: str, duration: float) -> None:
        """Route a failed-call observation to the deciding cost model (it
        feeds the adaptive threshold's failure penalty, not the service-time
        estimate — failed calls are often fast-failing and would corrupt
        the latter)."""
        if self.policy is not None:
            self.policy.observe_failure(lane_key, duration)
        else:
            self.strategy.observe_failure(duration)

    # ------------------------------------------------- resilient execution
    def _execute_once(self, query_name: str, picked: list) -> list:
        """One service call for the picked entries; normalizes the batch /
        single split and validates result cardinality (a service returning
        the wrong number of rows is a non-retryable contract violation —
        guessing an alignment would deliver values to the wrong handles)."""
        if len(picked) == 1:
            out = [self.service.execute(query_name, picked[0].params)]
        else:
            out = self.service.execute_batch(
                query_name, [e.params for e in picked]
            )
            out = list(out)
        if len(out) != len(picked):
            raise ServiceCardinalityError(query_name, len(picked), len(out))
        return out

    def _call_with_retry(self, lane_key: str, query_name: str, picked: list,
                         breaker) -> tuple:
        """Execute with bounded retry + exponential backoff + deterministic
        jitter, spending the lane's retry budget (earned back by successes,
        so a persistent failure can't turn into a retry storm).  Returns
        ``(out, None)`` on success, ``(None, last_exception)`` on final
        failure.  Success/failure is reported to the breaker and to the
        cost model's failure penalty."""
        fd = self._fd
        policy = fd.retry
        budget = fd.budget(lane_key)
        last: Optional[BaseException] = None
        for attempt in range(max(1, policy.max_attempts)):
            if attempt > 0:
                self.stats.retries.add()
                policy.sleep_backoff(attempt, lane_key)
            t0 = time.perf_counter()
            try:
                out = self._execute_once(query_name, picked)
            except BaseException as e:  # noqa: BLE001 — propagate via fetch
                last = e
                self.stats.failures.add()
                self._observe_failure(lane_key, time.perf_counter() - t0)
                if breaker is not None:
                    breaker.record_failure()
                if not policy.is_retryable(e):
                    break
                # The budget caps retry *amplification*: re-executing an
                # n-entry batch multiplies load n-fold, so batch retries
                # spend tokens.  A single entry's bounded retries can't
                # amplify beyond max_attempts and must stay available even
                # with a dry budget — otherwise a first-attempt transient
                # leaks to a fetcher that fault-free semantics say succeeds.
                if len(picked) > 1 and not budget.try_spend():
                    break
                continue
            self._observe(lane_key, len(picked), time.perf_counter() - t0)
            budget.earn()
            if breaker is not None:
                breaker.record_success()
            return out, None
        return None, last

    def _execute_shed(self, lane_key: str, query_name: str,
                      picked: list) -> tuple:
        """Tripped-breaker degraded mode: per-entry direct synchronous
        execution (no batching) so each request still resolves — with its
        own value or its own error — while the lane's batch path cools
        down.  Transient faults are still retried per entry (bounded by
        ``max_attempts``, exempt from the budget: single-entry retries
        can't amplify into a storm, and exception semantics must survive
        degradation), and successes earn the budget back so the bucket is
        refilled by the time the breaker closes.  No breaker feedback is
        recorded: shed traffic must not hold the breaker open — the
        half-open probes decide recovery."""
        fd = self._fd
        policy = fd.retry
        budget = fd.budget(lane_key)
        self.stats.shed_submissions.add(len(picked))
        out: list = []
        errs: list = []
        any_err = False
        for entry in picked:
            err: Optional[BaseException] = None
            value = None
            for attempt in range(max(1, policy.max_attempts)):
                if attempt > 0:
                    self.stats.retries.add()
                    policy.sleep_backoff(attempt, (lane_key, "shed"))
                try:
                    value, err = self.service.execute(
                        query_name, entry.params), None
                    budget.earn()
                    break
                except BaseException as e:  # noqa: BLE001 — own delivery
                    err = e
                    self.stats.failures.add()
                    if not policy.is_retryable(e):
                        break
            out.append(value)
            errs.append(err)
            any_err = any_err or err is not None
        return out, (errs if any_err else None)

    def _execute_resilient(self, lane_key: str, query_name: str,
                           picked: list) -> tuple:
        """Execute one picked batch under the failure domain: breaker-gated,
        retried with backoff, and — on final batch failure — fission-split
        so each param's own exception reaches exactly its own handles while
        innocent co-batched params still get values.  Returns ``(out,
        errs)`` in :meth:`_complete`'s per-entry format.  Without a
        resilience config this is the legacy one-shot path."""
        fd = self._fd
        if fd is None:
            t0 = time.perf_counter()
            try:
                out = self._execute_once(query_name, picked)
            except BaseException as e:  # noqa: BLE001 — propagate via fetch
                return None, [e] * len(picked)
            self._observe(lane_key, len(picked), time.perf_counter() - t0)
            return out, None
        breaker = fd.breaker(lane_key)
        if breaker is not None and breaker.allow() == "shed":
            return self._execute_shed(lane_key, query_name, picked)
        out, exc = self._call_with_retry(lane_key, query_name, picked, breaker)
        if exc is None:
            return out, None
        if len(picked) == 1 or not fd.config.fission:
            return None, [exc] * len(picked)
        # Batch fission-retry: binary split and recurse.  Each half re-enters
        # the resilient path (re-checking the breaker — repeated failures
        # during fission can trip it and degrade the rest to shed mode), so
        # a single poisoned param is isolated at batch-size 1, where its own
        # exception is delivered to exactly its own handles.
        self.stats.fissions.add()
        mid = len(picked) // 2
        out_lo, errs_lo = self._execute_resilient(
            lane_key, query_name, picked[:mid])
        out_hi, errs_hi = self._execute_resilient(
            lane_key, query_name, picked[mid:])
        if errs_lo is None and errs_hi is None:
            return (out_lo or []) + (out_hi or []), None
        out = ((out_lo if out_lo is not None else [None] * mid)
               + (out_hi if out_hi is not None else [None] * (len(picked) - mid)))
        errs = ((errs_lo if errs_lo is not None else [None] * mid)
                + (errs_hi if errs_hi is not None
                   else [None] * (len(picked) - mid)))
        return out, errs

    def _deliver_into(self, stripe: _HandleStripe, key: int, value: Any,
                      projector) -> None:
        """Resolve one handle (stripe lock held), applying its projection."""
        if projector is None:
            stripe.results[key] = value
            return
        try:
            stripe.results[key] = projector(value)
        except BaseException as e:  # noqa: BLE001 — surface via fetch
            stripe.errors[key] = e

    def _deliver_cached(self, stripe: _HandleStripe, key: int, value: Any,
                        projector, slots: tuple) -> None:
        """Resolve a submission from the result cache: deliver + wake the
        stripe, give back the admission slots, count the completion.  Any
        pending metadata registered for the key is discarded — the handle
        resolves here, not through a service call."""
        with stripe.lock:
            stripe.pending.pop(key, None)
            self._deliver_into(stripe, key, value, projector)
            stripe.cv.notify_all()
        self._release_slots(slots)
        self.stats.cache_hits.add()
        self.stats.completed.add()
        self._notify_drain()

    def _complete(self, picked: list, out, errs) -> None:
        """Fan one service call's results out to every attached handle —
        per handle stripe, outside any lane lock.  ``errs`` is ``None``
        (all succeeded) or a list aligned with ``picked`` holding each
        entry's own exception (``None`` for entries that succeeded) — an
        error reaches exactly the handles attached to ITS entry, and every
        dedup'd waiter of an entry gets that entry's outcome exactly once.
        Straggler duplicates (and deadline-expired handles) may already be
        resolved: first result wins, idempotently.  The stripe CV is
        signalled in a ``finally`` so no fault between delivery and wakeup
        can strand a fetcher."""
        per_stripe: dict[int, list] = {}
        for i, entry in enumerate(picked):
            err = errs[i] if errs is not None else None
            value = out[i] if err is None and out is not None else None
            rk = self._req_key(entry.query_name, entry.params)
            if err is None and rk is not None and self._cache is not None:
                # Cache before unregistering from the dedup registry: paired
                # with submit's cache re-probe under the req-stripe lock, a
                # racing identical submission sees either the live entry or
                # the cached value — never a gap that re-executes.  A cache
                # fault must not poison delivery (the result still reaches
                # its waiters; only reuse is lost).
                try:
                    self._cache.put(rk, value)
                except BaseException:  # noqa: BLE001 — best-effort reuse
                    pass
            if rk is not None and self.dedup:
                rs = self._req_stripe(rk)
                with rs.lock:
                    if rs.inflight.get(rk) is entry:
                        del rs.inflight[rk]
                    keys = list(entry.keys)  # snapshot closes the attach race
            else:
                keys = list(entry.keys)
            for key in keys:
                per_stripe.setdefault(key & self._stripe_mask, []).append(
                    (key, value, err))
        released: list = []
        n_done = 0
        for idx, items in per_stripe.items():
            stripe = self._stripes[idx]
            with stripe.lock:
                try:
                    for key, value, err in items:
                        if key in stripe.results or key in stripe.errors:
                            continue  # straggler duplicate: first result won
                        meta = stripe.pending.pop(key, None)
                        projector = (meta.projector
                                     if meta is not None else None)
                        if err is not None:
                            stripe.errors[key] = err
                        else:
                            self._deliver_into(stripe, key, value, projector)
                        n_done += 1
                        if meta is not None:
                            released.append(meta)
                finally:
                    stripe.cv.notify_all()
        for meta in released:
            self._release_slots(meta.slots)
        if n_done:
            self.stats.completed.add(n_done)
            self._notify_drain()

    def _notify_drain(self) -> None:
        if self._drain_waiters:
            with self._drain_cv:
                self._drain_cv.notify_all()

    # consecutive takes a worker may spend on one lane before it must go
    # back to the ready queue: bounds how long any other ready lane can
    # wait behind sticky workers (liveness), while still amortizing the
    # ready-queue round trip over bursts on a busy lane.
    _STICKY_TAKES = 8

    def _worker(self) -> None:
        lane_key = None  # sticky lane: drain it (boundedly) before re-pop
        sticky_left = 0
        while True:
            if self._shutdown:
                return  # abandon pending work, as the global-lock loop did
            if lane_key is None:
                # Weighted-fair selection costs a policy-lock + O(n) scan
                # per pick, and with uniform weights FIFO pop + tail
                # re-push IS fair round-robin — so consult the policy's
                # weights afresh each pop (weights may be set at any time)
                # and select only when some lane is actually weighted.
                policy = self.policy
                select = (policy.lane_min
                          if policy is not None and policy.lane_weights
                          else None)
                lane_key = self._ready.pop(select=select)
                if lane_key is None:
                    return  # queue closed: shutdown
                sticky_left = self._STICKY_TAKES
            work = self._take(lane_key)
            if work is None:
                # Lane dry (or parked): go back to the ready queue.
                lane_key = None
                continue
            query_name, picked = work

            out, errs = self._execute_resilient(lane_key, query_name, picked)
            try:
                self._complete(picked, out, errs)
            except BaseException as e:  # noqa: BLE001 — never strand fetchers
                # A fault in fan-out itself (e.g. a poisoned cache or dedup
                # registry) must still resolve every attached handle — an
                # exception mid-_complete would otherwise strand fetchers on
                # an unsignalled CV forever.  Deliveries are idempotent, so
                # re-completing the already-resolved prefix is a no-op.
                self._complete(picked, None, [e] * len(picked))
            # Sticky: keep draining this lane while it has work — the next
            # _take re-checks under the lane lock, so no ready-queue round
            # trip (lock + wakeup) is paid per batch on a busy lane.  The
            # stick is BOUNDED: after _STICKY_TAKES batches the worker
            # rotates through the ready queue (the lane was re-pushed by
            # _take if it kept a backlog), so ready lanes can never starve
            # behind stuck-in-a-groove workers.
            sticky_left -= 1
            if sticky_left <= 0:
                lane_key = None
