"""FROZEN PR 2 baseline: the global-lock multi-lane runtime, kept verbatim
for A/B measurement only.

This is the :class:`~repro.core.runtime.AsyncQueryRuntime` as it stood
before the lock-sharded refactor: every ``submit`` / ``fetch`` / worker
pick / cache probe / quota check funnels through ONE ``threading.Lock``,
quota waits busy-poll at 100 ms, and every delivery ``notify_all``s one
global condition variable that every blocked producer and fetcher sleeps
on.  The Part 5 contention scenario in ``benchmarks/bench_lanes.py``
drives this class and the sharded runtime with identical 32-producer /
8-worker traffic and gates the sharded runtime's submissions/s at >= 2x
this baseline in CI.

Do not grow features here — it exists to stay slow in exactly the way
PR 2 was slow.  The API mirrors the sharded runtime (handles are the
shared :class:`~repro.core.runtime.Handle` type) so drivers can swap the
two classes.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Optional

from repro_torch.core.lane_policy import LanePolicy
from repro_torch.core.runtime import Handle
from repro_torch.core.services import QueryService
from repro_torch.core.strategies import BatchingStrategy, PureAsync

__all__ = ["GlobalLockRuntime", "GlobalLockRuntimeStats"]

_SINGLE_LANE = "__single__"  # lane key in sharded=False compatibility mode


@dataclasses.dataclass
class GlobalLockRuntimeStats:
    submitted: int = 0
    completed: int = 0
    single_executions: int = 0
    batch_executions: int = 0
    resubmissions: int = 0
    deduped: int = 0      # submissions coalesced onto a pending/in-flight call
    cache_hits: int = 0   # submissions served from the completed-result LRU
    cache_expired: int = 0  # LRU entries dropped because their TTL lapsed
    shared: int = 0       # submissions rerouted onto a canonical lane (projection)
    quota_waits: int = 0  # submissions that blocked on a quota / back-pressure bound
    batch_trace: list = dataclasses.field(default_factory=list)  # (seq, size)
    # per-lane (seq, size) traces; lane key == query template (or __single__)
    lane_traces: dict = dataclasses.field(default_factory=dict)

    def snapshot(self) -> dict:
        d = dataclasses.asdict(self)
        d["batch_sizes"] = [s for _, s in self.batch_trace if s > 1]
        d["mean_batch_size"] = self.mean_batch_size
        return d

    @property
    def mean_batch_size(self) -> float:
        if not self.batch_trace:
            return 0.0
        return sum(s for _, s in self.batch_trace) / len(self.batch_trace)


class _Entry:
    """One service call's worth of work: a params tuple plus every handle
    key whose submission coalesced onto it (dedup fan-out)."""

    __slots__ = ("keys", "query_name", "params")

    def __init__(self, key: int, query_name: str, params: tuple):
        self.keys = [key]
        self.query_name = query_name
        self.params = params


class GlobalLockRuntime:
    """The runtime library of §4.2 + §5.2, sharded into per-template lanes.

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
    ):
        if policy is not None and strategy is not None:
            raise ValueError(
                "pass either a global `strategy` or a per-lane `policy`, not both"
            )
        self.service = service
        self.policy = policy
        self.strategy = strategy or PureAsync()
        self.strategy.reset()
        self.n_threads = n_threads
        self.max_pending = max_pending
        self.straggler_timeout = straggler_timeout
        self.sharded = sharded
        self.dedup = dedup

        # lane key -> deque[_Entry]; insertion-ordered for round-robin
        self._lanes: "OrderedDict[str, deque[_Entry]]" = OrderedDict()
        self._rr = 0  # round-robin cursor over lanes
        self._n_pending = 0  # total queued entries across lanes
        self._results: dict[int, Any] = {}
        self._errors: dict[int, BaseException] = {}
        self._lock = threading.Lock()
        self._work_cv = threading.Condition(self._lock)  # queue state changed
        self._done_cv = threading.Condition(self._lock)  # a result arrived
        self._next_key = 0
        self._producer_done = False
        self._shutdown = False
        # dedup registries: request identity -> live entry
        self._queued_by_req: dict[tuple, _Entry] = {}
        self._inflight_by_req: dict[tuple, _Entry] = {}
        # handle key -> (query_name, params) while unresolved (stragglers)
        self._inflight_params: dict[int, tuple] = {}
        # LRU maps request identity -> (value, monotonic deadline | None)
        self._cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._cache_size = result_cache_size
        self._cache_ttl = result_cache_ttl
        # per-handle projection (cross-template sharing fan-out)
        self._projections: dict[int, Any] = {}
        # quota accounting: handle key -> (lane key, tenant) while outstanding
        self._accounting: dict[int, tuple] = {}
        self._lane_out: dict[str, int] = {}
        self._tenant_out: dict[str, int] = {}
        self.stats = GlobalLockRuntimeStats()

        self._threads = [
            threading.Thread(target=self._worker, name=f"glr-worker-{i}", daemon=True)
            for i in range(n_threads)
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------ API
    def submit(self, query_name: str, params: tuple,
               tenant: Optional[str] = None) -> Handle:
        """Non-blocking query submission (``submitQuery``).  Blocks only at an
        admission bound: the global ``max_pending`` (§8 producer back-off), or
        — with a :class:`LanePolicy` — this tenant's / this lane's quota.

        With a policy, templates registered via ``policy.share`` are
        canonicalized onto their shared lane here; the submission's own
        projection is applied at result fan-out.
        """
        policy = self.policy
        if policy is not None:
            lane_query, projector = policy.resolve(query_name)
        else:
            lane_query, projector = query_name, None
        with self._lock:
            lk = self._lane_key(lane_query)
            # Back-off bounds OUTSTANDING requests (submitted, unresolved)
            # rather than queued entries, so coalesced duplicates — which
            # enqueue nothing but still hold a handle, a registry slot and
            # eventually a result — cannot grow memory past the bound either.
            blocked = False
            while not self._shutdown:
                tq = policy.tenant_quota(tenant) if policy is not None else None
                lq = policy.lane_quota if policy is not None else None
                if (
                    self.max_pending is not None
                    and self.stats.submitted - self.stats.completed >= self.max_pending
                ):
                    pass
                elif (tq is not None
                        and self._tenant_out.get(tenant, 0) >= tq):
                    pass
                elif lq is not None and self._lane_out.get(lk, 0) >= lq:
                    pass
                else:
                    break
                if not blocked:
                    blocked = True
                    self.stats.quota_waits += 1
                self._done_cv.wait(timeout=0.1)
            if self._shutdown:
                raise RuntimeError("runtime is shut down")
            handle = Handle(self._next_key, query_name)
            self._next_key += 1
            self.stats.submitted += 1
            self._producer_done = False
            if projector is not None:
                self.stats.shared += 1
            if policy is not None:
                policy.note_submit(lk)

            req = self._req_key(lane_query, params)
            # 1) completed-result cache (SharedDB-style reuse across time)
            if req is not None and self._cache_size:
                value, fresh = self._cache_get_locked(req)
                if fresh:
                    self._deliver_locked(handle.key, value, projector)
                    self.stats.cache_hits += 1
                    self.stats.completed += 1
                    self._done_cv.notify_all()
                    return handle
            # 2) in-flight/pending dedup (sharing across concurrent users)
            if req is not None and self.dedup:
                live = self._queued_by_req.get(req) or self._inflight_by_req.get(req)
                if live is not None:
                    live.keys.append(handle.key)
                    self._inflight_params[handle.key] = (lane_query, params)
                    self._register_outstanding_locked(handle.key, lk, tenant, projector)
                    self.stats.deduped += 1
                    return handle
            # 3) enqueue on this template's lane
            entry = _Entry(handle.key, lane_query, params)
            if req is not None and self.dedup:
                self._queued_by_req[req] = entry
            self._inflight_params[handle.key] = (lane_query, params)
            self._register_outstanding_locked(handle.key, lk, tenant, projector)
            self._lane_for(lane_query).append(entry)
            self._n_pending += 1
            self._work_cv.notify()
        return handle

    def producer_done(self) -> None:
        """Signal that no more requests are coming (enables PureBatch and
        lets adaptive strategies drain the tail)."""
        with self._lock:
            self._producer_done = True
            self._work_cv.notify_all()

    def fetch(self, handle: Optional[Handle]) -> Any:
        """Blocking result fetch (``fetchResult`` / ``getResultSet(ctx)``).
        ``None`` handles (guarded-away submissions, Rule B) return ``None``.
        """
        if handle is None:
            return None
        deadline = (
            time.monotonic() + self.straggler_timeout
            if self.straggler_timeout is not None
            else None
        )
        with self._lock:
            while handle.key not in self._results and handle.key not in self._errors:
                timeout = None
                if deadline is not None:
                    timeout = max(0.0, deadline - time.monotonic())
                    if timeout == 0.0:
                        # Straggler: re-enqueue so another lane retries.
                        self._resubmit_locked(handle)
                        deadline = time.monotonic() + self.straggler_timeout
                        timeout = self.straggler_timeout
                self._done_cv.wait(timeout=timeout)
            if handle.key in self._errors:
                raise self._errors[handle.key]
            return self._results[handle.key]

    # The HIR interpreter's synchronous path delegates to the service.
    def execute(self, query_name: str, params: tuple) -> Any:
        return self.service.execute(query_name, params)

    def drain(self) -> None:
        """Block until every submitted request has a result."""
        self.producer_done()
        with self._lock:
            while self.stats.completed < self.stats.submitted:
                self._done_cv.wait(timeout=0.1)

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._work_cv.notify_all()
            self._done_cv.notify_all()
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

    # --------------------------------------------------- cache (TTL + hooks)
    def _cache_get_locked(self, req: tuple) -> tuple:
        """``(value, fresh)`` — expires TTL'd entries on the read path."""
        hit = self._cache.get(req)
        if hit is None:
            return None, False
        value, deadline = hit
        if deadline is not None and time.monotonic() >= deadline:
            del self._cache[req]
            self.stats.cache_expired += 1
            return None, False
        self._cache.move_to_end(req)
        return value, True

    def _cache_put_locked(self, req: tuple, value: Any) -> None:
        deadline = (
            time.monotonic() + self._cache_ttl
            if self._cache_ttl is not None else None
        )
        self._cache[req] = (value, deadline)
        self._cache.move_to_end(req)
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)

    def invalidate(self, query_name: Optional[str] = None,
                   params: Optional[tuple] = None) -> int:
        """Explicit result-cache invalidation hook (the complement of TTL
        expiry, for services whose writes are visible to the caller).

        ``invalidate()`` drops everything; ``invalidate(q)`` drops every
        cached result of template ``q``; ``invalidate(q, params)`` drops one
        entry.  Shared (projection) variants resolve to their canonical
        template first.  Returns the number of entries dropped.
        """
        if query_name is not None and self.policy is not None:
            query_name = self.policy.resolve(query_name)[0]
        with self._lock:
            if query_name is None:
                n = len(self._cache)
                self._cache.clear()
                return n
            if params is not None:
                rk = self._req_key(query_name, params)
                if rk is not None and rk in self._cache:
                    del self._cache[rk]
                    return 1
                return 0
            victims = [k for k in self._cache if k[0] == query_name]
            for k in victims:
                del self._cache[k]
            return len(victims)

    # ------------------------------------------------ quota + share plumbing
    def _register_outstanding_locked(self, key: int, lane_key: str,
                                     tenant: Optional[str],
                                     projector: Optional[Any]) -> None:
        self._accounting[key] = (lane_key, tenant)
        self._lane_out[lane_key] = self._lane_out.get(lane_key, 0) + 1
        if tenant is not None:
            self._tenant_out[tenant] = self._tenant_out.get(tenant, 0) + 1
        if projector is not None:
            self._projections[key] = projector

    def _release_outstanding_locked(self, key: int) -> None:
        acct = self._accounting.pop(key, None)
        if acct is None:
            return
        lane_key, tenant = acct
        left = self._lane_out.get(lane_key, 0) - 1
        if left > 0:
            self._lane_out[lane_key] = left
        else:
            self._lane_out.pop(lane_key, None)
        if tenant is not None:
            left = self._tenant_out.get(tenant, 0) - 1
            if left > 0:
                self._tenant_out[tenant] = left
            else:
                self._tenant_out.pop(tenant, None)

    def _deliver_locked(self, key: int, value: Any, projector) -> None:
        """Resolve one handle, applying its projection (sharing fan-out)."""
        if projector is None:
            self._results[key] = value
            return
        try:
            self._results[key] = projector(value)
        except BaseException as e:  # noqa: BLE001 — surface via fetch
            self._errors[key] = e

    def _observe(self, lane_key: str, batch_size: int, duration: float) -> None:
        """Route service-call feedback to the deciding model: the lane's own
        (policy mode) or the global strategy."""
        if self.policy is not None:
            self.policy.observe(lane_key, batch_size, duration)
        else:
            self.strategy.observe(batch_size, duration)

    def _lane_for(self, query_name: str) -> deque:
        lk = self._lane_key(query_name)
        lane = self._lanes.get(lk)
        if lane is None:
            lane = self._lanes[lk] = deque()
            self.stats.lane_traces.setdefault(lk, [])
        return lane

    def _resubmit_locked(self, handle: Handle) -> None:
        qp = self._inflight_params.get(handle.key)
        if qp is None:
            return  # already resolved
        query_name, params = qp
        lane = self._lane_for(query_name)
        for e in lane:
            if handle.key in e.keys:
                return  # already pending again
        # Bypass dedup on purpose: the point is a racing duplicate call.
        lane.append(_Entry(handle.key, query_name, params))
        self._n_pending += 1
        self.stats.resubmissions += 1
        self._work_cv.notify()

    def _pick_locked(self) -> Optional[tuple]:
        """Pick work from the lanes: weighted-fair order under a
        :class:`LanePolicy` (lowest virtual time first, each lane asked its
        OWN strategy), plain round-robin with the global strategy otherwise.
        The first lane whose strategy grants a take yields
        ``(lane_key, query_name, [entries])``.  None → nothing to do."""
        keys = list(self._lanes.keys())
        if not keys:
            return None
        n_lanes = len(keys)
        if self.policy is not None:
            ordered = self.policy.lane_order(
                [k for k in keys if self._lanes[k]])
        else:
            ordered = [keys[(self._rr + off) % n_lanes] for off in range(n_lanes)]
        for pos, lk in enumerate(ordered):
            lane = self._lanes.get(lk)
            if not lane:
                continue
            strategy = (self.policy.strategy_for(lk) if self.policy is not None
                        else self.strategy)
            take = strategy.decide(len(lane), self._producer_done)
            if take <= 0:
                continue
            if self.policy is None:
                self._rr = (self._rr + pos + 1) % n_lanes
            take = min(take, len(lane))
            # Batches must share a query template.  Sharded lanes are
            # homogeneous by construction; the single-queue compatibility
            # mode splits at the first boundary (the paper's behaviour).
            first_q = lane[0].query_name
            picked: list[_Entry] = []
            while lane and len(picked) < take:
                if lane[0].query_name != first_q:
                    break
                entry = lane.popleft()
                rk = self._req_key(entry.query_name, entry.params)
                if rk is not None and self._queued_by_req.get(rk) is entry:
                    del self._queued_by_req[rk]
                if self.dedup and rk is not None \
                        and rk not in self._inflight_by_req:
                    self._inflight_by_req[rk] = entry
                picked.append(entry)
            self._n_pending -= len(picked)
            if self.policy is not None:
                self.policy.charge(lk, len(picked))
            if not lane:
                # GC empty lanes so high-cardinality template churn doesn't
                # grow the round-robin scan (traces keep the history).
                del self._lanes[lk]
            seq = self.stats.single_executions + self.stats.batch_executions
            self.stats.batch_trace.append((seq, len(picked)))
            self.stats.lane_traces.setdefault(lk, []).append((seq, len(picked)))
            if len(picked) == 1:
                self.stats.single_executions += 1
            else:
                self.stats.batch_executions += 1
            return lk, first_q, picked
        return None

    def _worker(self) -> None:
        while True:
            with self._lock:
                work = None
                while not self._shutdown:
                    if self._n_pending:
                        work = self._pick_locked()
                        if work is not None:
                            break
                    self._work_cv.wait(timeout=0.05)
                if self._shutdown:
                    return
            lane_key, query_name, picked = work

            t0 = time.perf_counter()
            try:
                if len(picked) == 1:
                    out = [self.service.execute(query_name, picked[0].params)]
                else:
                    out = self.service.execute_batch(
                        query_name, [e.params for e in picked]
                    )
                err = None
            except BaseException as e:  # noqa: BLE001 — propagate via fetch
                out, err = None, e
            if err is None:
                # Failed calls (often fast-failing) would corrupt a learned
                # cost model — only successful durations are evidence.  The
                # observation goes to the model that made the decision: the
                # lane's own under a policy, the global strategy otherwise.
                self._observe(lane_key, len(picked), time.perf_counter() - t0)

            with self._lock:
                for i, entry in enumerate(picked):
                    rk = self._req_key(entry.query_name, entry.params)
                    if rk is not None and self._inflight_by_req.get(rk) is entry:
                        del self._inflight_by_req[rk]
                    if err is None and rk is not None and self._cache_size:
                        self._cache_put_locked(rk, out[i])
                    # Fan the result out to every coalesced handle; straggler
                    # duplicates may already be resolved — first result wins.
                    for key in entry.keys:
                        if key in self._results or key in self._errors:
                            continue
                        if err is not None:
                            self._errors[key] = err
                            self._projections.pop(key, None)
                        else:
                            self._deliver_locked(
                                key, out[i], self._projections.pop(key, None)
                            )
                        self.stats.completed += 1
                        self._inflight_params.pop(key, None)
                        self._release_outstanding_locked(key)
                self._done_cv.notify_all()
