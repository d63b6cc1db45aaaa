"""Per-lane policy engine: learned per-template batching, tenant quotas,
weighted fairness, and cross-template (projection) sharing.

PR 1's sharded :class:`~repro.core.runtime.AsyncQueryRuntime` gave every
query template its own lane, but all lanes still shared ONE global
:class:`~repro.core.strategies.BatchingStrategy` (so a single
:class:`~repro.core.strategies.AdaptiveCost` fit one blended cost model for
services whose templates have very different cost structures), one global
``max_pending`` bound, and strict round-robin over lanes.  This module is
the per-lane brain the runtime and the serving scheduler both consult:

* **Per-lane strategies.**  Each lane owns its strategy *instance*.  Cold
  lanes (few submissions) default to :class:`PureAsync` — a trickle never
  benefits from waiting, and a batch's fixed overhead is pure loss.  A lane
  crossing ``hot_threshold`` total submissions is promoted to a fresh
  instance from ``hot_factory`` (default :class:`AdaptiveCost`), which then
  learns THAT lane's fixed-vs-per-item cost model from that lane's own
  ``observe`` feedback.  ``overrides`` pins a specific lane to a specific
  strategy instance regardless of temperature.
* **Admission quotas.**  Instead of one global ``max_pending``, submission
  is bounded per tenant (``tenant_quotas`` / ``default_tenant_quota``) and
  per lane (``lane_quota``): a whale tenant flooding one template backs off
  at ITS bound while everyone else keeps submitting.
* **Weighted fairness.**  Lane service order is weighted fair queueing via
  per-lane virtual time: picking ``k`` requests from a lane advances its
  vtime by ``k / weight``, and the next pick goes to the backlogged lane
  with the smallest vtime.  A lane with weight 2 gets twice the service of
  a weight-1 lane under contention; new lanes join at the current minimum
  vtime so they neither starve nor monopolize.
* **Cross-template sharing** (SharedDB, "one thousand queries with one
  stone"): templates that differ only in *projection* are registered via
  :meth:`share` and canonicalized onto one shared lane.  The runtime
  executes the canonical (superset) query once; each handle applies its own
  projection at fan-out, so ``users.sel_name`` and ``users.sel_email`` for
  the same key cost ONE service round trip.
* **Auto-detected sharing** from query metadata: :meth:`describe` records
  which relation a template reads (``base``) and which ``columns`` it
  projects; :meth:`resolve` then derives the canonical template and the
  projector itself, so explicit :meth:`share` registration becomes
  optional.  An explicit ``share`` always wins over an auto-derived one.

The engine is deliberately runtime-agnostic: the
:class:`~repro.core.runtime.AsyncQueryRuntime` consults it under its own
lock, the :class:`~repro.serving.scheduler.ContinuousBatchingScheduler`
from its single-threaded tick loop, so every method here takes the policy's
own lock and strategy objects keep theirs.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, Mapping, Optional

from repro_torch.core.strategies import AdaptiveCost, BatchingStrategy, PureAsync

__all__ = ["LanePolicy", "PrefixIndex"]


class PrefixIndex:
    """Page-aligned token-prefix index for cross-request KV sharing.

    The prefix-granular generalization of :meth:`LanePolicy.share`'s
    exact-key machinery: where ``share`` canonicalizes whole templates
    that differ only in projection, ``PrefixIndex`` detects that a *new
    prompt* begins with the same tokens as KV already resident on some
    decode lane, so the engine can alias those page-aligned rows instead
    of recomputing them (SharedDB's global batch window applied to the
    prefill side of serving).

    An owner registers its (truncated) prompt with :meth:`insert`; every
    full-page prefix ``tokens[: k * page_size]`` becomes a lookup key.
    :meth:`lookup` returns ``(owner, k_pages)`` for the LONGEST
    registered full-page prefix of a candidate prompt that is *strictly
    proper* (``k * page_size < len(tokens)``): at least one novel token
    always remains, so the tail prefill that produces the request's first
    output token never degenerates to an empty scan.  Matching is exact
    token-tuple equality — positions are cache-relative (0-based after
    prompt truncation) on both sides, so identical token prefixes imply
    bit-identical KV rows under the same parameters and RoPE.

    Thread-safe (one lock), though the serving engine only consults it
    from the synchronous admission path.
    """

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        self._lock = threading.Lock()
        # owner -> registered full-page prefix tuples (for removal).
        self._owners: dict[Any, list[tuple]] = {}
        # full-page prefix tuple -> owner keys, insertion-ordered.
        self._index: dict[tuple, list] = {}
        self.hits = 0
        self.misses = 0

    def insert(self, key, tokens: Iterable[int]) -> None:
        """Register ``key`` as the resident owner of ``tokens``' KV."""
        toks = tuple(int(t) for t in tokens)
        ps = self.page_size
        prefixes = [toks[: k * ps] for k in range(1, len(toks) // ps + 1)]
        with self._lock:
            if key in self._owners:
                self._remove_locked(key)
            self._owners[key] = prefixes
            for pf in prefixes:
                self._index.setdefault(pf, []).append(key)

    def remove(self, key) -> None:
        """Forget ``key`` (its lane retired or its KV left the pool)."""
        with self._lock:
            self._remove_locked(key)

    def _remove_locked(self, key) -> None:
        for pf in self._owners.pop(key, ()):
            owners = self._index.get(pf)
            if owners is None:
                continue
            try:
                owners.remove(key)
            except ValueError:
                pass
            if not owners:
                del self._index[pf]

    def lookup(self, tokens: Iterable[int],
               exclude: Iterable = ()) -> Optional[tuple[Any, int]]:
        """Longest strictly-proper full-page prefix match, or ``None``.

        Returns ``(owner, k_pages)``; counts a hit/miss either way.
        ``exclude`` skips owners (e.g. a lane being replaced).
        """
        toks = tuple(int(t) for t in tokens)
        skip = set(exclude)
        ps = self.page_size
        kmax = (len(toks) - 1) // ps  # strictly proper: k*ps <= len-1
        with self._lock:
            for k in range(kmax, 0, -1):
                for owner in self._index.get(toks[: k * ps], ()):
                    if owner not in skip:
                        self.hits += 1
                        return owner, k
            self.misses += 1
            return None

    def __len__(self) -> int:
        """Number of registered owners."""
        return len(self._owners)


class LanePolicy:
    """Per-lane strategy selection + quotas + fairness + projection sharing.

    Parameters
    ----------
    cold_factory / hot_factory:
        Zero-arg callables producing a fresh strategy per lane.  Cold lanes
        (fewer than ``hot_threshold`` submissions) use ``cold_factory``
        (default ``PureAsync``); once promoted a lane gets its own
        ``hot_factory`` instance (default ``AdaptiveCost``) fed only by that
        lane's observations.
    hot_threshold:
        Total submissions after which a lane is considered hot.  ``0``
        makes every lane hot from the first submission.
    overrides:
        ``{lane: strategy_instance}`` — pins a lane to a given strategy
        regardless of temperature (e.g. force ``PureBatch`` for a
        report-generation template).
    lane_weights / default_weight:
        Weighted-fair-queueing weights; higher weight → proportionally more
        service under contention.
    tenant_quotas / default_tenant_quota:
        Max *outstanding* (submitted, unresolved) requests per tenant.
        ``tenant_quotas`` maps specific tenants; ``default_tenant_quota``
        applies to any other named tenant.  ``None`` disables the bound.
    lane_quota:
        Max outstanding requests per lane (any tenant), replacing the
        single global ``max_pending`` with per-template back-pressure.
    spill_budget / spill_budgets:
        Serving-side host-KV spill bounds: how many evicted-lane KV
        entries the engine's :class:`~repro.serving.engine.HostSpillPool`
        may hold per template (``spill_budgets`` names specific lanes,
        ``spill_budget`` is the default for the rest; ``None`` leaves the
        pool's own global bound as the only limit, ``0`` fences a lane
        out of the pool entirely).  Consumed via :meth:`spill_budget_for`
        — pass it as the pool's ``budget_for`` so spill residency follows
        the same per-lane policy as scheduling and KV reservations.
    """

    def __init__(
        self,
        cold_factory: Callable[[], BatchingStrategy] = PureAsync,
        hot_factory: Callable[[], BatchingStrategy] = AdaptiveCost,
        hot_threshold: int = 32,
        overrides: Optional[Mapping[str, BatchingStrategy]] = None,
        lane_weights: Optional[Mapping[str, float]] = None,
        default_weight: float = 1.0,
        tenant_quotas: Optional[Mapping[str, int]] = None,
        default_tenant_quota: Optional[int] = None,
        lane_quota: Optional[int] = None,
        max_lanes: int = 4096,
        spill_budget: Optional[int] = None,
        spill_budgets: Optional[Mapping[str, int]] = None,
    ):
        if hot_threshold < 0:
            raise ValueError("hot_threshold must be >= 0")
        if default_weight <= 0:
            raise ValueError("default_weight must be > 0")
        for lane, w in (lane_weights or {}).items():
            if w <= 0:
                raise ValueError(f"lane_weights[{lane!r}] must be > 0, got {w}")
        if max_lanes < 1:
            raise ValueError("max_lanes must be >= 1")
        if spill_budget is not None and spill_budget < 0:
            raise ValueError("spill_budget must be >= 0")
        for lane, b in (spill_budgets or {}).items():
            if b < 0:
                raise ValueError(f"spill_budgets[{lane!r}] must be >= 0, got {b}")
        self.cold_factory = cold_factory
        self.hot_factory = hot_factory
        self.hot_threshold = hot_threshold
        self.overrides = dict(overrides or {})
        self.lane_weights = dict(lane_weights or {})
        self.default_weight = default_weight
        self.tenant_quotas = dict(tenant_quotas or {})
        self.default_tenant_quota = default_tenant_quota
        self.lane_quota = lane_quota
        self.max_lanes = max_lanes
        self.spill_budget = spill_budget
        self.spill_budgets = dict(spill_budgets or {})

        self._lock = threading.Lock()
        self._strategies: dict[str, BatchingStrategy] = {}
        self._hot: set[str] = set()
        self._hot_inst: set[str] = set()  # lanes whose instance is hot_factory's
        self._submits: dict[str, int] = {}
        self._vtime: dict[str, float] = {}
        self._join_seq: dict[str, int] = {}  # deterministic vtime tie-break
        self._last_use: dict[str, int] = {}  # eviction order under max_lanes
        self._next_seq = 0
        self._use_seq = 0
        # projection sharing: variant template -> (canonical, projector)
        self._shared: dict[str, tuple[str, Callable[[Any], Any]]] = {}
        self._auto_shared: set[str] = set()  # derived (not explicit) entries
        self._auto_miss: set[str] = set()    # memoized "no superset" results
        # query metadata: template -> (base relation, columns | None=full row)
        self._meta: dict[str, tuple[str, Optional[tuple[str, ...]]]] = {}

    # -------------------------------------------------------- lane strategy
    def note_submit(self, lane: str) -> None:
        """Record one submission on ``lane`` (drives hot/cold promotion and
        the least-recently-used eviction order under ``max_lanes``)."""
        with self._lock:
            self._note_submit_locked(lane)

    def _note_submit_locked(self, lane: str) -> None:
        self._submits[lane] = self._submits.get(lane, 0) + 1
        self._use_seq += 1
        self._last_use[lane] = self._use_seq
        if len(self._submits) > self.max_lanes:
            self._evict_coldest_locked(keep=lane)

    def resolve_submit(self, query_name: str) -> tuple[str, Optional[Callable]]:
        """:meth:`resolve` + :meth:`note_submit` on the canonical lane in
        ONE lock acquisition — the policy-mode submit hot path.

        The two-call form took ``_lock`` twice per submit (resolve, then
        note); at 32 producers that is a second contended acquire for pure
        bookkeeping.  The fold notes the submission on the *canonical*
        lane (the lane the request actually runs on), which is also what
        the two-call form did.  Callers that shard lanes differently from
        the query name (``sharded=False`` compatibility mode) must keep
        using the two separate calls with their own lane key."""
        with self._lock:
            hit = self._resolve_locked(query_name)
            lane = query_name if hit is None else hit[0]
            self._note_submit_locked(lane)
        if hit is None:
            return query_name, None
        return hit

    def _evict_coldest_locked(self, keep: str) -> None:
        """Drop the least-recently-submitted lane's tracked state so
        high-cardinality template churn cannot grow the policy without
        bound (the runtime GCs its drained lanes for the same reason).
        Pinned (override) lanes are never evicted."""
        victims = sorted(
            (lk for lk in self._submits
             if lk != keep and lk not in self.overrides),
            key=lambda lk: self._last_use.get(lk, 0),
        )
        for lk in victims[: len(self._submits) - self.max_lanes]:
            for d in (self._submits, self._strategies, self._vtime,
                      self._join_seq, self._last_use):
                d.pop(lk, None)
            self._hot.discard(lk)
            self._hot_inst.discard(lk)

    def is_hot(self, lane: str) -> bool:
        """Whether ``lane`` has crossed ``hot_threshold`` submissions (and
        therefore owns — or is about to own — a ``hot_factory`` strategy
        instance).  Promotion is one-way."""
        with self._lock:
            return self._is_hot_locked(lane)

    def _is_hot_locked(self, lane: str) -> bool:
        if lane in self._hot:
            return True
        if self._submits.get(lane, 0) >= self.hot_threshold:
            self._hot.add(lane)  # promotion is one-way
            return True
        return False

    def strategy_for(self, lane: str) -> BatchingStrategy:
        """This lane's strategy instance (creating/promoting as needed).

        Promotion swaps the shared cold default for a fresh ``hot_factory``
        instance owned by this lane alone; the instance is stable from then
        on, so its learned state accumulates lane-local evidence only.
        """
        with self._lock:
            pinned = self.overrides.get(lane)
            if pinned is not None:
                return pinned
            cur = self._strategies.get(lane)
            if self._is_hot_locked(lane):
                if cur is None or lane not in self._hot_inst:
                    cur = self.hot_factory()
                    cur.reset()
                    self._strategies[lane] = cur
                    self._hot_inst.add(lane)
                return cur
            if cur is None:
                cur = self.cold_factory()
                cur.reset()
                self._strategies[lane] = cur
            return cur

    def observe(self, lane: str, batch_size: int, duration: float) -> None:
        """Route one service call's ``(batch_size, duration)`` to the lane's
        own model — evidence never crosses lanes."""
        self.strategy_for(lane).observe(batch_size, duration)

    def observe_decode(self, lane: str, duration: float) -> None:
        """Route one decode-tick duration to the lane's model (serving
        feedback: the steady-state per-token cost of this lane's class)."""
        self.strategy_for(lane).observe_decode(duration)

    def observe_abort(self, lane: str, duration: float, depth: int = 1) -> None:
        """Route one wasted speculative prefill (serving feedback: the
        scheduler dispatched ``duration`` seconds of prefill for this lane
        and aborted the bet ``depth`` tick boundaries after staging it) to
        the lane's own model, so a lane whose speculations keep missing
        batches later instead of speculating harder — deep-pipeline misses
        are charged proportionally harder (see
        :meth:`~repro.core.strategies.BatchingStrategy.observe_abort`)."""
        self.strategy_for(lane).observe_abort(duration, depth=depth)

    def observe_failure(self, lane: str, duration: float) -> None:
        """Route one failed service call (or serving submission) to the
        lane's own model: the wasted ``duration`` enters the lane's fixed
        cost as a failure penalty (see
        :meth:`~repro.core.strategies.BatchingStrategy.observe_failure`),
        so a flaky lane batches later while healthy lanes' models stay
        untouched."""
        self.strategy_for(lane).observe_failure(duration)

    # --------------------------------------------------------------- spill
    def spill_budget_for(self, lane: Optional[str]) -> Optional[int]:
        """Max host-spilled KV entries for ``lane`` — the named override,
        else the policy-wide ``spill_budget`` default (``None`` =
        pool-bounded only).  Shaped to plug straight into
        :class:`~repro.serving.engine.HostSpillPool` as ``budget_for``."""
        if lane is not None and lane in self.spill_budgets:
            return self.spill_budgets[lane]
        return self.spill_budget

    # ----------------------------------------------------- weighted fairness
    def weight(self, lane: str) -> float:
        """This lane's fair-share weight (``lane_weights`` entry or the
        ``default_weight``)."""
        return self.lane_weights.get(lane, self.default_weight)

    def lane_order(self, candidates: Iterable[str]) -> list[str]:
        """Candidates sorted by weighted-fair virtual time (lowest first,
        join order breaking ties).  New lanes join at the current minimum
        vtime over ALL tracked lanes — not just today's candidates — so a
        lane arriving while the busy lanes are momentarily drained cannot
        join at 0 and monopolize the picker once they refill."""
        with self._lock:
            cand = list(candidates)
            floor = min(self._vtime.values(), default=0.0)
            for c in cand:
                if c not in self._vtime:
                    self._vtime[c] = floor
                if c not in self._join_seq:
                    self._join_seq[c] = self._next_seq
                    self._next_seq += 1
            return sorted(cand, key=lambda c: (self._vtime[c], self._join_seq[c]))

    def lane_min(self, candidates: Iterable[str]) -> str:
        """The weighted-fair pick alone: the candidate with the smallest
        ``(vtime, join_seq)`` in ONE O(n) pass — what a ready-queue pop
        actually needs, without :meth:`lane_order`'s full sort.  New lanes
        join at the global vtime floor exactly as in ``lane_order``."""
        with self._lock:
            floor = min(self._vtime.values(), default=0.0)
            best_key = best = None
            for c in candidates:
                if c not in self._vtime:
                    self._vtime[c] = floor
                if c not in self._join_seq:
                    self._join_seq[c] = self._next_seq
                    self._next_seq += 1
                k = (self._vtime[c], self._join_seq[c])
                if best_key is None or k < best_key:
                    best_key, best = k, c
            if best is None:
                raise ValueError("lane_min needs at least one candidate")
            return best

    def charge(self, lane: str, n: int) -> None:
        """Account ``n`` picked requests against ``lane``'s fair share."""
        with self._lock:
            base = self._vtime.get(lane)
            if base is None:  # never ordered: join at the global floor
                base = min(self._vtime.values(), default=0.0)
            self._vtime[lane] = base + n / self.weight(lane)

    # -------------------------------------------------------------- quotas
    def tenant_quota(self, tenant: Optional[str]) -> Optional[int]:
        """Max outstanding requests for ``tenant`` (``None`` = unbounded;
        anonymous submissions are never tenant-bounded)."""
        if tenant is None:
            return None
        return self.tenant_quotas.get(tenant, self.default_tenant_quota)

    # ------------------------------------------------- cross-template share
    def share(self, canonical: str,
              projections: Mapping[str, Callable[[Any], Any]]) -> None:
        """Register templates that differ from ``canonical`` only in
        projection.  ``projections[variant]`` maps the canonical query's
        (superset) result to the variant's result.  Subsequent submissions
        of a variant run on the canonical lane and project at fan-out.

        Explicit registration always wins: it silently replaces an
        auto-derived share (see :meth:`describe`), and only conflicts with
        a *different* explicit canonical raise."""
        with self._lock:
            for variant, proj in projections.items():
                if variant == canonical:
                    raise ValueError(f"variant {variant!r} equals its canonical")
                existing = self._shared.get(variant)
                if (existing is not None and existing[0] != canonical
                        and variant not in self._auto_shared):
                    raise ValueError(
                        f"{variant!r} already shared onto {existing[0]!r}")
                self._shared[variant] = (canonical, proj)
                self._auto_shared.discard(variant)

    def describe(self, template: str, *, base: str,
                 columns: Optional[Iterable[str]] = None) -> None:
        """Record query metadata for auto-detected projection sharing.

        ``base`` names the relation/predicate signature the template reads
        (templates are projection-compatible only within one ``base``);
        ``columns`` lists the projected columns, ``None`` meaning the full
        row (the superset query).  By convention a single-column template
        returns the bare column value and a multi-column (or full-row)
        template returns a mapping — the projectors :meth:`resolve` derives
        follow that convention, so ``policy.share`` registration becomes
        optional for described templates.  Explicit ``share`` still wins.
        """
        with self._lock:
            cols = None if columns is None else tuple(columns)
            self._meta[template] = (base, cols)
            # Metadata changed: previously derived routings (and memoized
            # misses) may now be stale (e.g. a fuller superset appeared) —
            # rederive lazily.
            for variant in list(self._auto_shared):
                del self._shared[variant]
            self._auto_shared.clear()
            self._auto_miss.clear()

    def _auto_resolve_locked(self, template: str) -> Optional[tuple]:
        """Derive ``(canonical, projector)`` for a described template, or
        None.  The canonical is the described template over the same base
        with the WIDEST covering column set (full row — ``columns=None`` —
        widest of all), so every variant of a base converges on the same
        shared lane; name breaks ties deterministically."""
        meta = self._meta.get(template)
        if meta is None:
            return None
        base, cols = meta
        if cols is None:
            return None  # already the superset query: nothing to derive
        want = set(cols)
        best = None  # (width, name) — width: #columns, inf for full row
        for other, (obase, ocols) in self._meta.items():
            if other == template or obase != base:
                continue
            if ocols is None:
                width = float("inf")
            elif want <= set(ocols) and len(ocols) > len(cols):
                width = len(ocols)
            else:
                continue
            if (best is None or width > best[0]
                    or (width == best[0] and other < best[1])):
                best = (width, other)
        if best is None:
            return None
        canonical = best[1]
        if len(cols) == 1:
            col = cols[0]
            projector = lambda row, _c=col: row[_c]  # noqa: E731
        else:
            projector = lambda row, _cs=cols: {c: row[c] for c in _cs}  # noqa: E731
        self._shared[template] = (canonical, projector)
        self._auto_shared.add(template)
        return canonical, projector

    def resolve(self, query_name: str) -> tuple[str, Optional[Callable]]:
        """``(canonical_query, projector | None)`` for a submission —
        explicit ``share`` registrations first, then auto-derived routings
        from :meth:`describe` metadata.  Both hits and "no superset"
        misses are memoized (invalidated by :meth:`describe`), so this
        stays O(1) under the policy lock on the submit hot path.  Submit
        paths that also call :meth:`note_submit` should use
        :meth:`resolve_submit` instead (one lock acquisition, not two)."""
        with self._lock:
            hit = self._resolve_locked(query_name)
        if hit is None:
            return query_name, None
        return hit

    def _resolve_locked(self, query_name: str) -> Optional[tuple]:
        """Shared-routing lookup under ``_lock``: ``(canonical, projector)``
        or ``None`` for an unshared template."""
        hit = self._shared.get(query_name)
        if (hit is None and self._meta
                and query_name not in self._auto_miss):
            hit = self._auto_resolve_locked(query_name)
            if hit is None and query_name in self._meta:
                # Memoize "described but no covering superset" so the
                # O(|meta|) scan runs once, not per submit.  Undescribed
                # templates are O(1) rejects and need no entry, which
                # keeps this set bounded by len(_meta).
                self._auto_miss.add(query_name)
        return hit

    # ---------------------------------------------------------------- stats
    def snapshot(self) -> dict:
        """Introspection: per-lane temperature, submissions, vtime, strategy."""
        with self._lock:
            lanes = {}
            for lane in set(self._submits) | set(self._strategies) | set(self._vtime):
                strat = self.overrides.get(lane) or self._strategies.get(lane)
                lanes[lane] = {
                    "hot": lane in self._hot,
                    "submits": self._submits.get(lane, 0),
                    "vtime": self._vtime.get(lane, 0.0),
                    "weight": self.weight(lane),
                    "strategy": type(strat).__name__ if strat else None,
                }
            return {
                "hot_threshold": self.hot_threshold,
                "lane_quota": self.lane_quota,
                "shared_templates": {v: c for v, (c, _) in self._shared.items()},
                "lanes": lanes,
            }

    def __repr__(self) -> str:
        return (f"LanePolicy(hot_threshold={self.hot_threshold}, "
                f"lane_quota={self.lane_quota}, "
                f"tenants={sorted(self.tenant_quotas) or None}, "
                f"shared={len(self._shared)})")
