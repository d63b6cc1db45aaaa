"""Paged KV cache: fixed-size pages, block tables, paged decode compute.

Port of :mod:`repro.serving.paged_kv`.  :class:`PagedKVPool` (refcounted
physical pages and per-request block tables) and :class:`PagedKVView`
(the page-budget-bounded :class:`~repro_torch.serving.kv.KVView`) are
copies of the reference's pure-Python classes.

:class:`PagedInferenceEngine` ports the whole reference engine.  For
architectures paged decode covers (:func:`~repro_torch.models.paged_decode.
supports_paged_decode`: full-context dense/MoE stacks) KV lives only in
shared page arrays ``(L, n_pages + 1, page_size, Hkv, hd)`` on the
device, and every decode tick grows block tables, uploads them and runs
:func:`~repro_torch.models.paged_decode.paged_decode_step`, whose
attention is the ``paged_decode_attention`` CUDA kernel on the card.
Physical slot ``n_pages`` is the trash page inactive lanes write into; no
block table references it and the pool never allocates it.  On top:

* **oversubscription**: ``n_pages`` below ``n_lanes * max_len /
  page_size`` admits on instantaneous page budgets; growth past the
  pool's capacity evicts the least-recently-touched lane to the host
  spill pool (``page_evictions``) and tells the scheduler through
  ``on_lane_evicted`` / :meth:`PagedInferenceEngine.drain_evictions`;
* **spill/restore/commit** move only the pages a lane fills, through
  arbitrary frames: spill copies ``ceil(length / page_size)`` pages to
  CPU tensors, restore splices the first ``prefetch_pages`` and queues
  the tail for the next tick; a lane whose leading pages another lane
  aliases leaves them resident (**partial eviction**);
* **prefix sharing** (``prefix_share=True``): synchronous admission
  aliases the page-aligned prompt prefix a resident lane already holds
  and computes only the novel tail (``_shared_tail``: the aliased pages
  gathered into a dense batch-1 cache, the tail fed through the decode
  path, whose attention is the ``decode_attention`` kernel);
* **fused chunk ticks** (reference ``_fused``, ``stage_chunk``): the next
  decode tick runs a staged prefill's next chunk through the decode path
  beside the paged batch and counts both as **one** dispatch, as the
  reference counts its one fused program.  The chunk side runs on the
  main stream after waiting for the staged prefill's event.

Architectures paged decode cannot cover (SSM and hybrid state, sliding
windows) keep the reference's dense-compute mode: the per-lane cache
stays, page frames are the identity (``lane * pages_per_lane + j``),
motion is page-granular and each tick runs the dense decode step.

Unlike the reference, which rebuilds its arrays functionally each step,
the port updates them **in place** (``index_put_`` for scatters and
splices, ``copy_`` for a copy-on-write fork), and its lane state
(``lengths``, ``last_token``) lives on the host as numpy arrays.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.lane_policy import PrefixIndex
from repro_torch.models.paged_decode import (
    paged_decode_step,
    sample_tokens,
    supports_paged_decode,
)
from repro_torch.serving.engine import (
    InferenceEngine,
    KVPartition,
    StagedPrefill,
    _tensors,
)

__all__ = ["PagedInferenceEngine", "PagedKVPool", "PagedKVView"]


class PagedKVPool:
    """Refcounted physical pages + per-request block tables.

    Pure bookkeeping: the pool tracks which physical page backs each
    logical slot of each table, not the page contents (those live in
    whatever array the caller pages — the engine's page arrays, a host
    buffer).  ``alloc_table(key, pages=...)`` claims *specific* free
    pages (the dense-compute engine's identity frames);
    ``alloc_table(key, n=...)`` takes any ``n`` free pages, evicting
    least-recently-used unpinned tables to :attr:`host_tables` (or the
    ``on_evict`` callback) when the free list runs dry.  Pages are
    refcounted so :meth:`share` can alias a prefix across tables; a page
    returns to the free list only when its last table drops it.
    """

    def __init__(self, n_pages: int, page_size: int,
                 on_evict: Optional[Callable[[object, list[int]], None]] = None):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self.on_evict = on_evict
        self._free: list[int] = list(range(n_pages))
        self._ref = [0] * n_pages
        self._tables: "OrderedDict[object, list[int]]" = OrderedDict()
        self._pinned: set = set()
        self.host_tables: dict[object, list[int]] = {}
        self.evicted = 0

    # ------------------------------------------------------------- capacity
    @property
    def n_free_pages(self) -> int:
        """Pages on the free list right now (eviction can raise this)."""
        return len(self._free)

    def pages_for(self, length: int) -> int:
        """Pages needed to hold ``length`` token rows (0 for 0)."""
        return -(-length // self.page_size)

    # --------------------------------------------------------------- tables
    def has_table(self, key) -> bool:
        """Whether ``key`` currently owns a block table."""
        return key in self._tables

    def table(self, key) -> tuple[int, ...]:
        """``key``'s physical pages in logical-slot order (LRU-touching)."""
        self._tables.move_to_end(key)
        return tuple(self._tables[key])

    def pages(self, key) -> tuple[int, ...]:
        """``key``'s physical pages WITHOUT touching LRU order — for bulk
        snapshots (device block tables each tick) that must not mask the
        recency signal eviction relies on."""
        return tuple(self._tables[key])

    def lru_tables(self) -> list:
        """Table keys from least- to most-recently touched (victim scan)."""
        return list(self._tables)

    def block_table(self, key, max_pages: int) -> np.ndarray:
        """``key``'s table as a fixed-width int32 row, padded with page 0
        (padding slots are masked by length, never read — the layout the
        paged attention kernel consumes)."""
        pages = self.table(key)
        out = np.zeros((max_pages,), np.int32)
        out[: len(pages)] = pages
        return out

    def alloc_table(self, key, n: Optional[int] = None,
                    pages: Optional[list[int]] = None) -> list[int]:
        """Create ``key``'s table from ``n`` free pages (any; LRU-evicting
        on pressure) or the explicitly named free ``pages``."""
        if key in self._tables:
            raise ValueError(f"table {key!r} already allocated")
        got = self._claim(n, pages)
        self._tables[key] = got
        return list(got)

    def extend_table(self, key, n: Optional[int] = None,
                     pages: Optional[list[int]] = None) -> list[int]:
        """Append pages to ``key``'s table (decode crossed a boundary)."""
        new = self._claim(n, pages)
        self._tables[key].extend(new)
        self._tables.move_to_end(key)
        return new

    def free_table(self, key) -> None:
        """Drop ``key``'s table; pages with no remaining owner are freed."""
        self._pinned.discard(key)
        for p in self._tables.pop(key):
            self._decref(p)

    def adopt_table(self, key, pages: list[int]) -> None:
        """Create ``key``'s table from pages the caller already holds a
        reference on (a spill entry's prefix hold): ownership of exactly
        one reference per page TRANSFERS into the table — no incref, no
        claim.  The refcount-transfer twin of :meth:`alloc_table`."""
        if key in self._tables:
            raise ValueError(f"table {key!r} already allocated")
        for p in pages:
            if self._ref[p] <= 0:
                raise RuntimeError(
                    f"page {p} is free; cannot adopt an unreferenced page")
        self._tables[key] = list(pages)

    def share(self, src, dst, n_pages: Optional[int] = None) -> list[int]:
        """Alias ``src``'s first ``n_pages`` pages (default: all) under a
        new table ``dst`` — prefix-granular sharing: every aliased page's
        refcount rises, nothing is copied.  The caller typically extends
        ``dst`` with private tail pages afterwards
        (:meth:`extend_table`); a write into an aliased page must fork it
        first (:meth:`fork_page` — copy-on-write)."""
        if dst in self._tables:
            raise ValueError(f"table {dst!r} already allocated")
        pages = list(self._tables[src])
        if n_pages is not None:
            if not 0 <= n_pages <= len(pages):
                raise ValueError(
                    f"share of {n_pages} pages but {src!r} has {len(pages)}")
            pages = pages[:n_pages]
        for p in pages:
            self._ref[p] += 1
        self._tables[dst] = pages
        return list(pages)

    def page_ref(self, p: int) -> int:
        """Physical page ``p``'s current refcount (0 = on the free list)."""
        return self._ref[p]

    def shared_prefix_pages(self, key) -> int:
        """How many LEADING pages of ``key``'s table are aliased by
        another live owner (refcount above 1).  Aliased pages always form
        a prefix — :meth:`share` copies a table head and a fork replaces
        the writer's page, never a reader's — so this is the page count
        partial eviction keeps resident."""
        n = 0
        for p in self._tables[key]:
            if self._ref[p] > 1:
                n += 1
            else:
                break
        return n

    def fork_page(self, key, slot: int) -> Optional[tuple[int, int]]:
        """Copy-on-write fork: give ``key`` a private page at logical
        ``slot`` before a write would be visible to the other readers of
        a shared page.  Returns ``(old_page, new_page)`` — the caller
        copies the page CONTENTS old → new (the pool tracks placement
        only) — or ``None`` when the page is already private.  Needs a
        free page (the caller makes room first); the shared page keeps
        its remaining readers untouched."""
        pages = self._tables[key]
        old = pages[slot]
        if self._ref[old] <= 1:
            return None
        if not self._free:
            raise RuntimeError(
                "KV pool out of pages: no free page for a copy-on-write fork")
        new = self._free.pop(0)
        self._ref[new] = 1
        self._ref[old] -= 1  # stays >= 1: the other readers still hold it
        pages[slot] = new
        self._tables.move_to_end(key)
        return old, new

    def incref_pages(self, pages: list[int]) -> None:
        """Take one extra reference on each (live) page — how a host
        spill entry keeps a shared prefix resident while its reader is
        evicted (partial eviction)."""
        for p in pages:
            if self._ref[p] <= 0:
                raise RuntimeError(
                    f"page {p} is free; cannot reference a free page")
        for p in pages:
            self._ref[p] += 1

    def decref_pages(self, pages: list[int]) -> None:
        """Release references taken by :meth:`incref_pages` (a dropped
        spill entry's prefix hold); pages reaching zero return to the
        free list.  Double-frees raise instead of corrupting the pool."""
        for p in pages:
            self._decref(p)

    def pin(self, key) -> None:
        """Exempt ``key`` from OOM eviction (an active decode lane)."""
        self._pinned.add(key)

    def unpin(self, key) -> None:
        """Make ``key`` evictable again."""
        self._pinned.discard(key)

    def snapshot(self) -> dict:
        """Occupancy + eviction counters (introspection/benchmarks)."""
        return {"free_pages": len(self._free), "tables": len(self._tables),
                "evicted": self.evicted, "host_tables": len(self.host_tables)}

    # ------------------------------------------------------------- internals
    def _claim(self, n: Optional[int], pages: Optional[list[int]]) -> list[int]:
        if (n is None) == (pages is None):
            raise ValueError("pass exactly one of n= / pages=")
        if pages is not None:
            for p in pages:
                if self._ref[p] != 0:
                    raise ValueError(f"page {p} is not free")
                self._free.remove(p)
                self._ref[p] = 1
            return list(pages)
        while len(self._free) < n:
            self._evict_one()
        got = [self._free.pop(0) for _ in range(n)]
        for p in got:
            self._ref[p] = 1
        return got

    def _evict_one(self) -> None:
        for key in self._tables:  # OrderedDict order == LRU
            if key in self._pinned:
                continue
            pages = self._tables[key]
            if any(self._ref[p] > 1 for p in pages):
                # A live alias group references this table's pages: a
                # whole-table spill would snapshot rows another reader is
                # still extending from.  Skip it — partial eviction at the
                # engine layer spills only the unshared tail.
                continue
            self._tables.pop(key)
            self.evicted += 1
            if self.on_evict is not None:
                self.on_evict(key, list(pages))
            else:
                self.host_tables[key] = list(pages)
            for p in pages:
                self._decref(p)
            return
        raise RuntimeError(
            "KV pool out of pages: every table is pinned or aliased by a "
            "live table")

    def _decref(self, p: int) -> None:
        if self._ref[p] <= 0:
            raise RuntimeError(f"page {p} is already free (double free)")
        self._ref[p] -= 1
        if self._ref[p] == 0:
            self._free.append(p)


class PagedKVView:
    """:class:`~repro.serving.kv.KVView` over (lane partition, page pool).

    Allocation units stay lanes — per-template reservations, ``benefits``
    and the free-lane snapshot all delegate to the dense
    :class:`KVPartition` — but every capacity read is additionally
    min-bounded by the page budget: a free lane is only admissible if the
    pool could still back a full lane's worth of pages for it.  With a
    fully-provisioned pool (``n_pages = n_lanes * pages_per_lane``) the
    bound is never the binding constraint, so paged admission behaves
    exactly like dense admission; an **oversubscribed** pool
    (``n_pages`` below that) admits on instantaneous free-page budgets
    and relies on the engine's mid-decode eviction for growth pressure.

    ``page_quota`` (template → guaranteed pages, derived from the
    partition's lane shares) carries reservations to page granularity:
    :meth:`n_free_for` subtracts every OTHER template's unmet quota from
    the free-page budget before bounding, so a shared-pool burst cannot
    consume the pages a reserved template is owed.  ``used_pages`` is the
    engine callback reporting a template's currently-held pages.
    """

    def __init__(self, partition: KVPartition, pool: PagedKVPool,
                 pages_per_lane: int,
                 page_quota: Optional[dict] = None,
                 used_pages: Optional[Callable[[Optional[str]], int]] = None):
        self.partition = partition
        self.pool = pool
        self.pages_per_lane = pages_per_lane
        self.page_quota = dict(page_quota or {})
        self.used_pages = used_pages

    @property
    def _page_bound(self) -> int:
        return self.pool.n_free_pages // self.pages_per_lane

    def _quota_bound(self, template: Optional[str]) -> int:
        """Free-lane bound after honoring other templates' page quotas."""
        free = self.pool.n_free_pages
        if self.page_quota and self.used_pages is not None:
            owed = sum(max(0, q - self.used_pages(t))
                       for t, q in self.page_quota.items() if t != template)
            free = max(0, free - owed)
        return free // self.pages_per_lane

    @property
    def n_free(self) -> int:
        """Free lanes, min-bounded by whole-lane page budgets."""
        return min(self.partition.n_free, self._page_bound)

    def n_free_for(self, template: Optional[str]) -> int:
        """Free lanes ``template`` may take, page-budget- and
        page-quota-bounded."""
        return min(self.partition.n_free_for(template),
                   self._quota_bound(template))

    def alloc(self, template: Optional[str]) -> int:
        """Take one lane for ``template`` (reserved pool first)."""
        return self.partition.alloc(template)

    def release(self, lane: int) -> None:
        """Return a lane to its home pool."""
        self.partition.release(lane)

    def benefits(self, lane: int, template: Optional[str]) -> bool:
        """Whether releasing ``lane`` raises ``n_free_for(template)``."""
        return self.partition.benefits(lane, template)

    def quarantine(self, lane: int) -> None:
        """Hold a crashed lane out of circulation (crash recovery)."""
        self.partition.quarantine(lane)

    def unquarantine(self, lane: int) -> None:
        """Return a quarantined lane to its home pool."""
        self.partition.unquarantine(lane)

    @property
    def quarantined(self) -> frozenset:
        """Snapshot of lanes currently held out of circulation."""
        return self.partition.quarantined

    @property
    def free_lanes(self) -> list[int]:
        """Sorted snapshot of every free lane (introspection)."""
        return self.partition.free_lanes


@dataclasses.dataclass
class PagedInferenceEngine(InferenceEngine):
    """Serving engine with paged KV compute and motion (module docstring).

    ``page_size`` must divide ``max_len``; ``prefetch_pages`` is how many
    pages a restore splices synchronously before resuming decode (the
    tail lands before the next tick).  ``n_pages`` sizes the physical
    pool: by default ``n_lanes * max_len / page_size`` (full
    provisioning); smaller values oversubscribe (paged-compute archs
    only) and lean on mid-decode eviction.  ``prefix_share``
    (paged-compute only) turns on prefix-granular cross-request KV
    sharing: synchronous admission consults a
    :class:`~repro_torch.core.lane_policy.PrefixIndex`, aliases the
    page-aligned prompt prefix a resident lane already computed
    (copy-on-write, zero bytes moved) and prefills only the novel tail;
    ``prefix_hits`` / ``prefill_flops_saved`` count the wins.

    The reference's ``use_kernel`` and ``interpret`` are left out: the
    port dispatches each op by its operands' device (the CUDA kernel on
    the card, the plain version on the CPU) and never falls back.
    """

    page_size: int = 16
    prefetch_pages: int = 2
    n_pages: Optional[int] = None
    prefix_share: bool = False

    def __post_init__(self):
        super().__post_init__()
        if self.max_len % self.page_size:
            raise ValueError("page_size must divide max_len")
        if self.prefetch_pages < 1:
            raise ValueError("prefetch_pages must be >= 1")
        self.pages_per_lane = self.max_len // self.page_size
        self.paged_compute = supports_paged_decode(self.arch.cfg)
        full = self.n_lanes * self.pages_per_lane
        if self.n_pages is None:
            self.n_pages = full
        if self.n_pages != full and not self.paged_compute:
            raise ValueError(
                "n_pages decoupled from n_lanes * max_len / page_size needs "
                "a paged-decode-capable arch (dense/MoE, full context)")
        if self.n_pages < self.pages_per_lane:
            raise ValueError(
                "n_pages must cover at least one lane "
                f"({self.pages_per_lane} pages)")
        self.pool = PagedKVPool(self.n_pages, self.page_size)
        quota = None
        if self.paged_compute and self.partition.shares:
            quota = {t: k * self.n_pages // self.n_lanes
                     for t, k in self.partition.shares.items()}
        self._kv_view = PagedKVView(self.partition, self.pool,
                                    self.pages_per_lane, page_quota=quota,
                                    used_pages=self._pages_used_by)
        # lane -> (host rows, start_row, stop_row, base_row): restore tails
        # not yet on the device; flushed before the next decode step.
        self._pending_restore: dict[int, tuple] = {}
        # lane -> (request key, template): identity for mid-decode eviction
        # and page-quota accounting.
        self._lane_meta: dict[int, tuple] = {}
        # (lane, key, template, spilled) records for drain_evictions(); a
        # registered on_lane_evicted callback bypasses the list.
        self._evicted: list[tuple] = []
        self.on_lane_evicted: Optional[Callable] = None
        self.page_evictions = 0   # lanes evicted by page pressure
        self.fused_folds = 0      # prefill chunks folded into decode ticks
        self._fused_chunk: Optional[StagedPrefill] = None
        # Per-lane sampling params for the cross-template decode megabatch
        # (temperature 0 = greedy argmax).
        self.lane_temps = np.zeros((self.n_lanes,), np.float32)
        self.lane_seeds = np.zeros((self.n_lanes,), np.int32)
        if self.prefix_share and not self.paged_compute:
            raise ValueError(
                "prefix_share needs a paged-decode-capable arch "
                "(dense/MoE, full context)")
        self.prefix_index: Optional[PrefixIndex] = (
            PrefixIndex(self.page_size) if self.prefix_share else None)
        self.prefix_hits = 0
        self.prefill_flops_saved = 0
        self.prefill_flops_total = 0
        # The analytic per-token forward FLOPs (2 * parameters) turn pages
        # aliased instead of prefilled into prefill_flops_saved.
        self._flops_per_token = 2 * sum(
            int(a.numel()) for a in _tensors(self.params))
        if not self.paged_compute:
            return  # dense-compute: the per-lane cache stays, identity frames
        # Partial eviction leaves refcounted prefix pages resident while
        # their spill entry lives on the host; if the spill pool drops the
        # entry, those holds must be released or the pages leak.
        spill = self.partition.spill
        if spill is not None and getattr(spill, "on_drop", None) is None:
            spill.on_drop = self._release_entry_holds
        # Replace the dense per-lane store with shared page arrays
        # (L, n_pages + 1, page_size, Hkv, hd); slot n_pages is the trash page.
        P, ps = self.n_pages + 1, self.page_size
        self.cache = {
            name: {key: torch.zeros((a.shape[0], P, ps) + tuple(a.shape[3:]),
                                    dtype=a.dtype, device=a.device)
                   for key, a in stack.items()}
            for name, stack in self.cache.items()}

    @property
    def kv(self) -> PagedKVView:
        """The page-budget-bounded :class:`~repro_torch.serving.kv.KVView`."""
        return self._kv_view

    # ---------------------------------------------------------- page frames
    def _frames(self, lane: int, start: int, stop: int) -> list[int]:
        """Identity physical frames for ``lane``'s logical pages [start,
        stop): dense-compute mode only, where page ``j`` of lane ``L``
        lives in frame ``L * pages_per_lane + j``."""
        base = lane * self.pages_per_lane
        return [base + j for j in range(start, stop)]

    def _seq_leaf(self, dst) -> bool:
        # KV leaves carry the sequence axis at position 2 ((L, B, S, H, d));
        # SSM state (L, B, H, P, N) and conv tails (L, B, K-1, Ch) do not
        # and always move whole.
        return dst.ndim >= 3 and dst.shape[2] == self.max_len

    def _pages_used_by(self, template: Optional[str]) -> int:
        """Physical pages currently held by ``template``'s lanes (the
        page-quota accounting hook the :class:`PagedKVView` consults)."""
        return sum(len(self.pool.pages(lane))
                   for lane, (_key, t) in self._lane_meta.items()
                   if t == template and self.pool.has_table(lane))

    def _open_table(self, lane: int, length: int, avoid=frozenset()) -> None:
        """(Re)create ``lane``'s pinned block table covering ``length``
        written rows plus the next write position.  Paged-compute mode
        takes any free frames (evicting other lanes under pressure, never
        one in ``avoid``); dense-compute mode uses identity frames."""
        n = min(self.pages_per_lane, length // self.page_size + 1)
        if self.paged_compute:
            self._make_room(n, avoid=set(avoid) | {lane})
            self.pool.alloc_table(lane, n=n)
        else:
            self.pool.alloc_table(lane, pages=self._frames(lane, 0, n))
        self.pool.pin(lane)

    def _ensure_pages(self, lane: int, n: int) -> None:
        n = min(n, self.pages_per_lane)
        have = len(self.pool.table(lane))
        if n > have:
            if self.paged_compute:
                self._make_room(n - have, avoid={lane})
                self.pool.extend_table(lane, n=n - have)
            else:
                self.pool.extend_table(lane, pages=self._frames(lane, have, n))

    # --------------------------------------------------- page-pressure evict
    def _make_room(self, need: int, avoid=frozenset()) -> None:
        """Free pages until ``need`` are available, spilling the least-
        recently-touched lanes (their decode resumes after a restore).
        Raises when every table belongs to ``avoid`` (the requesting
        lanes themselves)."""
        while self.pool.n_free_pages < need:
            victim = next((k for k in self.pool.lru_tables()
                           if k not in avoid), None)
            if victim is None:
                raise RuntimeError(
                    "KV pool out of pages: every table is pinned by the "
                    "lanes requesting growth")
            self._evict_lane(int(victim))

    def _evict_lane(self, lane: int) -> None:
        """Spill one active lane to the host under page pressure and
        record the eviction for the scheduler (callback or drain list)."""
        key, template = self._lane_meta.get(lane, (lane, None))
        spilled = self.spill(lane, key, template)
        self.page_evictions += 1
        cb = self.on_lane_evicted
        if cb is not None:
            cb(lane, key, template, spilled)
        else:
            self._evicted.append((lane, key, template, spilled))

    def drain_evictions(self) -> list[tuple]:
        """Return and clear the ``(lane, key, template, spilled)`` records
        of page-pressure evictions since the last drain.  A scheduler that
        registered :attr:`on_lane_evicted` is told at eviction time
        instead and never sees these."""
        out, self._evicted = self._evicted, []
        return out

    # ------------------------------------------------------------ admission
    def _prompt(self, r) -> np.ndarray:
        return np.asarray(r.prompt)[-self.max_prompt_len:]

    def admit(self, requests, template: Optional[str] = None
              ) -> tuple[int, int]:
        """Admission with prefix-granular sharing (when enabled).

        Runs only on the synchronous admission path: the speculation
        thread keeps the plain batched prefill, so the prefix index and
        the page pool are never touched concurrently.  Requests whose
        prompts match no resident prefix are prefilled as one batch first
        (registering their prompts); then each remaining request checks
        the index again, so a batch holding an owner and its sharers still
        shares, and takes the alias path (:meth:`_admit_prefix_hit`) or
        joins a last miss batch."""
        if self.prefix_index is None or not requests:
            return super().admit(requests, template)
        self._check_prompts(requests)  # the hits' tails skip prefill_dispatch
        assert len(requests) <= self.n_free_for(template), \
            "admit() caller must respect n_free_for(template)"
        # A probe index over this batch's own prompts catches sharers whose
        # owner arrives in the same batch (resident once the misses commit).
        probe = PrefixIndex(self.page_size)
        misses, deferred = [], []
        for r in requests:
            toks = tuple(int(t) for t in self._prompt(r))
            if (self._prefix_match(r) is not None
                    or probe.lookup(toks) is not None):
                deferred.append(r)
            else:
                probe.insert(id(r), toks)
                misses.append(r)
        shape = (len(requests), 0)
        if misses:
            shape = super().admit(misses, template)
        late = []
        for r in deferred:
            hit = self._prefix_match(r)
            if hit is None:  # the owner left between the two phases
                late.append(r)
            else:
                self._admit_prefix_hit(r, template, *hit)
        if late:
            shape = super().admit(late, template)
        return shape

    def _prefix_match(self, r) -> Optional[tuple[int, int]]:
        """``(owner_lane, k_pages)`` for the longest resident page-aligned
        prefix of ``r``'s (truncated) prompt, or ``None``.  Stale index
        owners (no live table) are pruned on sight."""
        toks = tuple(int(t) for t in self._prompt(r))
        while True:
            hit = self.prefix_index.lookup(toks)
            if hit is None:
                return None
            owner, k = hit
            if (self.pool.has_table(owner)
                    and len(self.pool.pages(owner)) >= k):
                return owner, k
            self.prefix_index.remove(owner)

    def _shared_tail(self, prefix_idx: torch.Tensor, tail: np.ndarray,
                     start: int):
        """Prefix-hit tail prefill: gather the aliased pages
        ``prefix_idx`` into a zeroed dense batch-1 cache of ``max_len``
        rows, then feed the novel ``tail`` (1, T) through the decode path
        (:meth:`_extend`) from position ``start``, computing exactly the
        positions the alias did not cover.  Returns (the last position's
        logits (1, V), the dense cache)."""
        dcache = {}
        for name, stack in self.cache.items():
            dcache[name] = {}
            for key, a in stack.items():
                pre = a[:, prefix_idx].reshape(a.shape[0], 1, -1, *a.shape[3:])
                dense = torch.zeros((a.shape[0], 1, self.max_len) + tuple(a.shape[3:]),
                                    dtype=a.dtype, device=a.device)
                dense[:, :, : pre.shape[2]] = pre
                dcache[name][key] = dense
        logits, dcache, _ = self._extend(
            dcache, tail, torch.tensor([start], dtype=torch.int32, device=self.device))
        return logits, dcache

    def _admit_prefix_hit(self, r, template: Optional[str],
                          owner: int, k: int) -> None:
        """Admit one request by aliasing ``k`` prefix pages from ``owner``
        and prefilling only the novel tail.

        The aliased pages are full prompt pages on both sides (the index
        matches only ``k * page_size < plen``), their contents a function
        of the shared tokens and positions alone: the alias is exact, moves
        zero bytes and saves ``k * page_size`` positions of prefill FLOPs.
        Decode writes land at positions ``>= plen``, in the request's
        private tail pages; the copy-on-write guard in
        :meth:`decode_tick` enforces this anyway."""
        prompt = self._prompt(r)
        plen = len(prompt)
        ps = self.page_size
        shared_rows = k * ps
        lane = self.partition.alloc(template)
        total = min(self.pages_per_lane, plen // ps + 1)
        need = total - k
        if need > 0:
            self._make_room(need, avoid={lane, owner})
        self.pool.share(owner, lane, n_pages=k)
        if need > 0:
            self.pool.extend_table(lane, n=need)
        self.pool.pin(lane)
        self._lane_meta[lane] = (getattr(r, "rid", lane), template)
        pages = self.pool.pages(lane)
        logits, dcache = self._shared_tail(
            torch.as_tensor(pages[:k], device=self.device),
            np.ascontiguousarray(prompt[None, shared_rows:], np.int32), shared_rows)
        self._count_dispatch()
        # Scatter only the tail pages into their frames; the k aliased
        # pages cost zero bytes by construction.
        npg = max(1, self.pool.pages_for(plen))
        if npg > k:
            idx = torch.as_tensor(pages[k:npg], device=self.device)
            for name, stack in self.cache.items():
                for key, dst in stack.items():
                    s = dcache[name][key][:, 0, k * ps: npg * ps]
                    dst[:, idx] = s.reshape(s.shape[0], npg - k, ps,
                                            *s.shape[2:]).to(dst.dtype)
            for a in _tensors(dcache):
                self.kv_bytes_moved += (a.element_size() * a.shape[0]
                                        * (npg - k) * ps * math.prod(a.shape[3:]))
        self.prefix_index.insert(lane, prompt)
        first = int(logits.argmax(dim=-1)[0])
        r.lane = lane
        r.generated.append(first)
        self.lengths[lane] = plen
        self.last_token[lane] = first
        self.active[lane] = True
        self.lane_temps[lane] = getattr(r, "temperature", 0.0)
        self.lane_seeds[lane] = getattr(r, "sample_seed", 0)
        self.prefill_calls += 1
        self.prefix_hits += 1
        self.prefill_flops_saved += shared_rows * self._flops_per_token
        self.prefill_flops_total += plen * self._flops_per_token

    def _release_entry_holds(self, key, template: Optional[str],
                             entry: dict) -> None:
        """Spill-pool ``on_drop`` hook: a dropped entry's prefix-page holds
        (partial eviction) return to the pool."""
        pages = entry.get("prefix_pages")
        if pages:
            self.pool.decref_pages(pages)

    def commit_prefill(self, staged: StagedPrefill,
                       n: Optional[int] = None) -> tuple[int, int]:
        """Commit plus a pinned block table per lane (identity frames in
        dense-compute mode; paged-compute opens tables inside the splice,
        which needs them before any page write)."""
        shape = super().commit_prefill(staged, n)
        if self.paged_compute or staged.parts:
            return shape  # parts recursed through here and built tables
        k = len(staged.requests) if n is None else min(n, len(staged.requests))
        for r, plen in zip(staged.requests[:k], staged.plens[:k]):
            self._open_table(r.lane, int(plen))
        return shape

    def _insert_staged(self, staged: StagedPrefill, lanes: list[int]) -> None:
        """Page-granular commit splice.

        Paged-compute: each request's table is opened (never evicting a
        batch-mate) and exactly the pages its prompt fills are scattered
        into their frames.  Dense-compute splices the batch's longest
        prompt's pages of rows into the per-lane cache; SSM and conv
        leaves move whole."""
        ps = self.page_size
        if not self.paged_compute:
            plen = int(np.max(staged.plens[: len(lanes)]))
            n_rows = min(self.max_len, max(1, self.pool.pages_for(plen)) * ps)
            idx = torch.as_tensor(lanes, device=self.device)
            for name, stack in self.cache.items():
                for key, dst in stack.items():
                    take = staged.cache[name][key][:, : len(lanes)]
                    if self._seq_leaf(dst):
                        dst[:, idx, :n_rows] = take[:, :, :n_rows].to(dst.dtype)
                    else:
                        dst[:, idx] = take.to(dst.dtype)
            for a in _tensors(staged.cache):
                rows = n_rows if self._seq_leaf(a) else a.shape[2] if a.ndim >= 3 else 1
                per_row = math.prod(a.shape[3:]) if a.ndim >= 3 else math.prod(a.shape[2:])
                self.kv_bytes_moved += (a.element_size() * a.shape[0]
                                        * len(lanes) * rows * per_row)
            return
        avoid = set(lanes)
        for i, lane in enumerate(lanes):
            r = staged.requests[i]
            plen = int(staged.plens[i])
            self._open_table(lane, plen, avoid=avoid)
            self._lane_meta[lane] = (getattr(r, "rid", lane), staged.template)
            self.lane_temps[lane] = getattr(r, "temperature", 0.0)
            self.lane_seeds[lane] = getattr(r, "sample_seed", 0)
            self.prefill_flops_total += plen * self._flops_per_token
            if self.prefix_index is not None:
                # This lane now owns resident KV for exactly the last
                # `plen` prompt tokens (cache positions 0..plen): register
                # them so later prompts can alias the prefix.
                self.prefix_index.insert(lane, np.asarray(r.prompt)[-plen:])
            npg = max(1, self.pool.pages_for(plen))
            n_rows = npg * ps
            idx = torch.as_tensor(self.pool.pages(lane)[:npg], device=self.device)
            for name, stack in self.cache.items():
                for key, dst in stack.items():
                    src = staged.cache[name][key][:, i, :n_rows]
                    dst[:, idx] = src.reshape(
                        src.shape[0], npg, ps, *src.shape[2:]).to(dst.dtype)
                    self.kv_bytes_moved += src.element_size() * src.numel()

    # ------------------------------------------------------- fused dispatch
    def stage_chunk(self, staged: StagedPrefill) -> bool:
        """Adopt ``staged``'s next pending chunk into this tick's decode
        dispatch (fused megabatch: one dispatch per tick boundary instead
        of decode + resume).  Returns ``False`` when fusion does not apply
        (dense-compute mode, a chunk already staged, nothing pending, or
        no active decode batch to fuse with); the caller then advances the
        chunk on its own."""
        if not self.paged_compute or self._fused_chunk is not None:
            return False
        part = staged
        if staged.parts:
            part = next((p for p in staged.parts if not p.complete), None)
        if part is None or part.complete or not part.pending:
            return False
        if not self.active.any():
            return False
        self._fused_chunk = part
        return True

    # ----------------------------------------------------------------- tick
    def decode_tick(self) -> dict[int, int]:
        """One paged decode step over every lane, fused with any staged
        prefill chunk: flush restore tails, grow block tables (evicting
        under page pressure), fence copy-on-write pages, fold the chunk
        through the decode path, upload the tables and lane state, run
        :func:`paged_decode_step` and sample → ``{lane: token}``.  With no
        active lane a staged chunk is resumed on its own.  Dense-compute
        mode grows the identity tables and runs the dense decode step."""
        self._flush_restores()
        if not self.paged_compute:
            for lane in np.nonzero(self.active)[0]:
                # Decode writes position `length` this tick: its page must
                # be in the table before the write.
                self._ensure_pages(int(lane),
                                   int(self.lengths[lane]) // self.page_size + 1)
            return super().decode_tick()
        part, self._fused_chunk = self._fused_chunk, None
        if not self.active.any():
            if part is not None:  # nothing to fuse with: plain resume
                self.prefill_resume(part)
            return {}
        for lane in np.nonzero(self.active)[0]:
            lane = int(lane)
            if not self.active[lane]:
                continue  # evicted by an earlier lane's growth this tick
            length = int(self.lengths[lane])
            self._ensure_pages(lane, length // self.page_size + 1)
            if self.active[lane]:
                self._cow_guard(lane, length)
        if not self.active.any():  # growth pressure evicted every lane
            if part is not None:
                self.prefill_resume(part)
            return {}
        if part is not None:  # the chunk side of the fused dispatch
            toks = part.pending.pop(0)
            self._adopt(part)
            clogits, part.cache, part.lengths_dev = self._extend(
                part.cache, toks, part.lengths_dev)
            if not part.pending:
                part.first = clogits.argmax(dim=-1).to(torch.int32)
            self._mark(part)
            self.fused_folds += 1
        dev = self.device
        tables = self._device_tables()
        lengths = torch.as_tensor(self.lengths, device=dev)
        logits, self.cache = paged_decode_step(
            self.arch.cfg, self.params,
            torch.as_tensor(self.last_token, device=dev), self.cache, tables,
            lengths, torch.as_tensor(self.active, device=dev))
        nxt = sample_tokens(logits, self.lane_temps, self.lane_seeds,
                            self.lengths).cpu().numpy()
        self._count_dispatch()
        self.lengths = np.where(self.active,
                                np.minimum(self.lengths + 1, self.max_len - 1),
                                self.lengths).astype(np.int32)
        self.last_token = nxt
        self.decode_steps += 1
        return {int(lane): int(nxt[lane]) for lane in np.nonzero(self.active)[0]}

    def _device_tables(self) -> torch.Tensor:
        """All lanes' block tables as one (n_lanes, pages_per_lane) int32
        tensor on the device (tableless lanes read page 0, masked by
        length)."""
        tabs = np.zeros((self.n_lanes, self.pages_per_lane), np.int32)
        for lane in range(self.n_lanes):
            if self.pool.has_table(lane):
                pages = self.pool.pages(lane)
                tabs[lane, : len(pages)] = pages
        return torch.as_tensor(tabs, device=self.device)

    def _cow_guard(self, lane: int, length: int) -> None:
        """Copy-on-write fence for this tick's KV write: if the page
        backing position ``min(length, max_len - 1)`` is aliased (refcount
        above 1), fork a private copy first (making room if the pool is
        full): placement through :meth:`PagedKVPool.fork_page`, contents
        through one in-place page copy per leaf, so the other readers
        never see the write."""
        slot = min(length, self.max_len - 1) // self.page_size
        pages = self.pool.pages(lane)
        if slot >= len(pages) or self.pool.page_ref(pages[slot]) <= 1:
            return
        if self.pool.n_free_pages < 1:
            self._make_room(1, avoid={lane})
        old, new = self.pool.fork_page(lane, slot)
        for a in _tensors(self.cache):
            a[:, new].copy_(a[:, old])

    def retire(self, lane: int) -> None:
        """Free the lane's block table along with the lane."""
        self._pending_restore.pop(lane, None)
        self._lane_meta.pop(lane, None)
        if self.prefix_index is not None:
            self.prefix_index.remove(lane)
        if self.pool.has_table(lane):
            self.pool.free_table(lane)
        self.lane_temps[lane] = 0.0
        self.lane_seeds[lane] = 0
        super().retire(lane)

    # ---------------------------------------------------------------- spill
    def spill(self, lane: int, key, template: Optional[str] = None) -> bool:
        """Stage only the lane's valid pages to host memory (the dense
        engine copies all ``max_len`` rows).  Paged-compute gathers them
        from their frames; the host entry (contiguous rows, CPU tensors)
        has the same layout in both modes.

        **Partial eviction**: leading pages still aliased by another live
        table (a shared prefix) are not copied.  They stay resident, held
        by an extra reference the entry owns (``prefix_pages``), and cost
        zero bytes; only the private rows from ``tail_start`` move, and
        restore adopts the prefix and splices just those rows back.

        Every write to the cache (commit, decode ticks, restores, forks) is
        enqueued on the caller's current stream; the engine's own stream
        writes only staged prefills.  The device-to-host copies below run
        on that current stream and block until they finish, so they follow
        every queued write to the rows they read."""
        pool = self.partition.spill
        if pool is None or not pool.accepts(template):
            self.retire(lane)
            return False
        self._flush_restores(lane)  # device rows must be whole before copy
        length = int(self.lengths[lane])
        ps = self.page_size
        npg = max(1, self.pool.pages_for(length))
        n_rows = min(self.max_len, npg * ps)
        prefix_pages: list[int] = []
        tail_start = 0
        if self.paged_compute:
            pages = self.pool.pages(lane)[:npg]
            keep = min(self.pool.shared_prefix_pages(lane), npg)
            tail_start = keep * ps
            prefix_pages = list(pages[:keep])
            idx = torch.as_tensor(pages[keep:npg], device=self.device)
            rows = {name: {key_: a[:, idx].reshape(a.shape[0], (npg - keep) * ps,
                                                   *a.shape[3:])[:, : n_rows - tail_start]
                                 .cpu()
                           for key_, a in stack.items()}
                    for name, stack in self.cache.items()}
        else:
            # A copy even on the CPU, where .cpu() would return a view.
            rows = {name: {key_: (a[:, lane, :n_rows] if self._seq_leaf(a)
                                  else a[:, lane]).to("cpu", copy=True)
                           for key_, a in stack.items()}
                    for name, stack in self.cache.items()}
        entry = {
            "rows": rows,
            "n_rows": n_rows,
            "length": length,
            "last": int(self.last_token[lane]),
            "tail_start": tail_start,
            "prefix_pages": prefix_pages,
            "temp": float(self.lane_temps[lane]),
            "seed": int(self.lane_seeds[lane]),
        }
        self.kv_bytes_moved += sum(t.element_size() * t.numel() for t in _tensors(rows))
        if prefix_pages:
            # The entry's hold: the prefix pages survive retire() below and
            # any sibling's retirement until the entry restores or drops.
            self.pool.incref_pages(prefix_pages)
        staged = pool.put(key, template, entry)
        self.retire(lane)
        return staged

    def try_restore(self, key, template: Optional[str] = None) -> Optional[int]:
        """Restore spilled rows: the first ``prefetch_pages`` pages now,
        the tail queued for the next tick, so decode resumes after the
        prefetch instead of waiting for the whole lane.  Paged-compute also
        needs the pages free right now (a restore never evicts: that would
        thrash against the eviction that spilled it)."""
        pool = self.partition.spill
        if pool is None or key not in pool or self.n_free_for(template) <= 0:
            return None
        entry = pool.take(key)
        if entry is None:  # raced away (defensive: the tick loop is 1-threaded)
            return None
        rows = entry["rows"]
        n_rows = entry["n_rows"]
        tail_start = entry.get("tail_start", 0)
        prefix_pages = entry.get("prefix_pages") or []
        head = min(n_rows, self.prefetch_pages * self.page_size)
        if self.paged_compute:
            k = len(prefix_pages)
            total = min(self.pages_per_lane,
                        entry["length"] // self.page_size + 1)
            need = max(0, total - k)
            if self.pool.n_free_pages < need:
                pool.put(key, template, entry)  # not enough pages yet
                return None
            lane = self.partition.alloc(template)
            if k:
                # Adopt the still-resident shared prefix: the entry's hold
                # transfers into the new table (no copy, no incref); only
                # the private tail needs page claims and a host splice.
                self.pool.adopt_table(lane, prefix_pages)
                if need > 0:
                    self.pool.extend_table(lane, n=need)
                self.pool.pin(lane)
            else:
                self._open_table(lane, entry["length"])
            self._lane_meta[lane] = (key, template)
            self.lane_temps[lane] = entry.get("temp", 0.0)
            self.lane_seeds[lane] = entry.get("seed", 0)
            head = min(n_rows, tail_start + self.prefetch_pages * self.page_size)
            self._write_rows(lane, rows, tail_start, head, base=tail_start)
        else:
            lane = self.partition.alloc(template)
            for name, stack in self.cache.items():
                for key_, dst in stack.items():
                    src = rows[name][key_]
                    if self._seq_leaf(dst):
                        dst[:, lane, :head] = src[:, :head].to(self.device, dst.dtype)
                    else:
                        dst[:, lane] = src.to(self.device, dst.dtype)
            self.kv_bytes_moved += sum(
                (a.element_size() * a.shape[0] * head * math.prod(a.shape[2:]))
                if a.ndim >= 3 and a.shape[1] == n_rows
                else a.element_size() * a.numel()
                for a in _tensors(rows))
            self._open_table(lane, entry["length"])
        if head < n_rows:
            self._pending_restore[lane] = (rows, head, n_rows, tail_start)
        self.lengths[lane] = entry["length"]
        self.last_token[lane] = entry["last"]
        self.active[lane] = True
        return lane

    def _write_rows(self, lane: int, rows, start: int, stop: int,
                    base: int = 0) -> None:
        """Scatter host rows covering logical positions [start, stop)
        (page-aligned bounds) into ``lane``'s frames, with byte accounting
        (paged-compute).  ``base`` is the logical position of ``rows``'
        first row: a partial eviction's host copy starts at ``tail_start``."""
        if stop <= start:
            return
        ps = self.page_size
        p0, p1 = start // ps, stop // ps
        idx = torch.as_tensor(self.pool.pages(lane)[p0:p1], device=self.device)
        for name, stack in self.cache.items():
            for key, dst in stack.items():
                s = rows[name][key][:, start - base: stop - base]
                dst[:, idx] = s.reshape(s.shape[0], p1 - p0, ps,
                                        *s.shape[2:]).to(self.device, dst.dtype)
        for a in _tensors(rows):
            self.kv_bytes_moved += (a.element_size() * a.shape[0] * (stop - start)
                                    * math.prod(a.shape[2:]))

    def _flush_restores(self, lane: Optional[int] = None) -> None:
        """Splice queued restore tails into the cache (all lanes, or one
        lane about to be copied out again)."""
        if lane is not None:
            items = ([(lane, self._pending_restore.pop(lane))]
                     if lane in self._pending_restore else [])
        else:
            items = list(self._pending_restore.items())
            self._pending_restore.clear()
        for ln_, (rows, start, stop, base) in items:
            if self.paged_compute:
                self._write_rows(ln_, rows, start, stop, base=base)
                continue
            for name, stack in self.cache.items():
                for key, dst in stack.items():
                    if self._seq_leaf(dst):
                        dst[:, ln_, start:stop] = rows[name][key][:, start:stop].to(
                            self.device, dst.dtype)
            for a in _tensors(rows):
                if a.ndim >= 3 and a.shape[1] == stop:
                    self.kv_bytes_moved += (a.element_size() * a.shape[0]
                                            * (stop - start) * math.prod(a.shape[2:]))

    # ------------------------------------------------------------ paged view
    def paged_view(self, stack: str = "layers") -> Optional[dict]:
        """The active lanes' KV in the paged kernel's layout.

        Returns ``{"k_pages", "v_pages", "block_tables", "lengths",
        "lanes"}`` for one transformer ``stack`` (layer 0), tensors on the
        engine's device.  Paged-compute mode returns the live page arrays
        (what decode_tick consumes); dense-compute mode cuts pages from the
        per-lane cache at identity frames.  ``None`` when the stack has no
        k/v leaves or nothing is active."""
        entry = self.cache.get(stack)
        if not entry or "k" not in entry or not self.active.any():
            return None
        lanes = [int(x) for x in np.nonzero(self.active)[0]]
        ps, ppl = self.page_size, self.pages_per_lane
        if self.paged_compute:
            k_pages, v_pages = entry["k"][0], entry["v"][0]
        else:
            k0, v0 = entry["k"][0], entry["v"][0]  # (B, S, Hkv, hd), layer 0
            hkv, hd = k0.shape[2], k0.shape[3]
            k_pages = k0.reshape(self.n_lanes * ppl, ps, hkv, hd)
            v_pages = v0.reshape(self.n_lanes * ppl, ps, hkv, hd)
        tables = np.stack([self.pool.block_table(lane, ppl) for lane in lanes])
        lengths = self.lengths[lanes].astype(np.int32)
        return {"k_pages": k_pages, "v_pages": v_pages,
                "block_tables": torch.as_tensor(tables, device=self.device),
                "lengths": torch.as_tensor(lengths, device=self.device),
                "lanes": lanes}
