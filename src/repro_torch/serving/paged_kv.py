"""Paged KV cache: fixed-size pages, block tables, paged decode compute.

Port of :mod:`repro.serving.paged_kv`.  :class:`PagedKVPool` (refcounted
physical pages and per-request block tables) and :class:`PagedKVView`
(the page-budget-bounded :class:`~repro_torch.serving.kv.KVView`) are
copies of the reference's pure-Python classes.

:class:`PagedInferenceEngine` ports the paged-compute path: KV lives only
in shared page arrays ``(L, n_pages + 1, page_size, Hkv, hd)`` on the
device; commit scatters exactly the pages each prompt fills; every decode
tick grows block tables, uploads them, and runs
:func:`~repro_torch.models.paged_decode.paged_decode_step`, whose
attention is the ``paged_decode_attention`` CUDA kernel on the card.
Physical slot ``n_pages`` is the trash page inactive lanes write into; no
block table references it and the pool never allocates it.

Unlike the reference, which rebuilds the page arrays functionally each
step, the port updates them **in place** (``index_put_`` for the decode
scatter and the commit splice, ``copy_`` for a copy-on-write fork).

Not ported yet (the next slice): prefix sharing (``prefix_share=True``),
oversubscribed pools (``n_pages`` below ``n_lanes * max_len /
page_size``), host spill/restore (``kv_spill``), the fused chunk tick
(``stage_chunk``) and the dense-compute mode for architectures paged
decode cannot cover.  Each raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models.paged_decode import (
    paged_decode_step,
    sample_tokens,
    supports_paged_decode,
)
from repro_torch.serving.engine import InferenceEngine, KVPartition, StagedPrefill

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
    """Serving engine with paged KV compute (module docstring).

    ``page_size`` must divide ``max_len``.  ``n_pages`` sizes the physical
    pool and must be the full provisioning ``n_lanes * max_len /
    page_size`` (the default) until eviction under page pressure is
    ported.  ``prefix_share`` must stay ``False`` for now.
    """

    page_size: int = 16
    n_pages: Optional[int] = None
    prefix_share: bool = False

    def __post_init__(self):
        super().__post_init__()
        if self.max_len % self.page_size:
            raise ValueError("page_size must divide max_len")
        if not supports_paged_decode(self.arch.cfg):
            raise NotImplementedError(
                f"{self.arch.cfg.name}: the dense-compute paged mode "
                "(sliding-window, SSM/hybrid) is not ported yet")
        self.pages_per_lane = self.max_len // self.page_size
        full = self.n_lanes * self.pages_per_lane
        if self.n_pages is None:
            self.n_pages = full
        if self.n_pages != full:
            raise NotImplementedError(
                "oversubscribed page pools evict to host spill, which is "
                "not ported yet; leave n_pages at n_lanes * max_len / "
                "page_size")
        if self.kv_spill is not None:
            raise NotImplementedError("host KV spill is not ported yet")
        if self.prefix_share:
            raise NotImplementedError("prefix sharing is not ported yet")
        self.pool = PagedKVPool(self.n_pages, self.page_size)
        quota = None
        if self.partition.shares:
            quota = {t: k * self.n_pages // self.n_lanes
                     for t, k in self.partition.shares.items()}
        self._kv_view = PagedKVView(self.partition, self.pool,
                                    self.pages_per_lane, page_quota=quota,
                                    used_pages=self._pages_used_by)
        # lane -> (request key, template): page-quota accounting.
        self._lane_meta: dict[int, tuple] = {}
        # Per-lane sampling params for the cross-template decode megabatch
        # (temperature 0 = greedy argmax).
        self.lane_temps = np.zeros((self.n_lanes,), np.float32)
        self.lane_seeds = np.zeros((self.n_lanes,), np.int32)
        self.prefill_flops_total = 0
        self._flops_per_token = 2 * sum(
            int(a.numel()) for a in _leaves(self.params))
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

    # ---------------------------------------------------------- page tables
    def _pages_used_by(self, template: Optional[str]) -> int:
        """Physical pages currently held by ``template``'s lanes."""
        return sum(len(self.pool.pages(lane))
                   for lane, (_key, t) in self._lane_meta.items()
                   if t == template and self.pool.has_table(lane))

    def _open_table(self, lane: int, length: int) -> None:
        """Create ``lane``'s pinned block table covering ``length`` written
        rows plus the next write position."""
        n = min(self.pages_per_lane, length // self.page_size + 1)
        self.pool.alloc_table(lane, n=n)
        self.pool.pin(lane)

    def _ensure_pages(self, lane: int, n: int) -> None:
        n = min(n, self.pages_per_lane)
        have = len(self.pool.table(lane))
        if n > have:
            self.pool.extend_table(lane, n=n - have)

    # ------------------------------------------------------------ admission
    def _insert_staged(self, staged: StagedPrefill, lanes: list[int]) -> None:
        """Page-granular commit splice: open each request's table and
        scatter exactly the pages its prompt fills into their frames."""
        ps = self.page_size
        for i, lane in enumerate(lanes):
            r = staged.requests[i]
            plen = int(staged.plens[i])
            self._open_table(lane, plen)
            self._lane_meta[lane] = (getattr(r, "rid", lane), staged.template)
            self.lane_temps[lane] = getattr(r, "temperature", 0.0)
            self.lane_seeds[lane] = getattr(r, "sample_seed", 0)
            self.prefill_flops_total += plen * self._flops_per_token
            npg = max(1, self.pool.pages_for(plen))
            n_rows = npg * ps
            idx = torch.as_tensor(self.pool.pages(lane)[:npg], device=self.device)
            for name, stack in self.cache.items():
                for key, dst in stack.items():
                    src = staged.cache[name][key][:, i, :n_rows]
                    dst[:, idx] = src.reshape(
                        src.shape[0], npg, ps, *src.shape[2:]).to(dst.dtype)
                    self.kv_bytes_moved += (src.element_size() * src.numel())

    def stage_chunk(self, staged: StagedPrefill) -> bool:
        """The fused chunk tick (a prefill chunk folded into the decode
        dispatch) needs chunked prefill, which is not ported yet."""
        raise NotImplementedError("chunked prefill is not ported yet")

    # ----------------------------------------------------------------- tick
    def decode_tick(self) -> dict[int, int]:
        """One paged decode step over every lane: grow block tables, fence
        copy-on-write pages, upload the tables and lane state, run
        :func:`paged_decode_step` and sample → ``{lane: token}``."""
        if not self.active.any():
            return {}
        for lane in np.nonzero(self.active)[0]:
            lane = int(lane)
            length = int(self.lengths[lane])
            self._ensure_pages(lane, length // self.page_size + 1)
            self._cow_guard(lane, length)
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
        above 1), fork a private copy first — placement through
        :meth:`PagedKVPool.fork_page`, contents through one in-place page
        copy per leaf — so the other readers never see the write."""
        slot = min(length, self.max_len - 1) // self.page_size
        pages = self.pool.pages(lane)
        if slot >= len(pages) or self.pool.page_ref(pages[slot]) <= 1:
            return
        old, new = self.pool.fork_page(lane, slot)
        for stack in self.cache.values():
            for a in stack.values():
                a[:, new].copy_(a[:, old])

    def retire(self, lane: int) -> None:
        """Free the lane's block table along with the lane."""
        self._lane_meta.pop(lane, None)
        if self.pool.has_table(lane):
            self.pool.free_table(lane)
        self.lane_temps[lane] = 0.0
        self.lane_seeds[lane] = 0
        super().retire(lane)


def _leaves(tree):
    """Every tensor of a nested parameter dict."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
