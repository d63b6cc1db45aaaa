"""Inference engine: lanes, prefill dispatch/commit, dense decode, counters.

Port of :mod:`repro.serving.engine`.  ``HostSpillPool``, ``KVPartition``,
``StagedPrefill`` and ``_bucket`` are copies of the reference's
pure-Python classes (``StagedPrefill`` gains one field, ``ready``).
:class:`InferenceEngine` is the dense engine (reference ``:413-679``,
``:689-754``), and carries the parts the paged engine
(:mod:`repro_torch.serving.paged_kv`) inherits:

* ``prefill_dispatch`` — one right-padded prompt batch, bucketed to powers
  of two and pinned per template, through ``transformer.prefill`` (whose
  attention is the flash op); with ``chunk=`` an oversized prompt
  prefills its first chunk and stages the rest, which ``prefill_resume``
  folds in one chunk at a time through ``_extend`` (the dense one-token
  decode step, whose attention is the ``decode_attention`` op);
* ``_prefill`` — the first token is the argmax of the logits at
  ``plens - 1``, so pad positions never matter;
* ``commit_prefill``, ``admit``, ``retire``, ``spill``/``try_restore``
  and the ``dispatches`` / ``decode_steps`` / ``prefill_calls`` /
  ``kv_bytes_moved`` counters, raised at the reference's call sites.

The dense ``decode_tick`` runs ``transformer.decode_step`` over every
lane of the stacked cache ``(L, n_lanes, max_len, Hkv, hd)``, updated in
place.  Lane state (``lengths``, ``last_token``, ``active``) lives on the
host as numpy arrays and is uploaded once per tick; the reference keeps
``lengths``/``last_token`` as device arrays.

**Streams.**  Dispatch on the card is asynchronous as in JAX, and the
scheduler's speculation thread dispatches prefills while the main thread
runs a decode tick.  Work issued by ``prefill_dispatch`` and
``prefill_resume`` is enqueued on a stream the engine owns, so it can run
beside the main stream's decode, and each :class:`StagedPrefill` records
an event after it (``ready``).  Before the main stream touches a staged
prefill (``commit_prefill``, the paged engine's fused chunk tick) it
waits on that event, and every tensor of the staged object is marked
with ``record_stream`` for the stream that uses it, so the caching
allocator never hands its memory to other work while that stream may
still read it.  Dropping a staged object (an aborted bet) needs nothing
more.  On the CPU there are no streams and both helpers do nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from collections import OrderedDict
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as _tf
from repro_torch.models.registry import Arch

__all__ = ["HostSpillPool", "InferenceEngine", "KVPartition", "StagedPrefill"]

_SHARED = "__shared__"  # KVPartition pool key for unreserved lanes


def _bucket(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class HostSpillPool:
    """Host-side LRU staging area for evicted decode-lane KV.

    Keys are request identities (the scheduler uses ``Request.rid``); each
    entry holds one lane's KV rows plus the decode cursor (length + last
    token), copied to host memory at eviction time.  ``max_entries``
    bounds the pool globally; ``budget_for`` (e.g.
    :meth:`~repro.core.lane_policy.LanePolicy.spill_budget_for`) bounds
    entries *per template*, so one template's straggler churn cannot evict
    everyone else's staged KV — the host-memory analogue of the lane
    reservations above.  Over-budget inserts evict the least-recently-used
    entry (of that template for the per-template bound, globally for
    ``max_entries``); a re-admitted request whose entry survived restores
    instead of re-prefilling.

    Thread-safe (a lock per op): the scheduler spills/restores from its
    tick loop, but introspection (stats, ``in``) may come from anywhere.

    ``on_drop`` is invoked (under the pool lock) for every entry the pool
    discards without a restore — stale duplicates, per-template budget
    evictions and global LRU evictions — with ``(key, template, entry)``.
    Entries may own resources beyond host bytes: a partial eviction's
    entry holds refcounts on the shared prefix pages it left resident in
    the device pool, and dropping the entry must release them or the
    pages leak.  ``take`` never triggers it (the restoring caller owns
    the entry's resources from then on).
    """

    def __init__(self, max_entries: int = 32,
                 budget_for: Optional[Callable[[Optional[str]],
                                               Optional[int]]] = None,
                 on_drop: Optional[Callable[[object, Optional[str], dict],
                                            None]] = None):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self.budget_for = budget_for
        self.on_drop = on_drop
        self._lock = threading.Lock()
        self._lru: "OrderedDict[object, tuple[Optional[str], dict]]" = OrderedDict()
        self.spilled = 0    # entries accepted
        self.restored = 0   # entries taken back by a re-admission
        self.dropped = 0    # entries evicted (LRU / budget) before restore

    def _drop(self, key, template: Optional[str], entry: dict) -> None:
        """Account one discarded entry and release its resources."""
        self.dropped += 1
        if self.on_drop is not None:
            self.on_drop(key, template, entry)

    def accepts(self, template: Optional[str]) -> bool:
        """Whether a new entry for ``template`` would be stored at all —
        ``False`` only for a zero-budget (fenced) template.  Callers
        check this BEFORE paying the device→host KV copy; a positive
        budget always admits the new entry (evicting older ones)."""
        budget = self.budget_for(template) if self.budget_for else None
        return budget is None or budget > 0

    def put(self, key, template: Optional[str], entry: dict) -> bool:
        """Stage one evicted lane's KV under ``key`` (replacing any stale
        entry for the same key), evicting LRU entries that break the
        global or per-template budget.  Returns whether the entry was
        stored (``False`` for a zero-budget fenced template)."""
        with self._lock:
            if key in self._lru:
                stale_t, stale_e = self._lru.pop(key)
                self._drop(key, stale_t, stale_e)  # the new KV wins
            budget = self.budget_for(template) if self.budget_for else None
            if budget is not None and budget <= 0:
                self._drop(key, template, entry)  # template fenced out
                return False
            if budget is not None:
                mine = [k for k, (t, _) in self._lru.items() if t == template]
                while len(mine) >= budget:
                    victim = mine.pop(0)  # oldest of THIS template
                    v_t, v_e = self._lru.pop(victim)
                    self._drop(victim, v_t, v_e)
            while len(self._lru) >= self.max_entries:
                v_key, (v_t, v_e) = self._lru.popitem(last=False)
                self._drop(v_key, v_t, v_e)
            self._lru[key] = (template, entry)
            self.spilled += 1
            return True

    def take(self, key) -> Optional[dict]:
        """Remove and return ``key``'s staged entry (``None`` on miss)."""
        with self._lock:
            hit = self._lru.pop(key, None)
            if hit is None:
                return None
            self.restored += 1
            return hit[1]

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._lru

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def snapshot(self) -> dict:
        """Counters + occupancy (introspection/benchmark reporting)."""
        with self._lock:
            return {"entries": len(self._lru), "spilled": self.spilled,
                    "restored": self.restored, "dropped": self.dropped}


class KVPartition:
    """Per-template lane reservations over a fixed set of decode lanes.

    ``shares[template] = k`` pins ``k`` specific lanes to ``template``:
    they are allocated only to that template and return to its pool on
    release, so no burst elsewhere can take them.  Unreserved lanes form
    the shared pool; a reserved template drains its own pool first and
    then competes for shared lanes like everyone else, while a template
    with no reservation sees only the shared pool.

    Single-threaded by design (the scheduler tick loop): allocation and
    release happen on the scheduler thread only — the speculative prefill
    thread never touches the partition (dispatch is stateless; see
    :meth:`InferenceEngine.prefill_dispatch`).
    """

    def __init__(self, n_lanes: int, shares: Optional[Mapping[str, int]] = None,
                 spill: Optional[HostSpillPool] = None):
        self.spill = spill  # host-side LRU for evicted lanes' KV (optional)
        shares = dict(shares or {})
        for t, k in shares.items():
            if t == _SHARED:
                raise ValueError(f"{_SHARED!r} is a reserved pool name")
            if k < 0:
                raise ValueError(f"kv_shares[{t!r}] must be >= 0, got {k}")
        if sum(shares.values()) > n_lanes:
            raise ValueError(
                f"kv_shares reserve {sum(shares.values())} lanes but the "
                f"engine only has {n_lanes}")
        self.shares = {t: k for t, k in shares.items() if k > 0}
        lanes = list(range(n_lanes))
        self._home: dict[int, str] = {}
        self._free: dict[str, list[int]] = {}
        for t, k in self.shares.items():
            pool = [lanes.pop(0) for _ in range(k)]
            for lane in pool:
                self._home[lane] = t
            self._free[t] = pool
        self._free[_SHARED] = lanes
        self._quarantined: set[int] = set()

    def quarantine(self, lane: int) -> None:
        """Remove ``lane`` from circulation: it will not be allocated again
        until :meth:`unquarantine` returns it to its home pool.  Used by
        crash recovery — a lane whose device step faulted sits out a
        cooldown instead of immediately hosting the next request.  The
        lane must currently be free (retire/release it first)."""
        for pool in self._free.values():
            if lane in pool:
                pool.remove(lane)
                self._quarantined.add(lane)
                return
        if lane in self._quarantined:
            return
        raise ValueError(f"lane {lane} is not free; cannot quarantine")

    def unquarantine(self, lane: int) -> None:
        """Return a quarantined lane to its home pool (no-op otherwise)."""
        if lane in self._quarantined:
            self._quarantined.discard(lane)
            self.release(lane)

    @property
    def quarantined(self) -> frozenset:
        """Snapshot of lanes currently held out of circulation."""
        return frozenset(self._quarantined)

    @property
    def n_free(self) -> int:
        """Total free lanes across every pool."""
        return sum(len(p) for p in self._free.values())

    def n_free_for(self, template: Optional[str]) -> int:
        """Free lanes ``template`` may allocate right now: its own reserved
        pool (if any) plus the shared pool.  ``None`` (untemplated
        admission) sees only the shared pool."""
        n = len(self._free[_SHARED])
        if template is not None:
            n += len(self._free.get(template, ()))
        return n

    def alloc(self, template: Optional[str]) -> int:
        """Take one lane for ``template`` — its reserved pool first (keeps
        the shared pool liquid for everyone else), then shared.  Raises
        ``IndexError`` when neither pool has a free lane."""
        pool = self._free.get(template) if template is not None else None
        if not pool:
            pool = self._free[_SHARED]
        return pool.pop(0)

    def release(self, lane: int) -> None:
        """Return a lane to its home pool (owning template's reservation,
        or shared for unreserved lanes)."""
        self._free[self._home.get(lane, _SHARED)].append(lane)

    def benefits(self, lane: int, template: Optional[str]) -> bool:
        """Whether releasing ``lane`` would raise ``n_free_for(template)``:
        true for shared lanes and for ``template``'s own reserved lanes.
        The scheduler's speculative sizing uses this to bet only on
        retirements that can actually serve the speculated template —
        a lane going home to ANOTHER template's reservation is a
        guaranteed miss, not a speculation."""
        home = self._home.get(lane, _SHARED)
        return home == _SHARED or home == template

    @property
    def free_lanes(self) -> list[int]:
        """Sorted snapshot of every free lane (introspection/debugging)."""
        return sorted(lane for p in self._free.values() for lane in p)


@dataclasses.dataclass
class StagedPrefill:
    """A dispatched-but-uncommitted prefill batch.

    Produced by :meth:`InferenceEngine.prefill_dispatch`; holds the padded
    batch's device results (``first`` tokens + KV ``cache`` — possibly
    still being computed: JAX dispatch is asynchronous) and the request
    list, but no engine state.  :meth:`InferenceEngine.commit_prefill`
    materializes it into lanes; dropping it instead is a zero-cost abort
    (beyond the device work already paid, which the scheduler reports via
    ``observe_abort``).
    """

    template: Optional[str]
    requests: list
    first: object   # (bsz,) int32 device array — argmax token 0 per row
    cache: object   # KV pytree, batch axis sized to the padded bucket
    plens: np.ndarray
    shape: tuple[int, int]  # the padded (batch, prompt) bucket dispatched
    # Chunked dispatch state (``prefill_dispatch(..., chunk=)``): token
    # chunks not yet folded into the staged cache, and the device-side
    # lengths cursor the next :meth:`InferenceEngine.prefill_resume` call
    # extends from.  ``first`` stays ``None`` until the final chunk.
    pending: list = dataclasses.field(default_factory=list)
    lengths_dev: object = None
    # Batched-chunk dispatch (``prefill_dispatch([r0, r1, ...], chunk=)``):
    # one single-request staged prefill per prompt.  The parent is a pure
    # aggregate — ``cache``/``first`` stay ``None``; resume advances one
    # part-chunk per call, commit delegates to the parts in order.
    parts: list = dataclasses.field(default_factory=list)
    # Port only: the CUDA event recorded after the last work enqueued on
    # this staged prefill (``None`` on the CPU).  The stream that touches
    # it next waits on it first (:meth:`InferenceEngine._adopt`).
    ready: object = None

    @property
    def complete(self) -> bool:
        """Whether every chunk has been processed (always true for the
        one-shot dispatch path) — only a complete staged prefill may be
        committed."""
        if self.parts:
            return all(p.complete for p in self.parts)
        return not self.pending


@dataclasses.dataclass
class InferenceEngine:
    """Dense lane-cache engine; the paged engine builds on it.

    ``device`` defaults to ``"cuda"`` and must be where ``params`` live;
    without CUDA the caller passes ``device="cpu"``.  ``kv_shares``
    reserves decode lanes per template (:class:`KVPartition`);
    ``kv_spill`` stages retired lanes' KV in host memory for
    :meth:`try_restore`.
    """

    arch: Arch
    params: dict
    n_lanes: int = 8
    max_prompt_len: int = 64
    max_len: int = 128
    kv_shares: Optional[Mapping[str, int]] = None
    kv_spill: Optional[HostSpillPool] = None
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        where = self.params["embed"]["table"].device
        if where.type != self.device.type:
            raise ValueError(f"params live on {where}, engine device is "
                             f"{self.device}")
        self.cache = self.arch.init_cache(self.n_lanes, self.max_len, self.device)
        self.lengths = np.zeros((self.n_lanes,), np.int32)
        self.active = np.zeros((self.n_lanes,), bool)
        self.last_token = np.zeros((self.n_lanes,), np.int32)
        self.partition = KVPartition(self.n_lanes, self.kv_shares,
                                     spill=self.kv_spill)
        self.decode_steps = 0
        self.prefill_calls = 0
        # KV bytes copied into or out of the engine's cache (commit
        # splices, spill and restore).  The dense engine moves whole lanes
        # (max_len rows whether valid or not).
        self.kv_bytes_moved = 0
        # Model-step device programs launched (decode ticks, prefill
        # batches, chunk extends, fused ticks), counted at the same call
        # sites as the reference's jit dispatches so its exactly-one-per-
        # tick gates carry over.  Lock-guarded: the speculation thread
        # dispatches too.
        self.dispatches = 0
        self._dispatch_lock = threading.Lock()
        # template -> pinned (batch, prompt) prefill bucket (monotone max).
        self.template_shapes: dict[str, tuple[int, int]] = {}
        # The stream prefill_dispatch / prefill_resume enqueue on (module
        # docstring); None on the CPU.
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
            # Weights may still be being written on the caller's stream.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def _count_dispatch(self, n: int = 1) -> None:
        """Record ``n`` model-step dispatches (thread-safe)."""
        with self._dispatch_lock:
            self.dispatches += n

    # --------------------------------------------------------------- streams
    def _side(self):
        """Context that enqueues on the engine's own stream (no-op on CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _mark(self, staged: StagedPrefill) -> None:
        """Record, on the current stream, that ``staged``'s work is queued."""
        if self._stream is not None:
            staged.ready = torch.cuda.Event()
            staged.ready.record()

    def _adopt(self, staged: StagedPrefill) -> None:
        """Order the current stream after ``staged``'s queued work and mark
        its tensors as used on this stream (module docstring)."""
        if self._stream is None or staged.ready is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(staged.ready)
        for t in _tensors((staged.first, staged.cache, staged.lengths_dev)):
            t.record_stream(cur)

    # ------------------------------------------------------------ model steps
    def _prefill(self, tokens: torch.Tensor, plens: torch.Tensor):
        """Prefill a right-padded batch → (first token per row, KV cache
        padded to ``max_len``).  The first token is the argmax of the
        logits at ``plens - 1``, the row's last real position."""
        logits, cache = _tf.prefill(self.arch.cfg, self.params, tokens,
                                    max_len=self.max_len, return_all_logits=True)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        last = logits[rows, plens.long() - 1]
        return last.argmax(dim=-1).to(torch.int32), cache

    def _extend(self, cache: dict, toks: np.ndarray, lengths: torch.Tensor):
        """Feed ``toks`` (B, C) — C further prompt tokens per row — through
        the decode path one position at a time, extending ``cache`` in
        place from ``lengths``: exactly the computation prefill performs
        for those positions, split in time (the reference's ``lax.scan``).
        Returns (logits of the last position, cache, advanced lengths)."""
        tok = torch.as_tensor(toks, device=self.device)
        logits = None
        for j in range(tok.shape[1]):
            logits, cache = self.arch.decode_step(self.params, tok[:, j], cache,
                                                  lengths)
            lengths = lengths + 1
        return logits, cache, lengths

    # ------------------------------------------------------------- admission
    def _check_prompts(self, requests: Sequence) -> None:
        """Refuse a prompt token outside ``[0, vocab_size)`` before any
        device work.  The reference's embedding gather clamps such a token
        to the table's edge and serves a wrong stream; here an index out of
        range is a ``ValueError`` on every device (on the card it would be
        an illegal read)."""
        vocab = self.arch.cfg.vocab_size
        for r in requests:
            p = np.asarray(r.prompt)
            if p.size and (int(p.min()) < 0 or int(p.max()) >= vocab):
                raise ValueError(f"request {getattr(r, 'rid', '?')}: a prompt token lies "
                                 f"outside the vocabulary [0, {vocab})")

    def admit(self, requests: Sequence, template: Optional[str] = None
              ) -> tuple[int, int]:
        """Prefill ``requests`` as ONE padded batch and insert into lanes
        (:meth:`prefill_dispatch` then :meth:`commit_prefill`)."""
        if not requests:
            return (0, 0)
        assert len(requests) <= self.n_free_for(template), \
            "admit() beyond this template's free lanes"
        return self.commit_prefill(self.prefill_dispatch(requests, template))

    def prefill_dispatch(self, requests: Sequence,
                         template: Optional[str] = None,
                         chunk: Optional[int] = None) -> StagedPrefill:
        """Dispatch (but do not commit) one padded prefill batch.

        Mutates no engine or request state apart from the per-template
        shape pin, so the scheduler may call it from its speculation
        thread and drop the result.  The batch is padded to a power of two
        and its prompt axis to the power-of-two bucket of its longest
        (truncated) prompt, capped at ``max_prompt_len``; prompts are
        right-padded and causal masking hides the pad keys.

        ``chunk`` enables resumable chunked prefill: a prompt longer than
        ``chunk`` (truncated to ``max_len - 1``) prefills its first chunk
        now and stages the rest as ``pending`` chunks for
        :meth:`prefill_resume`; a batch holding such prompts becomes one
        single-request part per prompt under an aggregate parent.  Prompts
        that fit one chunk take the ordinary path."""
        self._check_prompts(requests)
        if chunk is not None and chunk >= 1:
            cprompts = [np.asarray(r.prompt[-(self.max_len - 1):], np.int32)
                        for r in requests]
            if len(requests) == 1:
                if len(cprompts[0]) > chunk:
                    return self._chunked_dispatch(
                        requests[0], cprompts[0], template, chunk)
            elif any(len(p) > chunk for p in cprompts):
                parts = [self._chunked_dispatch(r, p, template, chunk)
                         for r, p in zip(requests, cprompts)]
                return StagedPrefill(
                    template, list(requests), None, None,
                    np.concatenate([pt.plens for pt in parts]),
                    (len(requests), int(max(len(p) for p in cprompts))),
                    parts=parts)
        bsz = _bucket(len(requests))
        prompts = [r.prompt[-self.max_prompt_len:] for r in requests]
        plen = min(self.max_prompt_len, _bucket(max(len(p) for p in prompts)))
        if template is not None:
            pinned = self.template_shapes.get(template, (1, 1))
            bsz = max(bsz, pinned[0])
            plen = max(plen, pinned[1])
            self.template_shapes[template] = (bsz, plen)
        toks = np.zeros((bsz, plen), np.int32)
        plens = np.ones((bsz,), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p  # right-pad; causal mask hides pad keys
            plens[i] = len(p)
        with self._side():
            first, cache = self._prefill(torch.as_tensor(toks, device=self.device),
                                         torch.as_tensor(plens, device=self.device))
            staged = StagedPrefill(template, list(requests), first, cache,
                                   plens, (bsz, plen))
            self._mark(staged)
        self._count_dispatch()
        return staged

    def _chunked_dispatch(self, r, prompt: np.ndarray,
                          template: Optional[str], chunk: int) -> StagedPrefill:
        """Prefill the first chunk of one prompt and stage the rest.

        The staged cache is batch-1 and padded to ``max_len``; later chunks
        extend it in place through the decode path, so the committed KV
        matches a one-shot prefill of the whole prompt.  The per-template
        shape pin is not consulted (chunk shapes are their own family)."""
        S = len(prompt)
        c0 = min(chunk, S)
        dev = self.device
        with self._side():
            first, cache = self._prefill(
                torch.as_tensor(prompt[None, :c0], device=dev),
                torch.as_tensor([c0], dtype=torch.int32, device=dev))
            pending = [prompt[None, i: i + chunk] for i in range(c0, S, chunk)]
            staged = StagedPrefill(
                template, [r], None if pending else first, cache,
                np.asarray([S], np.int32), (1, S), pending=pending,
                lengths_dev=torch.as_tensor([c0], dtype=torch.int32, device=dev))
            self._mark(staged)
        self._count_dispatch()
        return staged

    def prefill_resume(self, staged: StagedPrefill) -> bool:
        """Fold the next pending chunk into a chunked staged prefill (one
        dispatch: :meth:`_extend` over the chunk's positions); the final
        chunk also yields the first generated token.  Returns
        completeness.  Mutates only the staged object, so it is safe on
        the speculation thread.  A batched-chunk parent advances ONE chunk
        of its first incomplete part per call."""
        if staged.complete:
            return True
        if staged.parts:
            for part in staged.parts:
                if not part.complete:
                    self.prefill_resume(part)
                    break
            return staged.complete
        toks = staged.pending.pop(0)
        with self._side():
            self._adopt(staged)
            logits, staged.cache, staged.lengths_dev = self._extend(
                staged.cache, toks, staged.lengths_dev)
            if not staged.pending:
                staged.first = logits.argmax(dim=-1).to(torch.int32)
            self._mark(staged)
        self._count_dispatch()
        return staged.complete

    def commit_prefill(self, staged: StagedPrefill,
                       n: Optional[int] = None) -> tuple[int, int]:
        """Materialize a staged prefill into decode lanes.

        Commits the first ``n`` requests (default: all) — a batched-chunk
        parent delegates to its parts in order — waiting for the device
        results, allocating each a lane from its template's pools and
        splicing its KV into the engine's cache.  Returns the padded
        ``(batch, prompt)`` bucket dispatched."""
        assert staged.complete, \
            "commit_prefill() of a chunked staged prefill with pending chunks"
        if staged.parts:
            take = len(staged.requests) if n is None else n
            for part in staged.parts:
                k = min(len(part.requests), take)
                if k <= 0:
                    break
                self.commit_prefill(part, k)
                take -= k
            return staged.shape
        reqs = staged.requests if n is None else staged.requests[:n]
        assert len(reqs) <= self.n_free_for(staged.template), \
            "commit_prefill() beyond this template's free lanes"
        if not reqs:
            return staged.shape
        self._adopt(staged)
        first = staged.first.cpu().numpy()  # waits for the dispatched prefill
        lanes = [self.partition.alloc(staged.template) for _ in reqs]
        self._insert_staged(staged, lanes)
        for i, (r, lane) in enumerate(zip(reqs, lanes)):
            r.lane = lane
            r.generated.append(int(first[i]))
            self.last_token[lane] = first[i]
            self.lengths[lane] = staged.plens[i]  # real prompt length
            self.active[lane] = True
        self.prefill_calls += 1
        return staged.shape

    def _insert_staged(self, staged: StagedPrefill, lanes: list[int]) -> None:
        """Splice the staged batch's cache into ``lanes`` (whole lanes,
        every ``max_len`` row, accounted in :attr:`kv_bytes_moved`) — the
        KV-motion hook the paged engine overrides."""
        idx = torch.as_tensor(lanes, device=self.device)
        for name, stack in self.cache.items():
            for key, dst in stack.items():
                src = staged.cache[name][key]
                dst[:, idx] = src[:, : len(lanes)].to(dst.dtype)
                self.kv_bytes_moved += (src.element_size() * src.shape[0] * len(lanes)
                                        * math.prod(src.shape[2:]))

    # ----------------------------------------------------------------- tick
    def decode_tick(self) -> dict[int, int]:
        """One batched decode step over all lanes → ``{lane: token}``.
        Every lane decodes (inactive lanes' rows are rewritten by the next
        commit); lengths stop at ``max_len - 1``."""
        if not self.active.any():
            return {}
        dev = self.device
        logits, self.cache = self.arch.decode_step(
            self.params, torch.as_tensor(self.last_token, device=dev), self.cache,
            torch.as_tensor(self.lengths, device=dev))
        nxt = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        self._count_dispatch()
        self.lengths = np.where(self.active,
                                np.minimum(self.lengths + 1, self.max_len - 1),
                                self.lengths).astype(np.int32)
        self.last_token = nxt
        self.decode_steps += 1
        return {int(lane): int(nxt[lane]) for lane in np.nonzero(self.active)[0]}

    def retire(self, lane: int) -> None:
        """Free a lane; it returns to its home pool."""
        self.active[lane] = False
        self.partition.release(lane)

    # ---------------------------------------------------------------- spill
    def spill(self, lane: int, key, template: Optional[str] = None) -> bool:
        """Retire ``lane``, staging its KV rows and decode cursor in the
        host spill pool under ``key`` first.  Returns whether the KV was
        staged (``False``: no pool, or the template is fenced out of it,
        checked before paying the device→host copy)."""
        pool = self.partition.spill
        if pool is None or not pool.accepts(template):
            self.retire(lane)
            return False
        # A copy even on the CPU, where .cpu() would return a view of the
        # lane that later ticks and commits keep writing.
        rows = {name: {k: a[:, lane].to("cpu", copy=True) for k, a in stack.items()}
                for name, stack in self.cache.items()}
        entry = {"rows": rows, "length": int(self.lengths[lane]),
                 "last": int(self.last_token[lane])}
        self.kv_bytes_moved += sum(t.element_size() * t.numel()
                                   for t in _tensors(rows))
        staged = pool.put(key, template, entry)
        self.retire(lane)
        return staged

    def has_spill(self, key) -> bool:
        """Whether ``key`` has staged KV in the spill pool."""
        pool = self.partition.spill
        return pool is not None and key in pool

    def try_restore(self, key, template: Optional[str] = None) -> Optional[int]:
        """Restore ``key``'s spilled KV into a fresh lane and resume its
        decode cursor; returns the lane, or ``None`` on a pool miss or
        when ``template`` has no admissible free lane."""
        pool = self.partition.spill
        if pool is None or key not in pool or self.n_free_for(template) <= 0:
            return None
        entry = pool.take(key)
        if entry is None:
            return None
        lane = self.partition.alloc(template)
        rows = entry["rows"]
        self.kv_bytes_moved += sum(t.element_size() * t.numel()
                                   for t in _tensors(rows))
        for name, stack in self.cache.items():
            for k, dst in stack.items():
                dst[:, lane] = rows[name][k].to(self.device, dst.dtype)
        self.lengths[lane] = entry["length"]
        self.last_token[lane] = entry["last"]
        self.active[lane] = True
        return lane

    @property
    def kv(self):
        """The engine's :class:`~repro_torch.serving.kv.KVView`."""
        return self.partition

    @property
    def n_free(self) -> int:
        """Total free lanes across every pool."""
        return self.partition.n_free

    def n_free_for(self, template: Optional[str]) -> int:
        """Free lanes admissible for ``template`` right now."""
        return self.partition.n_free_for(template)

    def lane_benefits(self, lane: int, template: Optional[str]) -> bool:
        """Whether retiring ``lane`` would free capacity ``template`` can
        use (the scheduler's speculative sizing hint)."""
        return self.partition.benefits(lane, template)

    @property
    def free_lanes(self) -> list[int]:
        """Sorted snapshot of every free lane."""
        return self.partition.free_lanes


def _tensors(tree):
    """Every tensor in a nest of dicts, tuples and ``None``s."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
