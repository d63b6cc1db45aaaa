"""Lock-sharding primitives for the runtime's hot path.

The paper's premise is that asynchronous submission wins only when
submission itself is cheap.  A runtime that funnels every ``submit`` /
``fetch`` / worker pick through ONE ``threading.Lock`` re-serializes the
"asynchronous" path at high producer counts — the Fig. 5/8 plateau, but
caused by the client library instead of the server.  These primitives let
the :class:`~repro.core.runtime.AsyncQueryRuntime` shard its
synchronization to match its already-sharded data:

* :class:`ShardedCounter` — an add-mostly counter striped across N locks
  keyed by the calling thread, so 32 producers bumping ``stats.submitted``
  do not convoy on one lock.  Reads sum the stripes (racy-consistent,
  exact once writers quiesce) and the object compares/converts like a
  number so existing ``stats.x == n`` call sites keep working.
* :class:`ReadyLanes` — a duplicate-suppressing MPMC queue of lane keys
  that have pending work.  Workers block here instead of polling a global
  condition variable and scanning idle lanes; a push wakes at most one
  parked worker.  An optional ``select`` callable (the policy's
  weighted-fair ``lane_min``) picks which ready lane a pop returns.
* :class:`QuotaGate` — a counted admission gate with its own condition
  variable.  Submissions blocked on a tenant/lane/global bound sleep on
  THAT bound's CV and are woken by the release that frees a slot — no
  fixed-interval polling anywhere in the quota path.

Lock-ordering rules for users of this module are documented in
ROADMAP.md ("Locking model").
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Iterable, Optional

__all__ = ["ShardedCounter", "ReadyLanes", "QuotaGate"]


def _as_number(x):
    return x.value if isinstance(x, ShardedCounter) else x


class ShardedCounter:
    """Per-thread-celled add-mostly counter.

    Each writer thread owns a private cell (created on first ``add``), so
    ``cell[0] += n`` is a single-writer update — no lock on the hot path at
    all; the GIL makes the in-place add safe and the only lock is taken
    once per (thread, counter) pair to register the cell.  ``value`` sums
    the cells without locking: each element read is atomic under the GIL,
    so the sum is racy-consistent while writers are active and exact once
    they stop.

    Cell count is capped (``MAX_CELLS``): once that many writer threads
    have registered, later threads fall back to one shared lock-guarded
    overflow cell, so thread-churn deployments (thread-per-request
    producers) bound both memory and the O(cells) cost of ``value`` reads
    instead of leaking a cell per dead thread.

    Instances behave like numbers for comparison/arithmetic so stats
    fields can switch from plain ints without breaking callers.
    """

    __slots__ = ("_local", "_cells", "_lock", "_overflow")

    MAX_CELLS = 64

    def __init__(self):
        self._local = threading.local()
        self._cells: list = []
        self._lock = threading.Lock()
        self._overflow = [0]

    def add(self, n=1) -> None:
        try:
            cell = self._local.cell
        except AttributeError:
            with self._lock:
                if len(self._cells) < self.MAX_CELLS:
                    cell = [0]
                    self._cells.append(cell)
                else:
                    cell = None  # cell budget spent: use the shared cell
            self._local.cell = cell
        if cell is not None:
            cell[0] += n  # single writer per cell: GIL-atomic, no lock
        else:
            with self._lock:
                self._overflow[0] += n

    @property
    def value(self):
        return sum(c[0] for c in self._cells) + self._overflow[0]

    # ---- number-like views (stats consumers treat counters as numbers)
    def __int__(self):
        return int(self.value)

    def __float__(self):
        return float(self.value)

    def __index__(self):
        return int(self.value)

    def __bool__(self):
        return self.value != 0

    def __eq__(self, other):
        return self.value == _as_number(other)

    # Defining __eq__ sets __hash__ to None (unhashable); counters compare
    # by value but must still be usable as dict keys / set members (e.g. a
    # stats registry keyed by counter object), so restore identity hashing.
    # Value-based hashing would be wrong: the value mutates under add().
    __hash__ = object.__hash__

    def __ne__(self, other):
        return self.value != _as_number(other)

    def __lt__(self, other):
        return self.value < _as_number(other)

    def __le__(self, other):
        return self.value <= _as_number(other)

    def __gt__(self, other):
        return self.value > _as_number(other)

    def __ge__(self, other):
        return self.value >= _as_number(other)

    def __add__(self, other):
        return self.value + _as_number(other)

    __radd__ = __add__

    def __sub__(self, other):
        return self.value - _as_number(other)

    def __rsub__(self, other):
        return _as_number(other) - self.value

    def __mul__(self, other):
        return self.value * _as_number(other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self.value / _as_number(other)

    def __rtruediv__(self, other):
        return _as_number(other) / self.value

    def __repr__(self):
        return f"ShardedCounter({self.value})"


class ReadyLanes:
    """Duplicate-suppressing queue of lane keys with pending work.

    ``push`` is idempotent while the key is queued (membership set), so a
    burst of submissions to one lane costs one queue slot and at most one
    worker wakeup.  ``pop`` blocks until a key is available or the queue
    is closed; with ``select`` (e.g. the policy's weighted-fair
    ``lane_min``) the lowest-virtual-time ready lane is returned instead
    of FIFO.  FIFO pop + re-push at the tail is round-robin over busy
    lanes, matching the old global-lock scan order without ever visiting
    an idle lane.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._member: set = set()
        self._waiters = 0
        self._closed = False

    def push(self, key) -> None:
        with self._cv:
            if key not in self._member:
                self._member.add(key)
                self._queue.append(key)
                if self._waiters:
                    # Only wake a parked worker; busy workers re-check the
                    # queue before they ever wait, so skipping the notify
                    # when nobody is parked loses no wakeup and spares the
                    # futex traffic of notifying into a busy pool.
                    self._cv.notify()

    def push_all(self, keys: Iterable) -> None:
        with self._cv:
            added = 0
            for key in keys:
                if key not in self._member:
                    self._member.add(key)
                    self._queue.append(key)
                    added += 1
            if added and self._waiters:
                self._cv.notify(added)

    def peek(self, select: Optional[Callable[[list], Any]] = None):
        """The key :meth:`pop` would return next, WITHOUT removing it (or
        ``None`` when no lane is ready).  Never blocks.

        This is the speculation primitive: the serving scheduler peeks the
        next ready lane while a decode tick runs and dispatches its prefill
        early, but the lane stays queued — so if the speculative take turns
        out to be 0 (strategy says wait, no KV capacity) nothing has to be
        re-pushed and the lane keeps its FIFO position.  A later ``pop``
        with the same ``select`` returns the same key as long as no push /
        pop / weight change intervened (single-threaded schedulers get this
        for free; concurrent users must treat the peek as a hint).
        """
        with self._lock:
            if not self._queue:
                return None
            if select is None or len(self._queue) == 1:
                return self._queue[0]
            return select(list(self._queue))

    def pop(self, select: Optional[Callable[[list], Any]] = None,
            block: bool = True):
        """Next ready lane key, or ``None`` when closed (or empty with
        ``block=False``).  ``select`` picks ONE key from the current ready
        keys (e.g. the policy's O(n) weighted-fair ``lane_min``) — a
        single selection, not a sort, since only the winner is popped."""
        with self._cv:
            while True:
                if self._queue:
                    if select is None or len(self._queue) == 1:
                        key = self._queue.popleft()
                    else:
                        key = select(list(self._queue))
                        self._queue.remove(key)
                    self._member.discard(key)
                    return key
                if self._closed or not block:
                    return None
                self._waiters += 1
                try:
                    self._cv.wait()
                finally:
                    self._waiters -= 1

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self):
        with self._lock:
            return len(self._queue)

    def __contains__(self, key):
        with self._lock:
            return key in self._member


class QuotaGate:
    """Counted admission slots behind one condition variable.

    One gate per bound (a tenant, a lane, or the global ``max_pending``):
    a submission blocked at ITS bound sleeps on that bound's CV and is
    woken by :meth:`release` when a slot frees — never by a timer.  The
    100 ms busy-poll this replaces woke every blocked producer every tick
    whether or not anything changed.
    """

    __slots__ = ("_cv", "count", "_waiters", "dead")

    def __init__(self):
        self._cv = threading.Condition()
        self.count = 0
        self._waiters = 0
        self.dead = False  # retired out of its registry (see try_gc)

    def try_acquire(self, limit: Optional[int]) -> bool:
        """Take one slot iff under ``limit`` (``None`` = unbounded)."""
        with self._cv:
            if limit is not None and self.count >= limit:
                return False
            self.count += 1
            return True

    def release(self, n: int = 1) -> None:
        with self._cv:
            self.count -= n
            if self._waiters:
                # One freed slot admits one waiter — and a woken waiter
                # that gives the slot back (multi-gate retry) re-notifies
                # on ITS release, so the chain never under-wakes.  Waking
                # everyone per slot would be the thundering herd this
                # module exists to remove.
                self._cv.notify(n)

    def wait_below(self, limit: int, should_stop: Callable[[], bool]) -> None:
        """Sleep until ``count < limit`` might hold (woken by release), the
        gate is retired, or ``should_stop()``.  The caller re-runs its
        acquire protocol after waking — this is a signal, not a
        reservation (and a retired gate's releases happen on its registry
        successor, so waiting on one would strand the waiter)."""
        with self._cv:
            self._waiters += 1
            try:
                while (self.count >= limit and not self.dead
                       and not should_stop()):
                    self._cv.wait()
            finally:
                self._waiters -= 1

    def try_gc(self) -> bool:
        """Retire the gate iff it is idle (no slots held, no waiters): the
        owner may then drop it from its registry.  ``dead`` is set in the
        same critical section, so a thread that reaches ``wait_below``
        with a stale reference returns immediately instead of sleeping on
        a CV nothing will ever signal; a stale ``try_acquire`` is caught
        by the owner re-validating the registry entry after acquiring."""
        with self._cv:
            if self.count == 0 and self._waiters == 0:
                self.dead = True
                return True
            return False

    def notify_all(self) -> None:
        """Wake every waiter (shutdown path)."""
        with self._cv:
            self._cv.notify_all()

    def __repr__(self):
        return f"QuotaGate(count={self.count})"
