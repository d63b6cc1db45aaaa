"""LoopContextTable — Rule A's ``Table t`` (§3.2) and §5.1's blocking queue.

The port's copy of :mod:`repro.core.loop_context` (pure Python, kept
verbatim so that the port imports nothing of the JAX package).

Two modes:

* ``blocking=False`` — the basic Rule A context table: an ordered store the
  producer fills completely before the consumer iterates (``for each r in t
  order by t.key``).
* ``blocking=True`` — the §5.1 overlap variant: a bounded blocking
  producer/consumer queue.  The producer thread ``put``s records; the
  consumer iterates as records arrive; ``close()`` marks the end.  A bounded
  ``maxsize`` implements the paper's §8 memory-overhead mitigation (the
  producer backs off while results are consumed and memory freed).
"""
from __future__ import annotations

import queue as _queue
import threading
from typing import Any, Iterator, Optional

__all__ = ["LoopContextTable"]

_CLOSED = object()


class LoopContextTable:
    def __init__(self, blocking: bool = False, maxsize: Optional[int] = None):
        self.blocking = blocking
        if blocking:
            self._q: _queue.Queue = _queue.Queue(maxsize=maxsize or 0)
        else:
            self._items: list[Any] = []
        self._closed = False
        self._key = 0
        self._lock = threading.Lock()

    # -- producer side --------------------------------------------------------
    def put(self, record: Any) -> int:
        """Append a record; returns its loop key (``r.key = loopkey++``)."""
        with self._lock:
            if self._closed and not self.blocking:
                raise RuntimeError("LoopContextTable is closed")
            key = self._key
            self._key += 1
        if self.blocking:
            self._q.put((key, record))
        else:
            self._items.append((key, record))
        return key

    def close(self) -> None:
        self._closed = True
        if self.blocking:
            self._q.put(_CLOSED)

    def __len__(self) -> int:
        with self._lock:
            return self._key

    # -- consumer side --------------------------------------------------------
    def __iter__(self) -> Iterator[Any]:
        """Yield records in key order (``order by t.key``)."""
        if self.blocking:
            while True:
                item = self._q.get()
                if item is _CLOSED:
                    return
                _key, record = item
                yield record
        else:
            if not self._closed:
                raise RuntimeError(
                    "non-blocking LoopContextTable iterated before close(); "
                    "the basic Rule A consumer must start after the producer"
                )
            for _key, record in sorted(self._items, key=lambda kr: kr[0]):
                yield record

    def delete(self) -> None:
        """``delete t;`` — free the table (Rule A's last statement)."""
        if self.blocking:
            try:
                while True:
                    self._q.get_nowait()
            except _queue.Empty:
                pass
        else:
            self._items.clear()
