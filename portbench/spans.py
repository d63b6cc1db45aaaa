"""Host spans the benchmark records around its calls into the port.

A span is (name, start, end, thread, data) on ``time.perf_counter``.  The
port has no spans of its own, so the benchmark wraps the boundaries it
drives: an engine's decode tick and prefill dispatch, a scheduler tick, a
query service's drive.  :func:`wrap` replaces a bound method on one
object only, so nothing of the port's classes changes.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["Spans", "wrap"]


class Spans:
    """Spans in memory, appended from any thread."""

    def __init__(self):
        self.items: list[tuple] = []

    def add(self, name: str, t0: float, t1: float, data=None) -> None:
        self.items.append((name, t0, t1, threading.get_ident(), data))

    def named(self, name: str, t0: float = float("-inf"), t1: float = float("inf")) -> list:
        """Spans of ``name`` that start at or after ``t0`` and end by ``t1``."""
        return [s for s in self.items if s[0] == name and s[1] >= t0 and s[2] <= t1]


def wrap(obj, method: str, spans: Spans, name: str,
         before: Optional[Callable] = None, after: Optional[Callable] = None) -> None:
    """Record a span ``name`` around every call of ``obj.method``.
    ``before(*args, **kw)`` runs first and its value is passed, with the
    call's result, to ``after(state, result, *args, **kw)``, whose value is
    the span's data."""
    inner = getattr(obj, method)

    def call(*args, **kw):
        state = before(*args, **kw) if before is not None else None
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        t1 = time.perf_counter()
        spans.add(name, t0, t1, after(state, out, *args, **kw) if after is not None else state)
        return out

    setattr(obj, method, call)
