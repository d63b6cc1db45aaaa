"""Spans of the port's layers, kept in memory, on ``time.perf_counter``.

Off by default.  While off, :func:`span` returns one shared no-op object:
no clock is read and nothing is kept.  :func:`enable` switches recording
on; from then every span records its name, start and end, the thread it
ran on, its own id, its parent's id and its data, into a list of its
thread's, and :func:`collect` returns every thread's recorded spans and
clears them.  Nothing is written anywhere: whoever enables the tracer
collects what it recorded.

A span's parent is the innermost span open on its thread when it opens,
unless ``parent=`` names one.  A thread started for a span's work takes
that span as the parent of its own (:func:`handoff`).  A wait that starts
on one thread and ends on another is noted by :func:`start` under a key
and recorded by :func:`finish` under the same key.

The clock is the one the device trace of a profiled run is put on, so a
device interval and the host span open around it compare directly.  Where
a call site reads that clock around the same work already, it passes its
readings (``start=``, :func:`end_at`) instead of reading it again.  Call
sites that would build data for a span (lists of lengths or ids) build it
only under ``if tracing.enabled():``.

The spans, by layer (children indented):

* scheduler, ``ContinuousBatchingScheduler.tick``: ``scheduler.tick``
  (the tick's number; the requests it admitted inline, committed from
  speculation and aborted) ⊃ ``scheduler.settle`` (the speculative
  commits), ``scheduler.admit``, ``scheduler.speculate``,
  ``scheduler.decode``, ``scheduler.finish`` (tokens, retirement,
  timeouts);
* engine, ``decode_tick``: ``decode.tick`` (the active lanes' positions)
  ⊃ ``decode.prep`` (the host's work before the launch), ``decode.launch``,
  ``decode.wait`` (the wait for the tokens);
* engine, ``prefill_dispatch`` and ``prefill_resume`` (on the speculation
  thread, its parent the ``scheduler.speculate`` or ``scheduler.settle``
  that spawned it): ``prefill.dispatch`` (request ids, prompt lengths, the
  padded bucket; ``resume`` for a chunk) ⊃ ``prefill.pad``,
  ``prefill.hold`` (the wait for the steps' hold), ``prefill.launch``;
* engine, ``commit_prefill``: ``prefill.commit`` (request ids, ``n``) ⊃
  ``commit.wait`` (the wait for the first tokens), ``commit.insert``;
* compiled dispatches, a ``CompiledStep``'s first call on the card:
  ``graph.build`` (the step's function and key);
* query runtime: ``runtime.queued`` (a handle key, from its submission
  until a worker takes it into a batch), ``runtime.batch`` (lane, size,
  keys; the service call and the fan-out); ``SchedulerQueryService``:
  ``bridge.drive`` (request ids, cohort size) ⊃ ``bridge.lock_wait``.
"""
from __future__ import annotations

import threading
import time

__all__ = ["Span", "collect", "disable", "enable", "enabled", "end_at", "finish",
           "handoff", "span", "start"]

_on = False
_local = threading.local()
_lock = threading.Lock()
_threads: list = []   # the _Thread of every thread that has recorded a span
_slots = [0]          # the next thread's slot: the high bits of its span ids
_started: dict = {}   # key -> the reading of start(key), until finish(key)


class Span:
    """One recorded interval: ``name``, ``start`` and ``end`` (seconds of
    ``time.perf_counter``), ``thread`` (``threading.get_ident()``), ``id``,
    ``parent`` (an id, or ``None``) and ``data`` (a dict)."""

    __slots__ = ("name", "start", "end", "thread", "id", "parent", "data")

    def __init__(self, name: str, parent, start, data: dict):
        self.name = name
        self.start = start
        self.end = None
        self.thread = None
        self.id = None
        self.parent = parent.id if parent is not None else None
        self.data = data

    def set(self, **data) -> None:
        """Add to the span's data."""
        self.data.update(data)

    def _open(self, st: "_Thread") -> None:
        if self.parent is None and st.stack:
            self.parent = st.stack[-1].id
        self.id = st.next_id
        st.next_id += 1
        self.thread = st.ident

    def __enter__(self) -> "Span":
        st = _thread()
        self._open(st)
        st.stack.append(self)
        if self.start is None:
            self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.end is None:
            self.end = time.perf_counter()
        st = _thread()
        st.stack.pop()
        st.done.append(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start!r}, {self.end!r}, id={self.id}, "
                f"parent={self.parent}, data={self.data!r})")


class _Noop:
    """What :func:`span` returns while tracing is off."""

    __slots__ = ()
    data: dict = {}  # read-only: set() keeps nothing

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **data) -> None:
        pass


_NOOP = _Noop()


class _Thread:
    """One thread's open spans, its recorded ones and its next span id."""

    __slots__ = ("stack", "done", "ident", "thread", "next_id")

    def __init__(self, slot: int):
        self.thread = threading.current_thread()
        cause = getattr(self.thread, "_tracing_cause", None)
        self.stack: list = [cause] if cause is not None else []
        self.done: list = []
        self.ident = threading.get_ident()
        self.next_id = slot << 32


def _thread() -> _Thread:
    st = getattr(_local, "state", None)
    if st is None:
        with _lock:
            st = _local.state = _Thread(_slots[0])
            _slots[0] += 1
            _threads.append(st)
    return st


def enable() -> None:
    """Record spans from now on, on every thread."""
    global _on
    _started.clear()
    _on = True


def disable() -> None:
    """Stop recording; spans already open still record when they close."""
    global _on
    _on = False


def enabled() -> bool:
    """Whether spans are being recorded."""
    return _on


def span(name: str, /, parent=None, start=None, **data):
    """A context manager that records ``name`` from its entry (or from the
    reading ``start``) to its exit, with ``data``; its parent is
    ``parent`` (a :class:`Span`) or the innermost span open on the thread.
    While tracing is off: the shared no-op object."""
    if not _on:
        return _NOOP
    return Span(name, parent, start, data)


def end_at(name: str, t: float) -> None:
    """End the innermost open span of this thread, if it is ``name``, at
    the reading ``t`` instead of a reading at its close."""
    if _on:
        stack = _thread().stack
        if stack and stack[-1].name == name:
            stack[-1].end = t


def handoff(thread: threading.Thread) -> None:
    """Make the innermost span open here the parent of the spans that
    ``thread`` (not started yet) opens."""
    if _on:
        stack = _thread().stack
        if stack:
            thread._tracing_cause = stack[-1]


def start(key, /) -> None:
    """Note the clock under ``key`` (any hashable) for :func:`finish`."""
    if _on:
        _started[key] = time.perf_counter()


def finish(key, name: str, /, **data) -> None:
    """Record ``name`` from the reading :func:`start` noted under ``key``
    until now, on this thread, under its innermost open span; nothing if
    no reading is noted."""
    t0 = _started.pop(key, None)
    if t0 is None or not _on:
        return
    s = Span(name, None, t0, data)
    st = _thread()
    s._open(st)
    s.end = time.perf_counter()
    st.done.append(s)


def collect() -> list:
    """Every span recorded so far, on every thread, by start; the tracer
    keeps none of them.  Spans still open are not included."""
    out: list = []
    with _lock:
        keep = []
        for st in _threads:
            n = len(st.done)
            out.extend(st.done[:n])
            del st.done[:n]
            if st.thread.is_alive() or st.done:
                keep.append(st)
        _threads[:] = keep
    out.sort(key=lambda s: s.start)
    return out
