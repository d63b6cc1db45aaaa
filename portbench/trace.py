"""The device trace of a window: ``torch.profiler`` over CUDA activity only.

Kernel times come from the profiler's raw events (no per-event Python
objects are built, so a trace of millions of kernels is read in seconds).
Device timestamps are put on the host's ``time.perf_counter`` clock by one
marker: after a synchronise, the host notes the clock and launches a small
fill kernel, the first device event of the trace.  The launch latency (some
microseconds) is the error of that alignment.
"""
from __future__ import annotations

import heapq
import re
import time

__all__ = ["TRACE_SECONDS", "DeviceTrace", "Labeler", "union", "short_name"]

# A ``--trace 1`` run traces the last this many seconds of its window.
TRACE_SECONDS = 10.0


def short_name(name: str) -> str:
    """A kernel's function name without ``void``, template arguments and
    parameters, at most 80 characters."""
    s = name.replace("(anonymous namespace)::", "").split("(")[0]
    s = re.sub(r"^void ", "", s)
    depth, out = 0, []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:80] or name[:80]


def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """Merged intervals clipped to [lo, hi]."""
    merged: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Labeler:
    """Names of the latest-started span open at each of a rising sequence
    of times (a sweep: spans enter by start, the latest-started leaves once
    it has ended)."""

    def __init__(self, spans):
        self._spans = sorted((s[1], s[2], s[0]) for s in spans)
        self._i = 0
        self._open: list = []

    def __call__(self, t: float) -> str:
        while self._i < len(self._spans) and self._spans[self._i][0] <= t:
            a, b, name = self._spans[self._i]
            heapq.heappush(self._open, (-a, b, name))
            self._i += 1
        while self._open and self._open[0][1] < t:
            heapq.heappop(self._open)
        return self._open[0][2] if self._open else "none"


class DeviceTrace:
    """Start and stop a CUDA-only profile; after :meth:`stop`, ``kernels``
    holds (name, start, end) on the host clock and ``t0``/``t1`` the traced
    window.  ``tracer``, the port's ``repro_torch.tracing`` where given, is
    switched on once the window has started; whoever made the trace
    switches it off and collects its spans."""

    def __init__(self, device, tracer=None):
        self.device = device
        self.tracer = tracer
        self.kernels: list[tuple[str, float, float]] = []
        self.by_name: dict[str, float] = {}
        self.t0 = self.t1 = None

    def start(self) -> None:
        self._begin()
        self.t0 = time.perf_counter()
        if self.tracer is not None:
            self.tracer.enable()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self._read()

    def _sync(self) -> None:
        import torch
        torch.cuda.synchronize(self.device)

    def _begin(self) -> None:
        """The profiler on, then the marker: the host's clock noted at the
        launch of the trace's first device event."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        marker = torch.empty(1 << 10, dtype=torch.float32, device=self.device)
        self._sync()
        self._t_marker = time.perf_counter()
        marker.fill_(1.0)
        self._sync()

    def _read(self) -> None:
        """The profiler off, and its device events in the window on the
        host's clock."""
        import torch

        self._prof.stop()
        names: dict[str, str] = {}
        events = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            a, b = e.start_ns(), e.end_ns()
            if b > a:
                n = e.name()
                events.append((names.setdefault(n, n), a, b))
        self._prof = None
        if not events:
            return
        first = min(events, key=lambda ev: ev[1])
        offset = first[1] * 1e-9 - self._t_marker
        self.kernels = [(name, a * 1e-9 - offset, b * 1e-9 - offset)
                        for name, a, b in events if a * 1e-9 - offset >= self.t0]
        self.kernels.sort(key=lambda k: k[1])
        for n, a, b in self.kernels:
            self.by_name[n] = self.by_name.get(n, 0.0) + (min(b, self.t1) - a)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> list[tuple[float, float]]:
        return union(((a, b) for _n, a, b in self.kernels), self.t0, self.t1)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def matching(self, pattern: str) -> float:
        """Seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for n, s in self.by_name.items() if rx.search(n))

    def breakdown(self, spans, top: int = 10) -> dict:
        """The device operations that took most time, each named by its
        kernel and the benchmark span open when it started, and the idle
        time between device operations by the span open on the host."""
        ops: dict[str, float] = {}
        short = {n: short_name(n) for n in self.by_name}
        label = Labeler(spans)
        for n, a, b in self.kernels:
            key = f"{short[n]}@{label(a)}"
            ops[key] = ops.get(key, 0.0) + (min(b, self.t1) - a)
        gaps: dict[str, float] = {}
        prev = self.t0
        label = Labeler(spans)
        for a, b in self.busy() + [(self.t1, self.t1)]:
            if a > prev:
                key = label(0.5 * (a + prev))
                gaps[key] = gaps.get(key, 0.0) + (a - prev)
            prev = max(prev, b)

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}
