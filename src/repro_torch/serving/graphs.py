"""Compiled engine dispatches: the port's counterpart of ``jax.jit``.

The reference compiles each fixed-shape engine dispatch into one XLA
program (``_decode``, ``_extend``, ``_paged``, ``_fused``,
``_shared_tail``), so a dispatch costs one launch.  The port issued every
op of those programs from Python instead.  A :class:`CompiledStep` owns:

* static input buffers (:class:`StaticInputs`): one flat int32 tensor on
  the device, cut into named views of int32, float32 or int64, filled from
  one host array by a single copy per call, or written on the device;
* a step function written only against those buffers and against tensors
  whose address is fixed for the step's life (an engine's cache, a
  staging cache);
* on the card, one ``torch.cuda.CUDAGraph`` of that function, replayed on
  the current stream;
* the capture's launch tally (:func:`repro_torch.kernels.registry.
  capture_tally`), added to the kernels' counts once per replay.

Capture follows PyTorch's rules for graphs: the function first runs once
on a side stream (kernel libraries load, ``configure_kernel`` raises its
shared-memory limits, cuBLAS sets up), then runs under capture on
PyTorch's capture stream.  The warm-up is set-up, as a compilation is:
the tensors the function writes hold zeros when the step is built (a new
engine's cache, a staging cache, the buffers) and are zeroed again after
it, so capturing changes no state and needs no copy of an engine's
cache, and its launches go into a tally that is dropped, not into the
counts, which keep counting the launches of dispatches only.  Captures hold one process-wide lock, since
only one capture may be underway at a time; their error mode is
``thread_local``, so another thread's launches and allocations during a
capture are legal.  The garbage collector is held off while a step
captures: a collection could free an older engine's graph, whose
teardown is illegal while a stream captures and spoils the capture.

Graphs that share a memory pool may reuse each other's intermediates, so
they must never run at the same time, and each one's outputs must be read
before another graph of the pool replays.  An engine gives the graphs it
replays on one stream one pool (:func:`new_pool`) and the graph it
replays on its own stream another.

Dispatches whose shape is known only when they come (the engines'
prefill, one per pinned bucket; ``ModelService``'s forwards, one per
parameter shape) keep their steps in a :class:`StepCache`: a step is
built, and on the card captured, at its key's first use, from whichever
thread uses it first.  The steps of one cache share one hold and one pool,
and every caller copies what it keeps out of the outputs before it
releases the hold.

On CPU operands there is no graph: the step runs its function directly on
the same buffers, so the CPU tests exercise the static-buffer plumbing.
:func:`eager` (the counterpart of ``jax.disable_jit``) does the same on
the card, process-wide, for as long as it is open.  Nothing switches to
eager on its own: a capture or a replay that fails raises.
"""
from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.kernels import registry

__all__ = ["CompiledStep", "StaticInputs", "StepCache", "eager", "is_eager", "new_pool"]

_CAPTURE_LOCK = threading.Lock()
_EAGER_LOCK = threading.Lock()
_EAGER_DEPTH = 0


@contextlib.contextmanager
def eager():
    """Run every :class:`CompiledStep` as plain PyTorch ops while open, on
    every thread (the speculation thread's chunks included).  It changes
    how steps run, not how they are built: a step built inside it is
    captured all the same."""
    global _EAGER_DEPTH
    with _EAGER_LOCK:
        _EAGER_DEPTH += 1
    try:
        yield
    finally:
        with _EAGER_LOCK:
            _EAGER_DEPTH -= 1


def is_eager() -> bool:
    """Whether :func:`eager` is open."""
    return _EAGER_DEPTH > 0


def new_pool(device: torch.device):
    """A graph memory pool for the steps one stream replays (``None`` on
    the CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.graph_pool_handle()


class StaticInputs:
    """Named int32, float32 or int64 views of one flat int32 device buffer
    and of its host twin; :meth:`put` writes the host twin, :meth:`upload`
    copies it to the device in one transfer.  ``spec`` maps each name to
    its shape, or to ``(shape, dtype)``; an int64 view starts at an even
    entry."""

    def __init__(self, spec: dict, device: torch.device):
        layout, at = {}, 0
        for name, s in spec.items():
            shape, dtype = s if _is_typed(s) else (s, torch.int32)
            words = _WORDS.get(dtype)
            if words is None:
                raise ValueError(f"{name}: static inputs are int32, float32 or int64")
            at += at % words
            layout[name] = (at, shape, dtype)
            at += words * _numel(shape)
        self.flat = torch.zeros((at,), dtype=torch.int32, device=device)
        self.host = np.zeros(self.flat.shape, np.int32)
        self._views, self._host_views = {}, {}
        for name, (start, shape, dtype) in layout.items():
            n = _WORDS[dtype] * _numel(shape)
            dev, host = self.flat[start: start + n], self.host[start: start + n]
            if dtype != torch.int32:
                dev, host = dev.view(dtype), host.view(_NUMPY[dtype])
            self._views[name] = dev.view(shape)
            self._host_views[name] = host.reshape(shape)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._views[name]

    def host_view(self, name: str) -> np.ndarray:
        """The host twin of ``name``, written in place before :meth:`upload`."""
        return self._host_views[name]

    def put(self, name: str, values) -> None:
        """Write ``values`` into the host twin of ``name`` (leading entries
        of its first axis when shorter)."""
        values = np.asarray(values)
        self._host_views[name][: len(values)] = values

    def upload(self, n: Optional[int] = None) -> None:
        """Copy the first ``n`` entries (default all) of the host twin into
        the device buffer, on the current stream."""
        n = self.host.shape[0] if n is None else n
        self.flat[:n].copy_(torch.from_numpy(self.host[:n]))


_WORDS = {torch.int32: 1, torch.float32: 1, torch.int64: 2}
_NUMPY = {torch.float32: np.float32, torch.int64: np.int64}


class _Hold:
    """A re-entrant lock, and on the card the event after its last
    holder's work: what :meth:`CompiledStep.exclusive` holds."""

    def __init__(self):
        self.lock = threading.RLock()
        self.done = None


@contextlib.contextmanager
def _no_collection():
    """Hold off automatic garbage collection (module docstring)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _leaves(out) -> tuple:
    """A step's outputs as a tuple of tensors."""
    return out if isinstance(out, tuple) else (out,)


def _is_typed(s) -> bool:
    return len(s) == 2 and isinstance(s[1], torch.dtype)


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


class CompiledStep:
    """One fixed-shape dispatch over static buffers (module docstring).

    ``fn()`` reads ``inputs`` and writes only tensors in ``state`` (besides
    ``inputs`` themselves), which hold zeros when the step is built, and
    returns its outputs, a tensor or a tuple of them.  On the card the
    outputs are the graph's own tensors, overwritten by the next call,
    replayed or under :func:`eager`: read them first.  ``pool``
    is :func:`new_pool`'s handle, or ``None`` for a pool of its own.
    Construction captures on the card.
    :meth:`exclusive` serialises callers that share the step across
    threads; steps given one ``hold`` (a :class:`StepCache`'s) serialise
    together.
    """

    def __init__(self, fn: Callable, inputs: StaticInputs,
                 state: Iterable[torch.Tensor], device: torch.device, pool=None,
                 hold: Optional[_Hold] = None):
        self.fn = fn
        self.inputs = inputs
        self.state = [inputs.flat, *state]
        self.device = device
        self.pool = pool
        self.hold = hold if hold is not None else _Hold()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tally: dict = {}   # launches a replay makes
        self.replays = 0        # replays of the captured graph
        self.out = None
        if device.type == "cuda":
            self._capture()

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def _capture(self) -> None:
        """Warm up on a side stream, zero the state again, and capture
        ``fn`` as one CUDA graph with its launch tally (module docstring)."""
        cur = torch.cuda.current_stream(self.device)
        with _CAPTURE_LOCK, torch.no_grad(), _no_collection():
            if any(bool(t.any()) for t in self.state):
                raise ValueError("a compiled step's state must hold zeros when it is built")
            side = torch.cuda.Stream(device=self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side), registry.capture_tally():
                self.fn()
            cur.wait_stream(side)
            for t in self.state:
                t.zero_()
            graph = torch.cuda.CUDAGraph()
            with registry.capture_tally() as tally:
                with torch.cuda.graph(graph, pool=self.pool,
                                      capture_error_mode="thread_local"):
                    out = self.fn()
        self.graph, self.tally, self.out = graph, tally, out

    def __call__(self):
        """Run the step once: a replay on the card, the function itself on
        the CPU or under :func:`eager`."""
        if self.device.type != "cuda" or is_eager():
            with torch.no_grad():
                out = self.fn()
            if self.graph is None:
                self.out = out
            else:  # the graph's outputs stay the step's: its replays return them
                for o, e in zip(_leaves(self.out), _leaves(out)):
                    o.copy_(e)
            return self.out
        self.graph.replay()
        registry.add_launches(self.tally)
        self.replays += 1
        return self.out

    @contextlib.contextmanager
    def exclusive(self):
        """Hold the step from copy-in to the enqueue of copy-out: its lock,
        and on the card the current stream ordered after the step's last
        exclusive use on any stream."""
        hold = self.hold
        with hold.lock:
            if hold.done is not None:
                torch.cuda.current_stream(self.device).wait_event(hold.done)
            yield self
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                hold.done = done


class StepCache:
    """Compiled steps keyed by a static shape, each built by ``build(key,
    pool, hold)`` at its key's first use (module docstring).  The steps
    share one hold and one graph pool: :meth:`exclusive` holds them all,
    and what a caller keeps of a step's outputs it copies out before the
    hold ends."""

    def __init__(self, build: Callable, device: torch.device):
        self._build = build
        self.device = device
        self.pool = new_pool(device)
        self.hold = _Hold()
        self.steps: dict = {}

    @contextlib.contextmanager
    def exclusive(self, key):
        """Hold every step of the cache and yield ``key``'s, built first if
        it is new."""
        with self.hold.lock:
            step = self.steps.get(key)
            if step is None:
                step = self.steps[key] = self._build(key, self.pool, self.hold)
            with step.exclusive():
                yield step

    @property
    def replays(self) -> int:
        """Replays of every step's graph so far."""
        return sum(s.replays for s in self.steps.values())
