"""Compiled dispatches: the port's counterpart of ``jax.jit``.

The reference compiles each fixed-shape dispatch into one XLA program
(the engines' ``_decode``, ``_extend``, ``_paged``, ``_fused``,
``_shared_tail``, and ``train_step``), so a dispatch costs one launch.
The port issued every op of those programs from Python instead.  A
:class:`CompiledStep` owns:

* static input buffers (:class:`StaticInputs`): one flat int32 tensor on
  the device, cut into named views of int32, float32 or int64, filled from
  one host array by a single copy per call, or written on the device;
* a step function written only against those buffers and against tensors
  whose address is fixed for the step's life (an engine's cache, a
  staging cache, a train step's parameters and moments);
* on the card, one ``torch.cuda.CUDAGraph`` of that function, replayed on
  the current stream;
* the recording's launch tally (:func:`repro_torch.kernels.registry.
  capture_tally`), added to the kernels' counts once per replay.

**The first call is the dispatch itself**, as a ``jax.jit`` function's
first call traces, compiles and runs once.  On the card the step's first
call runs the function for real, on the current stream, and its outputs
are that call's answer; its launches are a dispatch's and are counted.
That run is also the warm-up PyTorch asks of a graph: kernel libraries
load, ``configure_kernel`` raises its shared-memory limits, cuBLAS sets
up.  Right after that run the function is recorded as the graph for the
calls after it, each of which replays it.  Recording executes nothing, so
no state is written twice and none has to be zero when the step is
built, and every launch count equals :func:`eager`'s exactly.  A first
call whose recording fails has already written the state; it raises, and
so does every later call, without running the function again.

A recording holds one process-wide lock, so one capture is underway at a
time, on a capture stream of its own for each stream steps replay on (a
step is called on the stream of its first call). cuBLAS takes its
workspace per (handle, stream), and a graph keeps the workspace of its
recording: graphs recorded on one stream by one thread, a tick and a
prefill say, would share one workspace, and replayed beside each other
on an engine's two streams their matrix products would write each
other's partial sums (wrong tokens, and on the card a hang). With a
capture stream per replay stream, graphs that share a workspace replay
on one stream, one after the other. The capture streams are made through
the driver, not taken from PyTorch's pools, which hand out their 32
streams round robin: a pooled capture stream could be another engine's
stream or another replay stream's capture stream. The recording's error
mode is ``thread_local``, so another thread's launches and allocations
meanwhile are legal, and the kernels autograd's device thread launches
on the capture stream (a train step's backward) go into its tally. The
garbage collector is held off while a step records: a collection could
free an older engine's graph, whose teardown is illegal while a stream
captures and spoils the capture. A step runs and records under
``torch.no_grad()`` unless it is built with ``grad=True`` (a train step
takes its gradients inside); one built with ``release=True`` empties the
allocator's cache before it records, so the first call's freed
temporaries do not stay reserved beside the graph's pool.

Graphs that share a memory pool may reuse each other's intermediates, so
they must never run at the same time, and each one's outputs must be read
before another graph of the pool replays.  An engine gives the graphs it
replays on one stream one pool (:func:`new_pool`) and the graph it
replays on its own stream another.

Dispatches whose shape is known only when they come (the engines'
prefill, one per pinned bucket; ``ModelService``'s forwards, one per
parameter shape; a train step, one per batch signature) keep their steps
in a :class:`StepCache`: a step is built at its key's first use, from
whichever thread uses it first.  The steps of one cache share one hold
and one pool, and every caller copies what it keeps out of the outputs
before it releases the hold.

On CPU operands there is no graph: the step runs its function directly on
the same buffers, so the CPU tests exercise the static-buffer plumbing.
:func:`eager` (the counterpart of ``jax.disable_jit``) does the same on
the card, process-wide, for as long as it is open.  Nothing switches to
eager on its own: a recording or a replay that fails raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import registry

__all__ = ["CompiledStep", "StaticInputs", "StepCache", "eager", "is_eager", "new_pool"]

_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: dict = {}  # (device index, replay stream) -> the stream its steps record on
_EAGER_LOCK = threading.Lock()
_EAGER_DEPTH = 0


@contextlib.contextmanager
def eager():
    """Run every :class:`CompiledStep` as plain PyTorch ops while open, on
    every thread (the speculation thread's chunks included).  A step
    called inside it neither records nor replays: its first call outside
    it is its first call."""
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


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream the steps that replay on the current stream record on
    (module docstring), made at its first use."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    stream = _CAPTURE_STREAMS.get(key)
    if stream is None:
        stream = _CAPTURE_STREAMS[key] = _new_stream(device)
    return stream


def _new_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """A non-blocking stream of this module's own, made through the driver
    in the calling thread's current context (the thread has run the step
    once already)."""
    create = ctypes.CDLL("libcuda.so.1").cuStreamCreate
    create.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint]
    create.restype = ctypes.c_int
    handle = ctypes.c_void_p()
    with torch.cuda.device(device):
        code = create(ctypes.byref(handle), 1)  # CU_STREAM_NON_BLOCKING
    if code != 0:
        raise RuntimeError(f"cuStreamCreate failed with CUresult {code}")
    return torch.cuda.ExternalStream(handle.value, device=device)


def _leaves(out) -> tuple:
    """A step's outputs as a tuple of tensors."""
    return out if isinstance(out, tuple) else (out,)


def _is_typed(s) -> bool:
    return len(s) == 2 and isinstance(s[1], torch.dtype)


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


class CompiledStep:
    """One fixed-shape dispatch over static buffers (module docstring).

    ``fn()`` reads ``inputs`` and tensors whose address is fixed, writes
    only ``state`` (the tensors it writes besides ``inputs``; any values)
    and returns its outputs, a tensor or a tuple of them.  On the card the
    first call returns the outputs of a real run and every replay the
    graph's own tensors, overwritten by the next replay: read them first.
    ``out`` is the last call's outputs.  ``pool`` is :func:`new_pool`'s
    handle, or ``None`` for a pool of its own.  ``grad`` lets ``fn`` take
    gradients (the default runs it under ``torch.no_grad()``);
    ``release`` empties the allocator's cache before the recording.
    :meth:`exclusive` serialises callers that share the step across
    threads; steps given one ``hold`` (a :class:`StepCache`'s) serialise
    together.  ``calls`` counts the calls on the card outside
    :func:`eager`, ``replays`` those that replayed; ``parts`` holds the
    host seconds of the first real run and of the recording
    (``"run"``, ``"record"``, ``"instantiate"``), which one ``graph.build``
    span covers, with the step's function's name and ``key`` (a
    :class:`StepCache`'s key, else ``None``).  A first call that
    raises in its recording has already written ``state``; the step is
    then spoilt, and every later call raises without running ``fn``.
    """

    def __init__(self, fn: Callable, inputs: StaticInputs,
                 state: Iterable[torch.Tensor], device: torch.device, pool=None,
                 hold: Optional[_Hold] = None, *, grad: bool = False,
                 release: bool = False):
        self.fn = fn
        self.inputs = inputs
        self.state = [inputs.flat, *state]
        self.device = device
        self.pool = pool if pool is not None else new_pool(device)
        self.hold = hold if hold is not None else _Hold()
        self.grad = grad
        self.release = release
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tally: dict = {}   # launches a replay makes
        self.calls = 0          # calls on the card outside eager()
        self.replays = 0        # of which replays of the recorded graph
        self.parts: dict = {}   # host seconds of the first run and the recording
        self.key = None         # the StepCache key it was built for
        self.out = None
        self._graph_out = None
        self._spoilt: Optional[BaseException] = None  # the recording's error

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def _mode(self):
        return contextlib.nullcontext() if self.grad else torch.no_grad()

    def _run(self):
        with self._mode():
            self.out = self.fn()
        return self.out

    def _record(self) -> None:
        """Record ``fn`` as the step's graph, with its launch tally,
        executing nothing (module docstring).  The process must have run
        the kernels ``fn`` launches once already (its warm-up)."""
        device = self.device
        # the template kept apart, so its instantiation is timed apart
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with _CAPTURE_LOCK, self._mode(), _no_collection():
            stream = _capture_stream(device)
            if self.release:
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            with torch.cuda.stream(stream), registry.capture_tally(stream) as tally:
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    out = self.fn()
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                t1 = time.perf_counter()
                graph.capture_end()
                graph.instantiate()
            t2 = time.perf_counter()
        self.graph, self.tally, self._graph_out = graph, tally, out
        self.parts.update(record=t1 - t0, instantiate=t2 - t1)

    def __call__(self):
        """Run the step once: a replay on the card once recorded, the
        function itself before that, on the CPU or under :func:`eager`."""
        if self.device.type != "cuda" or is_eager():
            return self._run()
        if self._spoilt is not None:
            raise RuntimeError("this step's recording failed; its first call wrote its "
                               "state already") from self._spoilt
        self.calls += 1
        if self.graph is None:
            t0 = time.perf_counter()
            with tracing.span("graph.build", start=t0, step=self.fn.__name__, key=self.key):
                out = self._run()
                self.parts["run"] = time.perf_counter() - t0
                try:
                    self._record()
                except BaseException as e:
                    self._spoilt = e
                    raise
            return out
        self.graph.replay()
        registry.add_launches(self.tally)
        self.replays += 1
        self.out = self._graph_out
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
    pool, hold)`` at its key's first use and run for real at its first
    call (module docstring).  The steps
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
                step.key = key
            with step.exclusive():
                yield step

    @property
    def replays(self) -> int:
        """Replays of every step's graph so far."""
        return sum(s.replays for s in self.steps.values())

    @property
    def calls(self) -> int:
        """Calls of every step on the card outside :func:`eager` so far."""
        return sum(s.calls for s in self.steps.values())
