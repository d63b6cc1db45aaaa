"""Kernel registry: one dispatch policy for every kernel op of the port.

Port of :mod:`repro.kernels.registry` with the same surface
(``register``/``get``/``names``/``dispatch``, :class:`OpSample`) and a
different policy.  The reference picks its jnp ref whenever the Pallas
kernel cannot run or rejects the shape.  Here dispatch is keyed by the
**device of the operands**, and nothing falls back on the card:

* every tensor operand on the CPU → the op's plain PyTorch version;
* every tensor operand on CUDA → the op's hand-written kernel, or
  ``ValueError`` when ``supports`` rejects the shape/dtype;
* mixed devices → ``ValueError``.

Each kernel wrapper carries an integer ``launches`` attribute that it
raises by one per kernel launch, through :func:`count_launch` (never on
the plain path); :func:`launch_counts` / :func:`reset_launches` read and
clear them, so a run can show that it went through the kernels.  All
three hold one lock: the scheduler's speculation thread and the main
thread launch kernels at the same time, and a bare ``+= 1`` can lose an
update.

A CUDA graph's capture runs the wrappers without launching anything, and
its replays launch without calling them.  So while a thread captures
(:func:`capture_tally`), its ``count_launch`` calls go into that capture's
tally instead of the counts, and each replay adds the tally once
(:func:`add_launches`).  The counts keep meaning launches that ran.  The
tally is per thread: the speculation thread launches while the main
thread may capture, so a before-and-after difference of the counts would
take in the other thread's launches.  A capture that names its stream
also takes the launches of any other thread whose current stream that is:
autograd runs a captured backward on its own device thread, on the
stream the forward ran on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["KernelOp", "OpSample", "register", "get", "names", "dispatch",
           "count_launch", "launch_counts", "reset_launches", "capture_tally",
           "add_launches"]


@dataclasses.dataclass(frozen=True)
class OpSample:
    """One representative invocation for the parity harness.

    ``args`` are positional numpy operands (the tests hand the same arrays
    to the reference package); ``common`` keywords go to both the kernel
    and the plain version.
    """

    args: tuple
    common: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class KernelOp:
    """A registered ``(ref, kernel)`` pair.

    ``ref`` is the plain PyTorch version; ``kernel`` the CUDA wrapper with
    the same positional signature (plus ``common`` keywords).
    ``supports(*args, **kwargs)`` says whether the kernel takes these
    operands.  ``sample(rng)`` builds an :class:`OpSample` from a
    ``numpy.random.Generator``.
    """

    name: str
    ref: Callable
    kernel: Callable
    supports: Callable[..., bool]
    sample: Callable[[np.random.Generator], OpSample]


_OPS: dict[str, KernelOp] = {}
_LAUNCH_LOCK = threading.Lock()
_CAPTURE = threading.local()  # .tally: this thread's capture tally, or None
_STREAM_TALLIES: dict = {}  # capture stream handle -> its capture's tally


def register(name: str, *, ref: Callable, kernel: Callable,
             supports: Callable[..., bool],
             sample: Callable[[np.random.Generator], OpSample]) -> KernelOp:
    """Register one op's ``(ref, kernel)`` pair under ``name``.

    Re-registration with identical callables is a no-op (module reloads);
    conflicting re-registration raises.
    """
    op = KernelOp(name, ref, kernel, supports, sample)
    prev = _OPS.get(name)
    if prev is not None and (prev.ref, prev.kernel) != (ref, kernel):
        raise ValueError(f"kernel op {name!r} already registered with "
                         "different callables")
    _OPS[name] = op
    return op


def get(name: str) -> KernelOp:
    """Look up a registered op (KeyError with the known names on a miss)."""
    try:
        return _OPS[name]
    except KeyError:
        raise KeyError(f"unknown kernel op {name!r}; registered: "
                       f"{sorted(_OPS)}") from None


def names() -> list[str]:
    """Sorted names of every registered op."""
    return sorted(_OPS)


def dispatch(name: str, args: tuple, *, common: Optional[dict] = None):
    """Run ``name`` on ``args``: plain version for CPU operands, kernel for
    CUDA operands (see the module docstring)."""
    op = get(name)
    ck = common or {}
    devices = {a.device.type for a in args if isinstance(a, torch.Tensor)}
    if devices == {"cpu"}:
        return op.ref(*args, **ck)
    if devices != {"cuda"}:
        raise ValueError(f"{name}: operands on devices {sorted(devices)}; "
                         "all must be on the CPU or all on CUDA")
    if not op.supports(*args, **ck):
        shapes = [tuple(a.shape) + (a.dtype,) for a in args
                  if isinstance(a, torch.Tensor)]
        raise ValueError(f"{name}: the CUDA kernel does not take operands "
                         f"{shapes} {ck}")
    return op.kernel(*args, **ck)


def count_launch(kernel: Callable) -> None:
    """Add one to ``kernel.launches``; every wrapper calls this right
    after its launch succeeds.  Inside :func:`capture_tally` on this
    thread the launch was only recorded into a graph, and it goes into the
    capture's tally instead."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is None and _STREAM_TALLIES:
        tally = _STREAM_TALLIES.get(torch.cuda.current_stream().cuda_stream)
    with _LAUNCH_LOCK:
        if tally is not None:
            tally[kernel] = tally.get(kernel, 0) + 1
        else:
            kernel.launches += 1


@contextlib.contextmanager
def capture_tally(stream: Optional[torch.cuda.Stream] = None):
    """Collect this thread's ``count_launch`` calls, and with ``stream``
    those of every thread launching on that stream, into the yielded
    ``{kernel: launches}`` dict instead of the counts (a graph capture;
    module docstring).  Other threads keep counting as before."""
    prev = getattr(_CAPTURE, "tally", None)
    _CAPTURE.tally = tally = {}
    key = None if stream is None else stream.cuda_stream
    if key is not None:
        with _LAUNCH_LOCK:
            _STREAM_TALLIES[key] = tally
    try:
        yield tally
    finally:
        _CAPTURE.tally = prev
        if key is not None:
            with _LAUNCH_LOCK:
                del _STREAM_TALLIES[key]


def add_launches(tally: dict) -> None:
    """Add a capture's tally to the counts: once per replay of its graph."""
    with _LAUNCH_LOCK:
        for kernel, n in tally.items():
            kernel.launches += n


def launch_counts() -> dict[str, int]:
    """``{op name: kernel launches since the last reset}``."""
    with _LAUNCH_LOCK:
        return {n: op.kernel.launches for n, op in sorted(_OPS.items())}


def reset_launches() -> None:
    """Set every registered kernel's launch count to 0."""
    with _LAUNCH_LOCK:
        for op in _OPS.values():
            op.kernel.launches = 0
