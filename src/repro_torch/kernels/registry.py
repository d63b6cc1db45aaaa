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
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["KernelOp", "OpSample", "register", "get", "names", "dispatch",
           "count_launch", "launch_counts", "reset_launches"]


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
    after its launch succeeds."""
    with _LAUNCH_LOCK:
        kernel.launches += 1


def launch_counts() -> dict[str, int]:
    """``{op name: kernel launches since the last reset}``."""
    with _LAUNCH_LOCK:
        return {n: op.kernel.launches for n, op in sorted(_OPS.items())}


def reset_launches() -> None:
    """Set every registered kernel's launch count to 0."""
    with _LAUNCH_LOCK:
        for op in _OPS.values():
            op.kernel.launches = 0
