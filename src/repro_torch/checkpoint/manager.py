"""Fault-tolerant checkpointing — asynchronous submission applied to IO.

Port of :mod:`repro.checkpoint.manager`.  A checkpoint write is a *query*
in the paper's sense: a slow, blocking round trip the training loop should
overlap with compute.  The manager submits serialization + write work
through the port's :class:`~repro_torch.core.runtime.AsyncQueryRuntime`
(one worker "connection" to the filesystem, no deduplication: two saves
are two writes), so ``save()`` returns as soon as its snapshot is taken
and the train loop keeps stepping while the runtime's thread writes.
``wait()`` / context exit drains pending writes (the blocking ``fetch``).

The snapshot at ``save()`` is a copy on every device: ``.cpu()`` of a CPU
tensor returns the tensor itself, and the port's train step may write its
parameters and moments in place (``TrainStepConfig.donate``), so anything
short of a copy would let the next step change what is being written.

The reference's on-disk layout, so that either package restores what the
other wrote: ``step_<n>/{params,state}/`` directories of one ``.npy`` file
per leaf, named ``key.replace("/", "__") + ".npy"`` for the leaf's path
``"a/b/c"`` (an int8 moment's ``QuantizedTensor`` has the children ``0``,
its blocks, and ``1``, its scales, as the reference's pytree node
flattens), and a ``manifest.json`` of ``{"arrays": {key: {"file",
"shape", "dtype"}}}``; bfloat16 is written as float32 ``.npy`` with
``"bfloat16"`` in the manifest.  Durability as in the reference: each step
is written to ``step_<n>.tmp/`` and renamed whole, then ``LATEST`` is
replaced by a rename, so a crash mid-write never corrupts the last good
checkpoint; ``keep_last`` bounds retention; ``on_preempt`` saves
synchronously.  Restore puts each tensor on the device of its ``like``
leaf, in that leaf's dtype; a DTensor ``like`` leaf restores onto its mesh
(elastic restore: checkpoints hold unsharded arrays, and each rank keeps
its own shard of the full array, ``src_data_rank=None``, so a restore onto
any mesh communicates nothing).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core.runtime import AsyncQueryRuntime
from repro_torch.core.services import _StatsMixin
from repro_torch.train.optimizer import QuantizedTensor

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]


# ---------------------------------------------------------------------------
# tree <-> flat npz-style directory
# ---------------------------------------------------------------------------


def _children(node):
    """(key, child) pairs of an inner node in the reference's flattening
    order (dict keys sorted), or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, QuantizedTensor):
        return [("0", node.q), ("1", node.scale)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """[("a/b/c", leaf tensor)] for every leaf of ``tree``."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [kv for k, c in kids
            for kv in _flatten_with_paths(c, f"{prefix}/{k}" if prefix else k)]


def _map(fn: Callable, tree):
    """``tree`` with every leaf tensor replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(tree.q), fn(tree.scale), shape=tree.shape, pad=tree.pad,
                               sqrt_domain=tree.sqrt_domain)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def save_pytree(tree, directory: Path) -> int:
    """Write every leaf of ``tree`` (nested dicts of tensors and
    ``QuantizedTensor``s, on any device) under ``directory`` in the
    reference's layout.  Returns the bytes written."""
    directory.mkdir(parents=True, exist_ok=True)
    manifest, nbytes = {}, 0
    for key, leaf in _flatten_with_paths(tree):
        fname = key.replace("/", "__") + ".npy"
        t = leaf.detach().cpu()
        dtype = str(t.dtype).removeprefix("torch.")
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        np.save(directory / fname, arr)
        nbytes += (directory / fname).stat().st_size
        manifest[key] = {"file": fname, "shape": list(t.shape), "dtype": dtype}
    keys = ", ".join(manifest)
    (directory / "manifest.json").write_text(
        json.dumps({"arrays": manifest, "treedef": f"repro_torch leaves: {keys}"}))
    return nbytes


def load_pytree(directory: Path, like) -> Any:
    """Restore into the structure of ``like``: each leaf read from its file,
    shape-checked, and made a tensor of the ``like`` leaf's dtype on its
    device."""
    manifest = json.loads((directory / "manifest.json").read_text())["arrays"]

    def load(node, prefix: str):
        kids = _children(node)
        if kids is None:
            info = manifest[prefix]
            arr = np.load(directory / info["file"])
            assert tuple(arr.shape) == tuple(node.shape), (prefix, arr.shape, node.shape)
            t = torch.from_numpy(arr).to(device=node.device, dtype=node.dtype)
            if isinstance(node, DTensor):
                t = distribute_tensor(t, node.device_mesh, node.placements, src_data_rank=None)
            return t
        loaded = [load(c, f"{prefix}/{k}" if prefix else k) for k, c in kids]
        if isinstance(node, dict):
            return dict(zip((k for k, _c in kids), loaded))
        if isinstance(node, QuantizedTensor):
            return QuantizedTensor(*loaded, shape=node.shape, pad=node.pad,
                                   sqrt_domain=node.sqrt_domain)
        return type(node)(loaded)

    return load(like, "")


# ---------------------------------------------------------------------------
# async manager
# ---------------------------------------------------------------------------


class _FsWriteService(_StatsMixin):
    """The 'database' behind checkpoint queries: a filesystem writer."""

    def execute(self, query_name: str, params: tuple) -> Any:
        (fn,) = params
        return fn()

    def execute_batch(self, query_name, params_list):
        return [fn() for (fn,) in params_list]


class CheckpointManager:
    """Atomic, asynchronous checkpoints under ``root`` (see the module
    docstring).  ``writes`` lists, for each write that ran, ``{"step",
    "bytes", "start", "end"}`` (``time.perf_counter`` seconds on the
    runtime's thread), appended as each completes."""

    def __init__(self, root: str | Path, keep_last: int = 3, async_writes: bool = True):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_writes = async_writes
        # Effectful service: two saves must never coalesce into one write,
        # so request deduplication is pinned off (see runtime docstring).
        self._runtime = AsyncQueryRuntime(_FsWriteService(), n_threads=1, dedup=False)
        self._pending = []
        self.writes: list[dict] = []

    # ------------------------------------------------------------------ save
    def save(self, step: int, params, state=None, blocking: bool = False) -> None:
        """Snapshot ``params`` (and ``state``) to host memory now, as copies
        (the next train step may write the originals in place); the write
        itself goes through the runtime unless ``blocking``."""
        host_params = _map(_host_copy, params)
        host_state = _map(_host_copy, state) if state is not None else None

        def write():
            t0 = time.perf_counter()
            tmp = self.root / f"step_{step:010d}.tmp"
            final = self.root / f"step_{step:010d}"
            if final.exists():
                return step  # idempotent: this step is already durable
            if tmp.exists():
                shutil.rmtree(tmp)
            nbytes = save_pytree(host_params, tmp / "params")
            if host_state is not None:
                nbytes += save_pytree(host_state, tmp / "state")
            (tmp / "META").write_text(json.dumps({"step": step, "time": time.time()}))
            os.replace(tmp, final)  # atomic
            (self.root / "LATEST.tmp").write_text(final.name)
            os.replace(self.root / "LATEST.tmp", self.root / "LATEST")
            self._gc()
            self.writes.append({"step": step, "bytes": nbytes, "start": t0,
                                "end": time.perf_counter()})
            return step

        if self.async_writes and not blocking:
            h = self._runtime.submit("ckpt.write", (write,))
            self._pending.append(h)
        else:
            write()

    def wait(self) -> None:
        """Block until every submitted write is durable (re-raising a
        write's error)."""
        for h in self._pending:
            self._runtime.fetch(h)
        self._pending.clear()

    def on_preempt(self, step: int, params, state=None) -> None:
        """Preemption hook: synchronous, durable save."""
        self.wait()
        self.save(step, params, state, blocking=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        """The newest complete step: ``LATEST``'s, or without it the newest
        ``step_*`` directory holding ``META``; None when there is none."""
        latest = self.root / "LATEST"
        if not latest.exists():
            steps = sorted(self.root.glob("step_*"))
            steps = [s for s in steps if not s.name.endswith(".tmp") and (s / "META").exists()]
            if not steps:
                return None
            return int(json.loads((steps[-1] / "META").read_text())["step"])
        name = latest.read_text().strip()
        meta = self.root / name / "META"
        if not meta.exists():
            return None
        return int(json.loads(meta.read_text())["step"])

    def restore(self, step: int, params_like, state_like=None):
        """(params, state or None) of ``step``, laid out as the ``like``
        trees (devices and dtypes included)."""
        d = self.root / f"step_{step:010d}"
        params = load_pytree(d / "params", params_like)
        state = load_pytree(d / "state", state_like) if state_like is not None else None
        return params, state

    def restore_latest(self, params_like, state_like=None):
        """(step, params, state) of the newest complete step, or None."""
        step = self.latest_step()
        if step is None:
            return None
        params, state = self.restore(step, params_like, state_like)
        return step, params, state

    # ------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = sorted(s for s in self.root.glob("step_*") if not s.name.endswith(".tmp"))
        for old in steps[: -self.keep_last]:
            shutil.rmtree(old, ignore_errors=True)

    def close(self) -> None:
        """Drain pending writes and stop the runtime."""
        self.wait()
        self._runtime.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
