"""Ranks on one host: spawn ``world_size`` processes, each in one process
group, run a function in each and collect what each returns.

Nothing in the environment tells a program of a cluster, so the group is
given its address (``tcp://localhost:<free port>``), its size and each
rank explicitly.  On one card the ranks share the device and talk over
``gloo`` (NCCL takes one rank per GPU); on the CPU they are the tests'
small meshes.
"""
from __future__ import annotations

import datetime
import queue
import socket
import time
import traceback
from typing import Callable

import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_ranks"]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world_size, port, backend, timeout_s, q, args):
    ok, out = False, None
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, world_size, *args)
        ok = True
    except BaseException:  # reported to the parent, which raises
        out = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        q.put((rank, ok, out))
        q.close()
        q.join_thread()


def run_ranks(fn: Callable, world_size: int, *args, backend: str = "gloo",
              timeout_s: float = 600.0) -> list:
    """``[fn(rank, world_size, *args) for each rank]``, each call in a
    spawned process of its own with the process group initialised.
    ``fn`` and ``args`` must pickle (``fn`` a module-level function).
    Raises ``RuntimeError`` with a rank's traceback when it failed, or
    when the ranks did not all answer within ``timeout_s``; every process
    is ended before this returns."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world_size, port, backend,
                                              timeout_s, q, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world_size and not errors:
            try:
                rank, ok, out = q.get(timeout=1.0)
            except queue.Empty:
                missing = sorted(set(range(world_size)) - set(results))
                if any(procs[r].exitcode is not None for r in missing):
                    errors.append(f"ranks {missing}: a process ended without an answer "
                                  f"(exit codes {[procs[r].exitcode for r in missing]})")
                elif time.monotonic() > deadline:
                    errors.append(f"ranks {missing} did not answer in {timeout_s} s")
                continue
            if ok:
                results[rank] = out
            else:  # the others may wait forever in a collective
                errors.append(f"rank {rank}:\n{out}")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world_size)]

