"""Quickstart — the paper in 60 seconds.

A program written against a blocking query API (paper Example 2) is
mechanically transformed (Rule A loop fission) and executed through the
asynchronous-batching runtime.  Run:

    PYTHONPATH=src python examples/quickstart.py

The port's copy, imports rewritten: run it as
``python -m repro_torch.examples.quickstart``.
"""
import time

from repro_torch.core.hir import Assign, Interpreter, Loop, Program, Query, transform_program
from repro_torch.core.runtime import AsyncQueryRuntime
from repro_torch.core.services import SimulatedDBService
from repro_torch.core.strategies import GrowingUpperThreshold


def main():
    # -- the original program (paper Example 2) ------------------------------
    prog = Program(
        inputs=("categories", "sum"),
        body=[
            Loop(item_var="category", iter_var="categories", body=[
                Query(target="partCount", query_name="parts.count",
                      params=("category",)),
                Assign(target="sum", fn=lambda s, c: s + (c or 0),
                       args=("sum", "partCount")),
            ]),
        ],
    )
    print("original program:")
    print(prog, "\n")

    # -- transform: Rule A loop fission → producer + consumer ----------------
    tprog = transform_program(prog, overlap=True)
    print("transformed program (producer/consumer over a loop-context table):")
    print(tprog, "\n")

    # -- execute both against the same simulated database --------------------
    def service():
        return SimulatedDBService(rtt=3e-3, single_proc=1e-3, batch_proc=5e-5,
                                  batch_fixed=5e-4, concurrency=8,
                                  compute_fn=lambda q, p: p[0] * 10)

    inputs = {"categories": list(range(300)), "sum": 0}

    t0 = time.perf_counter()
    base = Interpreter(service()).run(prog, dict(inputs))
    t_sync = time.perf_counter() - t0

    rt = AsyncQueryRuntime(service(), n_threads=10,
                           strategy=GrowingUpperThreshold(initial_upper=8, bt=3))
    t0 = time.perf_counter()
    out = Interpreter(rt).run(tprog, dict(inputs))
    rt.drain()
    t_async = time.perf_counter() - t0

    assert out["sum"] == base["sum"]
    print(f"sum (both)        : {out['sum']}")
    print(f"original          : {t_sync*1e3:7.1f} ms")
    print(f"transformed       : {t_async*1e3:7.1f} ms   ({t_sync/t_async:.1f}x)")
    print(f"runtime stats     : {rt.stats.snapshot()}")
    rt.shutdown()


if __name__ == "__main__":
    main()
