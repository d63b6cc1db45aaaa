"""App-shaped HIR traces for the end-to-end transformed-vs-sync benchmark.

Three programs shaped like the paper's motivating applications (§2, §7's
benchmark suite), written as synchronous HIR — every query blocks — and
auto-transformed by :func:`~repro.core.hir.transform_program` for the
batched side.  Each trace exercises a distinct transformation surface:

* **admin workflow** — a per-user permission audit behind a ``Proc``/
  ``Call`` boundary (inline-then-fission), plus a final summary query;
* **user flow** — an order listing with *nested* per-item lookups: the
  outer loop's head query fissions, and each order's inner price loop
  fissions again inside the consumer (nested Rule A);
* **RAG pipeline** — retrieval phases: per-question retrieve, per-passage
  rerank against the accumulated context, one final generate call.

``benchmarks/bench_lanes.py`` Part 10 drives both forms through the
serving scheduler via :mod:`repro.serving.hir_bridge` and gates the
tokens/s and round-trip ratios; the equivalence harness contract (same
observables, bit-identical) applies here with real request generations as
the observable.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.hir import Assign, Call, Loop, Proc, Program, Query

__all__ = ["AppTrace", "admin_workflow", "user_flow", "rag_pipeline",
           "all_traces"]

_MOD = 10007


def _add(a, b):
    return (_num(a) + _num(b)) % _MOD


def _mix(a, b):
    return (_num(a) * 31 + _num(b) * 17 + 5) % _MOD


def _num(v) -> int:
    """Fold a value (int or generated-token tuple) into a small int —
    query results here are whole token tuples."""
    if isinstance(v, tuple):
        return sum(int(x) for x in v) % _MOD
    return int(v) % _MOD


def _zero():
    return 0


@dataclasses.dataclass
class AppTrace:
    """One benchmark trace: program, inputs, observable variable names."""

    name: str
    program: Program
    inputs: dict[str, Any]
    observe: tuple[str, ...]
    n_queries: int  # synchronous round trips (= total queries executed)


def admin_workflow() -> AppTrace:
    """Per-user permission audit behind a procedure boundary."""
    audit = Proc(
        name="audit",
        formals=("uid",),
        body=[
            Assign(target="key", fn=_mix, args=("uid", "uid")),
            Query(target="perm", query_name="perm_check", params=("key",)),
            Assign(target="score", fn=_add, args=("perm", "uid")),
        ],
        result="score",
    )
    prog = Program(
        inputs=("users",),
        body=[
            Assign(target="flags", fn=_zero, args=()),
            Loop(item_var="u", iter_var="users", body=[
                Call(target="s", proc=audit, args=("u",)),
                Assign(target="flags", fn=_add, args=("flags", "s")),
            ]),
            Query(target="log", query_name="audit_log", params=("flags",)),
        ],
    )
    users = [11, 23, 35, 41, 57, 63, 78, 92]
    return AppTrace(
        name="admin_workflow",
        program=prog,
        inputs={"users": users},
        observe=("flags", "log"),
        n_queries=len(users) + 1,
    )


def user_flow() -> AppTrace:
    """Order listing with nested per-item price lookups."""
    prog = Program(
        inputs=("orders", "line_items"),
        body=[
            Assign(target="revenue", fn=_zero, args=()),
            Loop(item_var="o", iter_var="orders", body=[
                Assign(target="okey", fn=_mix, args=("o", "o")),
                Query(target="head", query_name="order_head",
                      params=("okey",)),
                Loop(item_var="it", iter_var="line_items", body=[
                    Assign(target="ikey", fn=_mix, args=("it", "head")),
                    Query(target="price", query_name="item_price",
                          params=("ikey",)),
                    Assign(target="revenue", fn=_add,
                           args=("revenue", "price")),
                ]),
            ]),
        ],
    )
    orders = [3, 14, 27, 38, 49]
    items = [2, 5, 9, 12]
    return AppTrace(
        name="user_flow",
        program=prog,
        inputs={"orders": orders, "line_items": items},
        observe=("revenue",),
        n_queries=len(orders) * (1 + len(items)),
    )


def rag_pipeline() -> AppTrace:
    """Retrieval-augmented phases: retrieve, rerank, generate."""
    prog = Program(
        inputs=("questions", "passages"),
        body=[
            Assign(target="ctx", fn=_zero, args=()),
            Loop(item_var="q", iter_var="questions", body=[
                Query(target="doc", query_name="retrieve", params=("q",)),
                Assign(target="ctx", fn=_add, args=("ctx", "doc")),
            ]),
            Assign(target="best", fn=_zero, args=()),
            Loop(item_var="p", iter_var="passages", body=[
                Assign(target="pk", fn=_mix, args=("p", "ctx")),
                Query(target="sc", query_name="rerank", params=("pk",)),
                Assign(target="best", fn=_add, args=("best", "sc")),
            ]),
            Query(target="answer", query_name="generate", params=("best",)),
        ],
    )
    questions = [7, 19, 31, 44, 56, 68]
    passages = [4, 13, 22, 37, 46, 55, 64, 73]
    return AppTrace(
        name="rag_pipeline",
        program=prog,
        inputs={"questions": questions, "passages": passages},
        observe=("ctx", "best", "answer"),
        n_queries=len(questions) + len(passages) + 1,
    )


def all_traces() -> list[AppTrace]:
    """Every Part 10 trace, in reporting order."""
    return [admin_workflow(), user_flow(), rag_pipeline()]
