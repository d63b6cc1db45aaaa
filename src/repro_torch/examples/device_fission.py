"""Device-level Rule A: fission of a scanned loop with per-iteration queries.

The port's twin of the JAX package's ``examples/device_fission.py``.
Shows the loop's structure before and after, the per-iteration gather
inside the loop becomes ONE batched gather outside it, plus autodiff
through the transformed loop.  The reference reads the structure from the
compiled HLO; here it is the program traced with ``make_fx``: query nodes
issued per iteration (``table_gather``) against set-oriented ones
(``batched_gather``, one kernel launch on the card).  Run:

    python -m repro_torch.examples.device_fission [--device cpu]
"""
from __future__ import annotations

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.core.fission import FissionReport, fission_scan, scan
from repro_torch.core.query import async_query, table_gather_spec

__all__ = ["model_body", "loop", "structure", "table_grad", "main"]


def model_body(table: torch.Tensor):
    """The model code: a loop body that 'queries' ``table`` once a step."""
    def body(carry, i):
        row = async_query(table_gather_spec, table, i)   # blocking query
        return carry + row.sum(), row.mean()
    return body


def loop(scan_fn, table: torch.Tensor, ids: torch.Tensor, report=None):
    """``model_body`` over ``ids`` through ``scan_fn`` (``scan`` or
    ``fission_scan``, the latter filling ``report``) → (carry, ys)."""
    zero = torch.zeros((), dtype=torch.float32, device=table.device)
    if report is None:
        return scan_fn(model_body(table), zero, ids)
    return scan_fn(model_body(table), zero, ids, report=report)


def structure(scan_fn, table: torch.Tensor, ids: torch.Tensor) -> dict:
    """Query nodes of the whole loop traced with ``make_fx`` (on the card
    the trace runs the loop once): ``table_gather`` (one query issued per
    iteration) and ``batched_gather`` (one set-oriented gather)."""
    def program(t, ii):
        zero = torch.zeros((), dtype=torch.float32, device=t.device)
        return scan_fn(lambda c, i: (c + async_query(table_gather_spec, t, i).sum(), None),
                       zero, ii)[0]

    graph = make_fx(program)(table, ids).graph
    names = [n.target.__name__ for n in graph.nodes if n.op == "call_function"]
    return {"table_gather": names.count("table_gather.default"),
            "batched_gather": names.count("batched_gather.default")}


def table_grad(table: torch.Tensor, ids: torch.Tensor):
    """The gradient of the fissioned loop's sum of squared rows with
    respect to ``table`` → (gradient, rows with a nonzero gradient)."""
    t = table.detach().requires_grad_()
    zero = torch.zeros((), dtype=torch.float32, device=t.device)
    total = fission_scan(
        lambda c, i: (c + (async_query(table_gather_spec, t, i) ** 2).sum(), None),
        zero, ids)[0]
    (g,) = torch.autograd.grad(total, t)
    return g, int((g.abs().sum(-1) > 0).sum())


def main(device: str = "cuda"):
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = torch.randn((5000, 64), generator=gen, device=dev)
    ids = ((torch.arange(256, device=dev) * 37) % 5000).to(torch.int32)

    ref = loop(scan, table, ids)
    rep = FissionReport()
    out = loop(fission_scan, table, ids, report=rep)
    torch.testing.assert_close(out[0], ref[0], rtol=1e-5, atol=0)
    print(f"equivalence: OK   ({rep.n_queries_batched} query batched)")

    print("baseline ops     :", structure(scan, table, ids))
    print("fissioned ops    :", structure(fission_scan, table, ids),
          "   <- ONE hoisted batched gather")

    # autodiff flows through the fissioned loop
    g, rows = table_grad(table, ids)
    print("grad wrt table   :", tuple(g.shape), "nonzero rows:", rows)


if __name__ == "__main__":
    from repro_torch.examples import device_from_argv

    main(device=device_from_argv(__doc__))
