"""Device-level Rule A: fission of scanned loops at ``async_query`` calls.

Port of :mod:`repro.core.fission`.  :func:`scan` is the port's
``lax.scan``: a Python loop over dim 0 of ``xs`` that stacks the ``ys``.
``fission_scan(f, init, xs)`` is a drop-in replacement for it.  If the
body holds query ops (:mod:`repro_torch.core.query`), the loop is split,
the paper's Rule A:

    original:   N iterations, each issuing one small query
    rewritten:  producer loop  (ss1: everything the query's inputs need;
                                stacks query arguments and split variables
                                into the loop context table)
                one batched query execution (``spec.execute_batch``: ONE
                                ``batched_gather`` launch instead of N)
                consumer loop  (ss2: everything dependent on query results)

How the body is seen.  It is traced once with ``make_fx`` in fake mode:
no device work, and closed-over tensors (the parameters) enter the graph
by reference as ``get_attr`` constants.  The graph's nodes are the
equations of :class:`~repro_torch.core.ddg.ScanBodyDDG`.  The split is the
reference's: everything downstream of the first query goes to the consumer,
with the same fixed point for statement reordering, and the producer and
consumer bodies are two ``fx.GraphModule`` s cut out of the traced graph.
Later queries on the consumer side are fissioned in turn by recursion
(§3.2 "repeated application").  Every op on the traced path must be an
aten op or a custom op (the port's kernels are): a launch that bypasses
the dispatcher would be frozen into the graph as a constant.

Differences from the reference, each keeping its results:

* Loop-invariant nodes (computed from constants only, such as a weight's
  transpose or cast) are recomputed on each side that reads them instead
  of being stacked into the context table: N copies of every weight would
  not fit on the card for a full-width model.
* Precondition (b): a node that draws random numbers, has a side effect
  (``aten._print``), or writes into a loop input, a closed-over tensor or
  through a view is refused with :class:`FissionPreconditionError`.
  In-place writes to the body's own temporaries (the autograd engine's
  gradient accumulation) are allowed: the DDG orders them after every
  earlier reader.
* Leaves of ``init`` and ``xs`` are tensors; the graphs are traced for
  contiguous ones, and every input is made contiguous before each call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.fx as fx
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.core.ddg import (
    FissionPreconditionError,
    ScanBodyDDG,
    is_view,
    written_args,
)
from repro_torch.core.query import query_spec_of

__all__ = [
    "scan",
    "fission_scan",
    "scan_with_queries",
    "trace_body",
    "FissionPreconditionError",
    "FissionReport",
    "count_queries",
]

try:
    from torch._higher_order_ops.effects import _get_effect
except ImportError:  # older torch: only the print op is known to be effectful
    def _get_effect(op):
        return op if op is getattr(torch.ops.aten, "_print").default else None


@dataclasses.dataclass
class FissionReport:
    """What happened: for the applicability table and tests."""

    n_queries_found: int = 0
    n_queries_batched: int = 0
    batched_specs: list = dataclasses.field(default_factory=list)
    failures: list = dataclasses.field(default_factory=list)


def scan(f: Callable, init, xs, length: Optional[int] = None):
    """``lax.scan``: ``carry, y = f(carry, x)`` for each ``x`` along dim 0
    of every leaf of ``xs`` (or ``length`` times with ``xs`` empty) →
    ``(final carry, ys stacked on a new dim 0)``; a ``None`` in ``y`` stays
    ``None``."""
    flat_xs, xs_tree = pytree.tree_flatten(xs)
    n = flat_xs[0].shape[0] if flat_xs else length
    if n is None or n < 1:
        raise ValueError("scan needs at least one iteration (xs or length)")
    carry, ys, y_tree = init, [], None
    for t in range(n):
        carry, y = f(carry, pytree.tree_unflatten([a[t] for a in flat_xs], xs_tree))
        leaves, y_tree = pytree.tree_flatten(y)
        ys.append(leaves)
    stacked = [None if col[0] is None else torch.stack(col) for col in zip(*ys)]
    return carry, pytree.tree_unflatten(stacked, y_tree)


@dataclasses.dataclass
class _Traced:
    gm: fx.GraphModule
    n_carry: int
    carry_tree: object
    y_tree: object


def trace_body(f: Callable, init, xs) -> _Traced:
    """Trace one iteration ``f(init, xs[0])`` into an fx graph with
    placeholders ``[*carry, *x]`` and outputs ``[*carry, *y]`` (flattened
    leaves), in fake mode with contiguous stand-ins for the inputs: nothing
    runs on the device.  Any dispatch mode active around the call (an
    enclosing trace) is set aside while tracing, so a fissioned loop nested
    in a traced body is traced on its own."""
    flat_init, carry_tree = pytree.tree_flatten(init)
    flat_xs, xs_tree = pytree.tree_flatten(xs)
    n_carry = len(flat_init)
    trees = {}

    def flat_body(*flat):
        carry = pytree.tree_unflatten(list(flat[:n_carry]), carry_tree)
        x = pytree.tree_unflatten(list(flat[n_carry:]), xs_tree)
        new_carry, y = f(carry, x)
        out_carry, out_tree = pytree.tree_flatten(new_carry)
        if out_tree != carry_tree:
            raise TypeError(f"scan body returned a carry of structure {out_tree}, "
                            f"not that of init ({carry_tree})")
        ys, trees["y"] = pytree.tree_flatten(y)
        return [*out_carry, *ys]

    with _disable_current_modes():
        with FakeTensorMode(allow_non_fake_inputs=True):
            stand_ins = ([torch.empty(c.shape, dtype=c.dtype, device=c.device)
                          for c in flat_init]
                         + [torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
                            for x in flat_xs])
        gm = make_fx(flat_body, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*stand_ins)
    return _Traced(gm, n_carry, carry_tree, trees["y"])


def count_queries(f: Callable, init, xs) -> int:
    tr = trace_body(f, init, xs)
    return sum(1 for n in tr.gm.graph.nodes
               if n.op == "call_function" and query_spec_of(n.target) is not None)


def _refuse_effects(ddg: ScanBodyDDG) -> None:
    """Precondition (b), conservative: external state in the body."""
    for e in ddg.eqns:
        why = None
        t = e.target
        if isinstance(t, torch._ops.OpOverload):
            if torch.Tag.nondeterministic_seeded in t.tags:
                why = "draws random numbers (external generator state)"
            elif _get_effect(t) is not None:
                why = "has a side effect"
        for w in written_args(e):
            root = w
            while root.op == "call_function" and is_view(root):
                root = root.args[0]
            if root.op in ("placeholder", "get_attr"):
                why = "writes into a loop input or a closed-over tensor"
            elif root is not w:
                why = "writes through a view"
        if why:
            raise FissionPreconditionError(
                f"effectful node {e.target} in loop body {why}: external anti/output "
                f"dependence may cross the split (Rule A precondition (b)); fission "
                f"refused.")


def _invariant(ddg: ScanBodyDDG, excluded: set[int]) -> set[int]:
    """Equations outside ``excluded`` computed from constants alone."""
    inv: set[int] = set()
    for i, e in enumerate(ddg.eqns):
        if i in excluded:
            continue
        if all(a.op == "get_attr" or ddg.def_site.get(a) in inv
               for a in e.all_input_nodes):
            inv.add(i)
    return inv


def _subgraph(gm: fx.GraphModule, ddg: ScanBodyDDG, inv: set[int], inputs: list,
              eqn_idxs, outputs: list) -> fx.GraphModule:
    """A GraphModule over ``gm``'s constants: placeholders ``inputs``, the
    equations ``eqn_idxs`` in graph order, outputs ``outputs``.  Constants
    and loop-invariant equations are copied in where read."""
    g = fx.Graph()
    env: dict = {}
    for k, n in enumerate(inputs):
        env[n] = g.placeholder(f"in{k}")

    def need(n):
        if n not in env:
            if n.op != "get_attr" and ddg.def_site.get(n) not in inv:
                raise AssertionError(f"fission split reads {n} across the sides")
            for a in n.all_input_nodes:
                need(a)
            env[n] = g.node_copy(n, env.__getitem__)
        return env[n]

    for i in sorted(eqn_idxs):
        n = ddg.eqns[i]
        for a in n.all_input_nodes:
            need(a)
        env[n] = g.node_copy(n, env.__getitem__)
    g.output([need(o) if isinstance(o, fx.Node) else o for o in outputs])
    g.eliminate_dead_code()
    return fx.GraphModule(gm, g)


def _call(gm: fx.GraphModule, args) -> list:
    return list(gm(*(a.contiguous() for a in args)))


def fission_scan(
    f: Callable,
    init,
    xs,
    length: Optional[int] = None,
    *,
    report: Optional[FissionReport] = None,
    _depth: int = 0,
):
    """:func:`scan` with Rule A applied at every query in the body.

    Falls back to plain :func:`scan` when the body has no queries.  Raises
    :class:`FissionPreconditionError` when a query lies on a
    true-dependence cycle (its submission needs a previous iteration's
    result) or the body has external effects.
    """
    if _depth > 8:
        raise RecursionError("fission_scan: too many chained queries")

    # ---- trace the body ------------------------------------------------
    tr = trace_body(f, init, xs)
    gm = tr.gm
    flat_init = [c.contiguous() for c in pytree.tree_leaves(init)]
    flat_xs = [x.contiguous() for x in pytree.tree_leaves(xs)]
    n_carry = tr.n_carry
    ddg = ScanBodyDDG(gm.graph, n_carry)
    eqns = ddg.eqns

    q_idxs = [i for i, e in enumerate(eqns) if query_spec_of(e.target) is not None]
    if not q_idxs:
        return scan(f, init, xs, length=length)
    if report is not None and _depth == 0:
        report.n_queries_found = len(q_idxs)
    _refuse_effects(ddg)

    qi = q_idxs[0]
    # Split at the FIRST query.  Everything downstream of it is ``ss2``; any
    # later query (even if independent) also moves to the consumer side so
    # the repeated application of Rule A (§3.2) batches it in turn.
    consumer_eqns: set[int] = set()
    for j in q_idxs:
        consumer_eqns |= ddg.downstream(j)

    # Statement reordering ([4]'s algorithm, SSA style): an equation that
    # reads the previous-iteration value of a consumer-side carry moves to
    # the consumer side, unless the query's own inputs flow through it (a
    # true-dependence cycle).  Iterate to a fixed point.
    must_stay_producer = ddg.upstream_of_vars(ddg.eqn_reads(qi)) | {qi}
    while True:
        producer_pos, consumer_pos = ddg.classify_carry(consumer_eqns)
        consumer_carry_in = {ddg.carry_in[j] for j in consumer_pos}
        moved = False
        for i in range(len(eqns)):
            if i in consumer_eqns:
                continue
            if ddg.eqn_reads(i) & consumer_carry_in:
                if i in must_stay_producer:
                    raise FissionPreconditionError(
                        "query inputs depend (across iterations) on values "
                        "produced by the query's own consumers — true-"
                        "dependence cycle; Rule A inapplicable (paper §4.1).")
                consumer_eqns |= ddg.downstream(i)
                moved = True
        if not moved:
            break
    ddg.check_split(qi, consumer_eqns, consumer_pos)
    inv = _invariant(ddg, consumer_eqns | set(q_idxs))
    producer_eqns = [i for i in range(len(eqns)) if i not in consumer_eqns and i not in inv]

    q_node = eqns[qi]
    spec = query_spec_of(q_node.target)

    # ---- variable classification ---------------------------------------
    x_pos = {v: i for i, v in enumerate(ddg.x_in)}
    carry_pos = {v: j for j, v in enumerate(ddg.carry_in)}

    def side(v) -> str:
        """'const' | 'x' | 'pcarry' | 'ccarry' | 'prod' | 'cons' | 'query'."""
        if v.op == "get_attr" or ddg.def_site.get(v) in inv:
            return "const"
        if v in x_pos:
            return "x"
        if v in carry_pos:
            return "ccarry" if carry_pos[v] in consumer_pos else "pcarry"
        d = ddg.def_site[v]
        if d == qi:
            return "query"
        return "cons" if d in consumer_eqns else "prod"

    consumer_list = [i for i in sorted(consumer_eqns) if i != qi]
    consumer_reads = ddg.side_reads(consumer_list)
    order = {n: k for k, n in enumerate(gm.graph.nodes)}
    # Context table: values the consumer needs from the producer side.
    ctx_vars = [v for v in sorted(consumer_reads, key=order.__getitem__)
                if side(v) in ("prod", "pcarry")]

    consumer_y_pos, producer_y_pos = [], []
    for k, v in enumerate(ddg.y_out):
        lit = not isinstance(v, fx.Node)
        (consumer_y_pos if not lit and side(v) in ("cons", "query", "ccarry")
         else producer_y_pos).append(k)
    consumer_x_pos = sorted({x_pos[v] for v in consumer_reads if v in x_pos})

    # Query arguments: stacked (varying) or invariant.
    if q_node.kwargs:
        raise FissionPreconditionError("query op called with keyword arguments")
    q_plan: list[tuple[str, object]] = []
    for v in q_node.args:
        if not isinstance(v, fx.Node):
            q_plan.append(("lit", v))
        elif side(v) == "const":
            q_plan.append(("const", v))
        elif side(v) == "x":
            q_plan.append(("xs", x_pos[v]))
        elif side(v) in ("prod", "pcarry"):
            if v not in ctx_vars:
                ctx_vars.append(v)
            q_plan.append(("ctx", v))
        else:  # consumer side: a cycle, which check_split has raised on
            raise FissionPreconditionError("query argument produced on the consumer side")
    ctx_index = {v: i for i, v in enumerate(ctx_vars)}
    n_ctx = len(ctx_vars)

    p_pos, c_pos = sorted(producer_pos), sorted(consumer_pos)

    # ---- producer loop -----------------------------------------------------
    prod_gm = _subgraph(
        gm, ddg, inv, [ddg.carry_in[j] for j in p_pos] + ddg.x_in, producer_eqns,
        [ddg.carry_out[j] for j in p_pos] + ctx_vars
        + [ddg.y_out[k] for k in producer_y_pos])

    def producer_body(carry_p, x_flat):
        outs = _call(prod_gm, (*carry_p, *x_flat))
        k = len(p_pos)
        return tuple(outs[:k]), (tuple(outs[k:k + n_ctx]), tuple(outs[k + n_ctx:]))

    carry_p_final, (ctx_stacked, ys_p_stacked) = scan(
        producer_body, tuple(flat_init[j] for j in p_pos), tuple(flat_xs), length=length)

    # ---- ONE batched query execution (the set-oriented form) --------------
    const_gm = _subgraph(gm, ddg, inv, [], [],
                         [v for kind, v in q_plan if kind == "const"])
    consts = iter(const_gm())
    args, mask = [], []
    for kind, payload in q_plan:
        if kind == "lit":
            args.append(payload)
        elif kind == "const":
            args.append(next(consts))
        elif kind == "xs":
            args.append(flat_xs[payload])
        else:
            args.append(ctx_stacked[ctx_index[payload]])
        mask.append(kind in ("xs", "ctx"))
    q_res = spec.batched(mask)(*args)
    if report is not None:
        report.n_queries_batched += 1
        report.batched_specs.append(spec.name)

    # ---- consumer loop -----------------------------------------------------
    cons_gm = _subgraph(
        gm, ddg, inv,
        [ddg.carry_in[j] for j in c_pos] + [q_node] + ctx_vars
        + [ddg.x_in[i] for i in consumer_x_pos],
        consumer_list,
        [ddg.carry_out[j] for j in c_pos] + [ddg.y_out[k] for k in consumer_y_pos])

    def consumer_body(carry_c, per_iter):
        qres, ctx_slice, x_slice = per_iter
        outs = _call(cons_gm, (*carry_c, qres, *ctx_slice, *x_slice))
        return tuple(outs[:len(c_pos)]), tuple(outs[len(c_pos):])

    consumer_xs = (q_res, tuple(ctx_stacked), tuple(flat_xs[i] for i in consumer_x_pos))
    carry_c_init = tuple(flat_init[j] for j in c_pos)
    # Repeated application (§3.2) while queries remain on the consumer side.
    if any(query_spec_of(eqns[i].target) is not None for i in consumer_list):
        carry_c_final, ys_c_stacked = fission_scan(
            consumer_body, carry_c_init, consumer_xs, report=report, _depth=_depth + 1)
    else:
        carry_c_final, ys_c_stacked = scan(consumer_body, carry_c_init, consumer_xs)

    # ---- reassemble ---------------------------------------------------------
    flat_carry: list = [None] * n_carry
    for idx, j in enumerate(p_pos):
        flat_carry[j] = carry_p_final[idx]
    for idx, j in enumerate(c_pos):
        flat_carry[j] = carry_c_final[idx]
    flat_ys: list = [None] * len(ddg.y_out)
    for idx, k in enumerate(producer_y_pos):
        flat_ys[k] = ys_p_stacked[idx]
    for idx, k in enumerate(consumer_y_pos):
        flat_ys[k] = ys_c_stacked[idx]
    return (pytree.tree_unflatten(flat_carry, tr.carry_tree),
            pytree.tree_unflatten(flat_ys, tr.y_tree))


def scan_with_queries(f: Callable, init, xs, *, fission: bool = True, length=None):
    """Config-switchable entry point: the *same* model code runs either the
    paper-faithful per-iteration form (``fission=False``, the baseline) or
    the fissioned batched form (``fission=True``)."""
    if fission:
        return fission_scan(f, init, xs, length=length)
    return scan(f, init, xs, length=length)
