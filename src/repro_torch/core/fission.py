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
no device work.  A body may take its loop-invariant tensors (a train
step's parameters) as a third argument, ``f(carry, x, consts)`` with
``fission_scan(..., consts=)``: they enter the graph as placeholders
after the carry's and the microbatch's, and the producer and consumer
graphs take them as inputs on every call.  Tensors a body closes over
enter by reference as ``get_attr`` constants instead.  Both count as
constants.  The graph's nodes are the equations of
:class:`~repro_torch.core.ddg.ScanBodyDDG`.  The split is the
reference's: everything downstream of the first query goes to the consumer,
with the same fixed point for statement reordering, and the producer and
consumer bodies are two ``fx.GraphModule`` s cut out of the traced graph.
Later queries on the consumer side are fissioned in turn by recursion
(§3.2 "repeated application").  Every op on the traced path must be an
aten op or a custom op (the port's kernels are): a launch that bypasses
the dispatcher would be frozen into the graph as a constant.

**A plan, cached** (the counterpart of tracing under ``jax.jit`` once per
compile).  Everything the pass computes before it runs a loop, the traced
graph, the producer, consumer and constant graphs, the query's argument
plan and the variable classification, and the plans of the consumer
loop's later splits, is a plan.  The pass keeps each plan in ``plans``
(a dict the caller owns) under the signature of its inputs (the trees'
structure, and the leaves' shapes, dtypes and devices of carry,
microbatches and consts) and traces again only for a new signature, so a
caller that keeps one dict across calls and makes a new closure every
call (the train step) still traces once.  A cached plan's body must take
every tensor that changes between calls through ``consts``: a
``get_attr`` constant is bound to the tensor of the call that traced it.

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

On a mesh (leaves of ``init`` or ``xs`` that are DTensors, the sharded
train step's gradients and microbatches) ``make_fx`` cannot trace the
DTensors themselves: it would record a step's result as a constant.  So
the pass traces each rank's own program instead (:func:`_fission_sharded`):
a body that takes the carry's and the microbatch's **local shards**, wraps
them as DTensors under their recorded placements, runs ``f`` and returns
the results' local shards.  DTensor turns into local aten ops and
functional collectives (``_c10d_functional.all_gather_into_tensor``,
``all_reduce``, ``reduce_scatter_tensor``, ``wait_tensor``), which are pure
to the DDG: they write nothing and have no effect.  Every rank traces the
same graph and runs the same producer, batched query and consumer, so the
collectives keep one order on all ranks.  The parameters (``consts``)
enter as their local shards, inputs of the graph as on one device, and
their FSDP gathers are loop invariant, recomputed on each side that reads
them.  The rank's plan is kept in ``plans`` under its local signature
and the leaves' placements, so a rank traces once per batch shape.  A
carry whose body changes its placement (a replicated accumulator plus a
partial-sum gradient is a partial sum) is traced again under the
placement it comes out with, and ``init`` is redistributed to it; the
results come back as DTensors under the placements the trace recorded.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch
import torch.fx as fx
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
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
    n_consts: int = 0


def trace_body(f: Callable, init, xs, consts=None) -> _Traced:
    """Trace one iteration ``f(init, xs[0])``, or ``f(init, xs[0], consts)``
    when ``consts`` is given, into an fx graph with placeholders ``[*carry,
    *x, *consts]`` and outputs ``[*carry, *y]`` (flattened leaves), in fake
    mode with contiguous stand-ins for the inputs: nothing runs on the
    device.  Any dispatch mode active around the call (an enclosing trace)
    is set aside while tracing, so a fissioned loop nested in a traced body
    is traced on its own."""
    flat_init, carry_tree = pytree.tree_flatten(init)
    flat_xs, xs_tree = pytree.tree_flatten(xs)
    flat_c, c_tree = ([], None) if consts is None else pytree.tree_flatten(consts)
    n_carry, n_x = len(flat_init), len(flat_xs)
    trees = {}

    def flat_body(*flat):
        carry = pytree.tree_unflatten(list(flat[:n_carry]), carry_tree)
        x = pytree.tree_unflatten(list(flat[n_carry:n_carry + n_x]), xs_tree)
        if consts is None:
            new_carry, y = f(carry, x)
        else:
            new_carry, y = f(carry, x, pytree.tree_unflatten(list(flat[n_carry + n_x:]),
                                                             c_tree))
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
                            for x in flat_xs]
                         + [torch.empty(c.shape, dtype=c.dtype, device=c.device)
                            for c in flat_c])
        gm = make_fx(flat_body, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*stand_ins)
    return _Traced(gm, n_carry, carry_tree, trees["y"], len(flat_c))


def _signature(tree) -> tuple:
    """A tree's structure and its leaves' shapes, dtypes and devices."""
    if tree is None:
        return None
    leaves, spec = pytree.tree_flatten(tree)
    return repr(spec), tuple((tuple(a.shape), a.dtype, a.device) for a in leaves)


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
        if all(ddg.is_const(a) or ddg.def_site.get(a) in inv
               for a in e.all_input_nodes):
            inv.add(i)
    return inv


def _subgraph(gm: fx.GraphModule, ddg: ScanBodyDDG, inv: set[int], inputs: list,
              eqn_idxs, outputs: list) -> fx.GraphModule:
    """A GraphModule over ``gm``'s constants: placeholders ``inputs`` and
    then the ``consts`` inputs, the equations ``eqn_idxs`` in graph order,
    outputs ``outputs``.  Closed-over constants and loop-invariant
    equations are copied in where read."""
    g = fx.Graph()
    env: dict = {}
    for k, n in enumerate(inputs + ddg.const_in):
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
    consts=None,
    plans: Optional[dict] = None,
    report: Optional[FissionReport] = None,
    _depth: int = 0,
    _traced: Optional[_Traced] = None,
):
    """:func:`scan` with Rule A applied at every query in the body.

    With ``consts`` the body is ``f(carry, x, consts)``.  ``plans`` keeps
    the plans across calls (module docstring); without it each call
    traces.  Falls back to plain :func:`scan` when the body has no
    queries.  Raises :class:`FissionPreconditionError` when a query lies
    on a true-dependence cycle (its submission needs a previous
    iteration's result) or the body has external effects.
    """
    if _depth > 8:
        raise RecursionError("fission_scan: too many chained queries")
    bound = f if consts is None else (lambda carry, x: f(carry, x, consts))
    plans = {} if plans is None else plans
    if any(isinstance(t, DTensor) for t in pytree.tree_leaves((init, xs, consts))):
        return _fission_sharded(f, init, xs, consts, length, report, plans)
    key = (_signature(init), _signature(xs), _signature(consts), length)
    if key not in plans:
        tr = _traced if _traced is not None else trace_body(f, init, xs, consts)
        plans[key] = _make_plan(tr, report if _depth == 0 else None)
    plan = plans[key]
    if plan is None:
        return scan(bound, init, xs, length=length)
    return _run_plan(plan, init, xs, consts, length, report, _depth)


@dataclasses.dataclass
class _Plan:
    """One application of Rule A to a traced body (module docstring)."""

    tr: _Traced
    n_queries: int
    p_pos: list            # carry positions on the producer side
    c_pos: list            # and on the consumer side
    prod_gm: fx.GraphModule
    const_gm: fx.GraphModule  # the query's invariant arguments
    cons_gm: fx.GraphModule
    q_plan: list           # per query argument: ("lit", v), ("const", None),
    #                        ("xs", x position) or ("ctx", context index)
    spec: object
    n_ctx: int
    producer_y_pos: list
    consumer_y_pos: list
    consumer_x_pos: list
    n_y: int
    nested: bool           # queries remain on the consumer side
    sub: dict              # the consumer loop's plans


def _make_plan(tr: _Traced, report: Optional[FissionReport] = None) -> Optional[_Plan]:
    """Split ``tr``'s body at its first query (``None``: no query); the
    queries found go into ``report`` before any precondition is checked."""
    gm = tr.gm
    n_carry = tr.n_carry
    ddg = ScanBodyDDG(gm.graph, n_carry, tr.n_consts)
    eqns = ddg.eqns

    q_idxs = [i for i, e in enumerate(eqns) if query_spec_of(e.target) is not None]
    if not q_idxs:
        return None
    if report is not None:
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
        if ddg.is_const(v) or ddg.def_site.get(v) in inv:
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
    q_args: list[tuple[str, object]] = []
    for v in q_node.args:
        if not isinstance(v, fx.Node):
            q_args.append(("lit", v))
        elif side(v) == "const":
            q_args.append(("const", v))
        elif side(v) == "x":
            q_args.append(("xs", x_pos[v]))
        elif side(v) in ("prod", "pcarry"):
            if v not in ctx_vars:
                ctx_vars.append(v)
            q_args.append(("ctx", v))
        else:  # consumer side: a cycle, which check_split has raised on
            raise FissionPreconditionError("query argument produced on the consumer side")
    ctx_index = {v: i for i, v in enumerate(ctx_vars)}

    p_pos, c_pos = sorted(producer_pos), sorted(consumer_pos)
    prod_gm = _subgraph(
        gm, ddg, inv, [ddg.carry_in[j] for j in p_pos] + ddg.x_in, producer_eqns,
        [ddg.carry_out[j] for j in p_pos] + ctx_vars
        + [ddg.y_out[k] for k in producer_y_pos])
    const_gm = _subgraph(gm, ddg, inv, [], [],
                         [v for kind, v in q_args if kind == "const"])
    cons_gm = _subgraph(
        gm, ddg, inv,
        [ddg.carry_in[j] for j in c_pos] + [q_node] + ctx_vars
        + [ddg.x_in[i] for i in consumer_x_pos],
        consumer_list,
        [ddg.carry_out[j] for j in c_pos] + [ddg.y_out[k] for k in consumer_y_pos])
    q_plan = [(kind, ctx_index[v] if kind == "ctx" else None if kind == "const" else v)
              for kind, v in q_args]
    nested = any(query_spec_of(eqns[i].target) is not None for i in consumer_list)
    return _Plan(tr, len(q_idxs), p_pos, c_pos, prod_gm, const_gm, cons_gm, q_plan, spec,
                 len(ctx_vars), producer_y_pos, consumer_y_pos, consumer_x_pos,
                 len(ddg.y_out), nested, {})


def _run_plan(plan: _Plan, init, xs, consts, length, report, depth: int):
    """Run the producer loop, ONE batched query and the consumer loop of
    ``plan`` on these inputs."""
    flat_init = [c.contiguous() for c in pytree.tree_leaves(init)]
    flat_xs = [x.contiguous() for x in pytree.tree_leaves(xs)]
    flat_c = [] if consts is None else pytree.tree_leaves(consts)
    p_pos, c_pos, n_ctx = plan.p_pos, plan.c_pos, plan.n_ctx
    if report is not None and depth == 0:
        report.n_queries_found = plan.n_queries

    # ---- producer loop -----------------------------------------------------
    def producer_body(carry_p, x_flat):
        outs = _call(plan.prod_gm, (*carry_p, *x_flat, *flat_c))
        k = len(p_pos)
        return tuple(outs[:k]), (tuple(outs[k:k + n_ctx]), tuple(outs[k + n_ctx:]))

    carry_p_final, (ctx_stacked, ys_p_stacked) = scan(
        producer_body, tuple(flat_init[j] for j in p_pos), tuple(flat_xs), length=length)

    # ---- ONE batched query execution (the set-oriented form) --------------
    invariant = iter(_call(plan.const_gm, flat_c))
    args, mask = [], []
    for kind, payload in plan.q_plan:
        if kind == "lit":
            args.append(payload)
        elif kind == "const":
            args.append(next(invariant))
        elif kind == "xs":
            args.append(flat_xs[payload])
        else:
            args.append(ctx_stacked[payload])
        mask.append(kind in ("xs", "ctx"))
    q_res = plan.spec.batched(mask)(*args)
    if report is not None:
        report.n_queries_batched += 1
        report.batched_specs.append(plan.spec.name)

    # ---- consumer loop -----------------------------------------------------
    def consumer_body(carry_c, per_iter, consts_c=flat_c):
        qres, ctx_slice, x_slice = per_iter
        outs = _call(plan.cons_gm, (*carry_c, qres, *ctx_slice, *x_slice, *consts_c))
        return tuple(outs[:len(c_pos)]), tuple(outs[len(c_pos):])

    consumer_xs = (q_res, tuple(ctx_stacked),
                   tuple(flat_xs[i] for i in plan.consumer_x_pos))
    carry_c_init = tuple(flat_init[j] for j in c_pos)
    # Repeated application (§3.2) while queries remain on the consumer side.
    if plan.nested:
        carry_c_final, ys_c_stacked = fission_scan(
            consumer_body, carry_c_init, consumer_xs, consts=list(flat_c),
            plans=plan.sub, report=report, _depth=depth + 1)
    else:
        carry_c_final, ys_c_stacked = scan(consumer_body, carry_c_init, consumer_xs)

    # ---- reassemble ---------------------------------------------------------
    flat_carry: list = [None] * plan.tr.n_carry
    for idx, j in enumerate(p_pos):
        flat_carry[j] = carry_p_final[idx]
    for idx, j in enumerate(c_pos):
        flat_carry[j] = carry_c_final[idx]
    flat_ys: list = [None] * plan.n_y
    for idx, k in enumerate(plan.producer_y_pos):
        flat_ys[k] = ys_p_stacked[idx]
    for idx, k in enumerate(plan.consumer_y_pos):
        flat_ys[k] = ys_c_stacked[idx]
    return (pytree.tree_unflatten(flat_carry, plan.tr.carry_tree),
            pytree.tree_unflatten(flat_ys, plan.tr.y_tree))


def _placements(t, mesh):
    """A leaf's placements (a plain tensor counts as replicated)."""
    return tuple(t.placements) if isinstance(t, DTensor) else (Replicate(),) * mesh.ndim


def _shift(placements, by: int) -> tuple:
    """Placements of a stacked leaf's slice (``by`` -1) or of a stack of
    slices (``by`` +1): a sharded dim moves with the leading axis."""
    return tuple(Shard(p.dim + by) if isinstance(p, Shard) else p for p in placements)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _local_as(t, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``t`` laid out as ``placements``.  DTensor
    refuses to make a partial result of a replicated value, so that is done
    here: every rank keeps the value for a partial mean, max or min, and
    for a partial sum the value stays on coordinate 0 of the mesh dim and
    the others hold zeros."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    to_partial = [isinstance(p, Partial) and isinstance(q, Replicate)
                  for p, q in zip(placements, t.placements)]
    keep = tuple(q if m else p for p, q, m in zip(placements, t.placements, to_partial))
    loc = (t if tuple(t.placements) == keep else t.redistribute(mesh, keep)).to_local()
    if any(m and placements[d].reduce_op == "sum" and mesh.get_local_rank(d)
           for d, m in enumerate(to_partial)):
        loc = torch.zeros_like(loc)
    return loc


@contextlib.contextmanager
def _strided_offsets_untraced():
    """DTensor finds a strided shard's size (``_StridedShard.
    local_shard_size_and_offset``, which the MoE branch's backward reaches)
    from an index tensor it builds and reads with ``.tolist()``; under the
    trace's fake mode that tensor is fake and the read raises.  It is shape
    arithmetic on integers, so it runs outside the trace's modes here."""
    from torch.distributed.tensor import placement_types

    cls = getattr(placement_types, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def untraced(self, *args, **kwargs):
        with _disable_current_modes():
            return orig(self, *args, **kwargs)

    cls.local_shard_size_and_offset = untraced
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


@dataclasses.dataclass
class _ShardedPlan:
    """What :func:`_fission_sharded` keeps of one signature: the carry's
    settled placements, the placements and structure the trace recorded
    for the results, and the plans of the rank's local program."""

    carry_pl: list
    seen: dict
    sub: dict


def _fission_sharded(f: Callable, init, xs, consts, length, report, plans: dict):
    """:func:`fission_scan` over DTensor leaves: Rule A on each rank's own
    traced program (module docstring), its plan kept in ``plans`` under
    the rank's local signature and the placements, so each rank traces
    once per batch shape."""
    flat_init, carry_tree = pytree.tree_flatten(init)
    flat_xs, xs_tree = pytree.tree_flatten(xs)
    flat_c, c_tree = ([], None) if consts is None else pytree.tree_flatten(consts)
    mesh = next(t for t in flat_init + flat_xs + flat_c if isinstance(t, DTensor)).device_mesh
    carry_pl0 = [_placements(t, mesh) for t in flat_init]
    x_pl = [_shift(_placements(t, mesh), -1) for t in flat_xs]
    c_pl = [_placements(t, mesh) if isinstance(t, DTensor) else None for t in flat_c]
    local_xs = pytree.tree_unflatten([_local(t) for t in flat_xs], xs_tree)
    local_c = None if consts is None else pytree.tree_unflatten([_local(t) for t in flat_c],
                                                                 c_tree)
    key = ("sharded", mesh, _signature(pytree.tree_unflatten([_local(t) for t in flat_init],
                                                             carry_tree)),
           tuple(carry_pl0), _signature(local_xs), tuple(x_pl), _signature(local_c),
           tuple(c_pl), length)
    entry = plans.get(key)
    fresh = entry is None
    if fresh:
        entry = _ShardedPlan(carry_pl0, {}, {})
    seen = entry.seen

    def wrap(ts, pls):
        return [t if pl is None else DTensor.from_local(t, mesh, pl, run_check=False)
                for t, pl in zip(ts, pls)]

    def local_f(carry, x, c=None):
        cw = pytree.tree_unflatten(wrap(pytree.tree_leaves(carry), entry.carry_pl), carry_tree)
        xw = pytree.tree_unflatten(wrap(pytree.tree_leaves(x), x_pl), xs_tree)
        if consts is None:
            new_carry, y = f(cw, xw)
        else:
            new_carry, y = f(cw, xw, pytree.tree_unflatten(wrap(pytree.tree_leaves(c), c_pl),
                                                           c_tree))
        out_c = pytree.tree_leaves(new_carry)
        flat_y, seen["y_tree"] = pytree.tree_flatten(y)
        seen["carry"] = [_placements(t, mesh) for t in out_c]
        seen["y"] = [None if t is None else _placements(t, mesh) for t in flat_y]
        return (pytree.tree_unflatten([_local(t) for t in out_c], carry_tree),
                pytree.tree_unflatten([None if t is None else _local(t) for t in flat_y],
                                      seen["y_tree"]))

    def local_init():
        return pytree.tree_unflatten([_local_as(t, mesh, pl) for t, pl in
                                      zip(flat_init, entry.carry_pl)], carry_tree)

    tr = None
    with _strided_offsets_untraced():
        if fresh:
            for _ in range(3):  # the carry's placements to a fixed point
                tr = trace_body(local_f, local_init(), local_xs, local_c)
                if seen["carry"] == entry.carry_pl:
                    break
                entry.carry_pl = seen["carry"]
            else:
                raise FissionPreconditionError(
                    f"the carry's placements do not settle: {entry.carry_pl}")
        carry, ys = fission_scan(local_f, local_init(), local_xs, length=length,
                                 consts=local_c, plans=entry.sub, report=report, _traced=tr)
    plans[key] = entry
    flat_carry = wrap(pytree.tree_leaves(carry), entry.carry_pl)
    flat_ys = [None if t is None else DTensor.from_local(t, mesh, _shift(pl, 1),
                                                         run_check=False)
               for t, pl in zip(pytree.tree_leaves(ys), seen["y"])]
    return (pytree.tree_unflatten(flat_carry, carry_tree),
            pytree.tree_unflatten(flat_ys, seen["y_tree"]))


def scan_with_queries(f: Callable, init, xs, *, fission: bool = True, length=None,
                      consts=None, plans: Optional[dict] = None):
    """Config-switchable entry point: the *same* model code runs either the
    paper-faithful per-iteration form (``fission=False``, the baseline) or
    the fissioned batched form (``fission=True``, with ``plans`` cached).
    With ``consts`` the body is ``f(carry, x, consts)``."""
    if fission:
        return fission_scan(f, init, xs, length=length, consts=consts, plans=plans)
    if consts is not None:
        return scan(lambda carry, x: f(carry, x, consts), init, xs, length=length)
    return scan(f, init, xs, length=length)
