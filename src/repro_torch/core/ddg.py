"""Data-dependence analysis over a traced loop body (§3.1 of the paper).

Port of :mod:`repro.core.ddg` from jaxprs to ``torch.fx`` graphs.  A scan
body traced with ``make_fx`` is an fx graph whose

* ``placeholder`` nodes are ``[*carry_in, *x]`` (the jaxpr's invars),
* ``output`` node holds ``[*carry_out, *y]`` (the outvars),
* ``get_attr`` nodes are the closed-over tensors, such as the parameters
  (the jaxpr's constvars), and
* ``call_function`` nodes are the equations, numbered in graph order.

Anything in a node's arguments that is not a node is a literal.

A jaxpr is SSA and pure.  An fx graph of aten ops is SSA too, except that
an in-place op (``add_``, the autograd engine's gradient accumulation)
writes a value that earlier nodes read.  To keep "runs before" in the
graph's edges, every earlier reader of a value that an in-place node
writes gets an edge to that node (an anti-dependence); later readers read
the in-place node itself, since tracing hands them its output.  Writes
into a placeholder or a closed-over tensor are external state: the fission
pass refuses them (precondition (b)).

The loop-carried structure is the reference's: carry outputs of iteration
t feed carry inputs of t + 1, the paper's ``LFD`` edges, which Rule A's
precondition (a) is about.  The methods keep the reference's names and
semantics: ``downstream``, ``upstream_of_vars``, ``eqn_reads``,
``side_reads``, ``classify_carry``, ``check_split``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import torch.fx as fx

__all__ = ["ScanBodyDDG", "FissionPreconditionError", "written_args", "is_view"]


class FissionPreconditionError(ValueError):
    """Rule A precondition violated on the device loop (see message)."""


def _is_literal(v) -> bool:
    return not isinstance(v, fx.Node)


def written_args(node: fx.Node) -> list[fx.Node]:
    """The argument nodes that ``node`` writes in place (schema
    ``alias_info.is_write``)."""
    schema = getattr(node.target, "_schema", None)
    if node.op != "call_function" or schema is None:
        return []
    out = []
    for i, arg in enumerate(schema.arguments):
        info = arg.alias_info
        if info is None or not info.is_write:
            continue
        v = node.args[i] if i < len(node.args) else node.kwargs.get(arg.name)
        out.extend(x for x in (v if isinstance(v, (list, tuple)) else [v])
                   if isinstance(x, fx.Node))
    return out


def _output_values(graph: fx.Graph) -> list:
    out = next(n for n in graph.nodes if n.op == "output")
    vals = out.args[0]
    return list(vals) if isinstance(vals, (list, tuple)) else [vals]


@dataclasses.dataclass
class ScanBodyDDG:
    """DDG of a traced scan body: placeholders ``[*carry_in, *x]``, outputs
    ``[*carry_out, *y]`` with ``len(carry_in) == n_carry``."""

    graph: fx.Graph
    n_carry: int

    def __post_init__(self):
        nodes = list(self.graph.nodes)
        ins = [n for n in nodes if n.op == "placeholder"]
        outs = _output_values(self.graph)
        self.eqns = [n for n in nodes if n.op == "call_function"]
        self.carry_in = ins[: self.n_carry]
        self.x_in = ins[self.n_carry:]
        self.carry_out = outs[: self.n_carry]
        self.y_out = outs[self.n_carry:]
        self.consts = [n for n in nodes if n.op == "get_attr"]

        # node -> producing eqn index (SSA def site); inputs/consts absent.
        self.def_site: dict[Any, int] = {n: i for i, n in enumerate(self.eqns)}

        # eqn -> eqn flow edges (def -> use), plus reader -> in-place writer.
        self.succ: dict[int, set[int]] = {i: set() for i in range(len(self.eqns))}
        for i, eqn in enumerate(self.eqns):
            for iv in eqn.all_input_nodes:
                d = self.def_site.get(iv)
                if d is not None and d != i:
                    self.succ[d].add(i)
            for w in written_args(eqn):
                for user in w.users:
                    j = self.def_site.get(user)
                    if j is not None and j < i:
                        self.succ[j].add(i)

    # ------------------------------------------------------------------ sets
    def upstream_of_vars(self, vars: Iterable[Any]) -> set[int]:
        """Equations transitively needed to compute ``vars`` (def-site
        closure): the statements that must stay on the producer side of a
        split because the query's inputs flow through them."""
        seen: set[int] = set()
        stack = [self.def_site[v] for v in vars if v in self.def_site]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            for iv in self.eqns[cur].all_input_nodes:
                d = self.def_site.get(iv)
                if d is not None:
                    stack.append(d)
        return seen

    def downstream(self, idx: int) -> set[int]:
        """Equations transitively dependent on equation ``idx`` (including
        ``idx`` itself): the consumer side of a split at idx."""
        seen = {idx}
        stack = [idx]
        while stack:
            cur = stack.pop()
            for nxt in self.succ[cur]:
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return seen

    def eqn_reads(self, idx: int) -> set[Any]:
        return set(self.eqns[idx].all_input_nodes)

    def side_reads(self, eqn_idxs: Iterable[int]) -> set[Any]:
        out: set[Any] = set()
        for i in eqn_idxs:
            out |= self.eqn_reads(i)
        return out

    # ----------------------------------------------------- carry classification
    def classify_carry(self, consumer_eqns: set[int]) -> tuple[set[int], set[int]]:
        """Split carry positions into (producer_positions, consumer_positions).

        A position is *consumer* if its carry-out value is produced by a
        consumer equation, or (fixed point) if its carry-out is a
        pass-through of the carry-in of a consumer position (the recurrence
        then lives wholly on the consumer side).
        """
        n = self.n_carry
        consumer_pos: set[int] = set()
        for j in range(n):
            ov = self.carry_out[j]
            if _is_literal(ov):
                continue
            d = self.def_site.get(ov)
            if d is not None and d in consumer_eqns:
                consumer_pos.add(j)
        changed = True
        while changed:
            changed = False
            consumer_carry_in = {self.carry_in[j] for j in consumer_pos}
            for j in range(n):
                if j in consumer_pos:
                    continue
                ov = self.carry_out[j]
                if not _is_literal(ov) and ov in consumer_carry_in:
                    consumer_pos.add(j)
                    changed = True
        producer_pos = set(range(n)) - consumer_pos
        return producer_pos, consumer_pos

    # ----------------------------------------------------------- precondition
    def check_split(
        self, query_idx: int, consumer_eqns: set[int], consumer_pos: set[int]
    ) -> None:
        """Rule A precondition (a) on the device loop: no loop-carried flow
        dependence may cross the split.  A carry position whose output is
        computed by the consumer side must not have its input read by the
        producer side (the query's own arguments included): iteration t+1's
        submission would depend on iteration t's consumption.
        Precondition (b) is checked by the fission pass (effectful nodes).
        """
        producer_eqns = set(range(len(self.eqns))) - consumer_eqns
        producer_reads = self.side_reads(producer_eqns | {query_idx})
        for j in sorted(consumer_pos):
            civ = self.carry_in[j]
            if civ in producer_reads:
                raise FissionPreconditionError(
                    f"loop-carried flow dependence crosses the split: carry "
                    f"position {j} is produced by the consumer side but its "
                    f"previous-iteration value is read by the producer side "
                    f"(query inputs depend on query results across "
                    f"iterations). Rule A is inapplicable — the query lies "
                    f"on a true-dependence cycle (paper §4.1)."
                )
        # A query argument produced by the consumer side is the
        # intra-iteration version of the same cycle.
        for v in self.eqn_reads(query_idx):
            d = self.def_site.get(v)
            if d is not None and d in consumer_eqns and d != query_idx:
                raise FissionPreconditionError(
                    "query argument depends on the query's own result within "
                    "an iteration — true-dependence cycle, Rule A inapplicable."
                )


def is_view(node: fx.Node) -> bool:
    """Whether ``node``'s output aliases its first argument (a view op)."""
    schema = getattr(node.target, "_schema", None)
    if node.op != "call_function" or schema is None or not schema.returns:
        return False
    info = schema.returns[0].alias_info
    return info is not None and not info.is_write

