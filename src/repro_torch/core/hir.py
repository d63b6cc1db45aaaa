"""Host-level IR (HIR) — the paper's source-to-source transformer.

The paper (Ramachandra et al., "Program Transformations for Asynchronous and
Batched Query Submission") rewrites Java/JDBC programs.  Our host-level IR is
the language-neutral core of that tool: a tiny imperative language of
statements with explicit read/write sets, over which we implement

  * the **data dependence graph** (§3.1): flow / anti / output dependencies
    and their loop-carried variants, plus *external* dependencies through a
    shared service (the "database"),
  * **Rule B** (§3.3): control-dependence → flow-dependence conversion by
    predication (guard variables),
  * **statement reordering** ([4] §"Applicability"): dependence-preserving
    topological reordering that moves the query and its dependents apart so
    the Rule A precondition holds,
  * **Rule A** (§3.2): loop fission at a query statement into a *producer*
    loop (asynchronous ``submit``) and a *consumer* loop (blocking ``fetch``),
    communicating through a **loop context table**,
  * **nested-loop fission** (§3.4), and
  * the **applicability analysis** of §6.2 (Table 1).

Programs in this IR are *executable*: :class:`Interpreter` runs them against
a :class:`~repro.core.services.QueryService`, so every transformation can be
property-tested for semantic equivalence (transformed(program) ≡ program).

The IR deliberately mirrors the paper's presentation:

  ``v = executeQuery(q)``  →  :class:`Query` statement
  ``ss1; s; ss2``          →  :class:`Loop` body (list of statements)
  guard variables          →  ``Assign.guard`` (Rule B predication)

Expressions are Python callables over an environment dict; read/write sets
are declared explicitly (exactly the information SOOT/Jimple dataflow gives
the paper's tool).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Any, Callable, Mapping, Optional, Sequence

__all__ = [
    "Stmt",
    "Assign",
    "Query",
    "If",
    "Loop",
    "Proc",
    "Call",
    "Program",
    "DepKind",
    "DepEdge",
    "DataDependenceGraph",
    "build_ddg",
    "apply_rule_b",
    "reorder_for_fission",
    "FissionError",
    "apply_rule_a",
    "fission_loop",
    "can_inline",
    "inline_call",
    "transform_program",
    "enumerate_fission_sites",
    "analyze_applicability",
    "collect_names",
    "Interpreter",
]


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Stmt:
    """Base statement.  ``guard`` is the Rule B predication variable: when
    set, the statement only executes if ``env[guard]`` is truthy (negated if
    ``guard_negated``)."""

    guard: Optional[str] = dataclasses.field(default=None, kw_only=True)
    guard_negated: bool = dataclasses.field(default=False, kw_only=True)

    # --- dataflow interface -------------------------------------------------
    def reads(self) -> frozenset[str]:
        raise NotImplementedError

    def writes(self) -> frozenset[str]:
        raise NotImplementedError

    def external_reads(self) -> bool:
        """True if the statement reads external state (the database)."""
        return False

    def external_writes(self) -> bool:
        """True if the statement writes external state (the database)."""
        return False

    def _guard_reads(self) -> frozenset[str]:
        return frozenset([self.guard]) if self.guard else frozenset()

    def with_guard(self, guard: str, negated: bool = False) -> "Stmt":
        new = dataclasses.replace(self)
        if new.guard is not None:
            raise ValueError(
                "nested guards unsupported; apply Rule B innermost-first "
                "(the paper groups guards back in a readability pass)"
            )
        new.guard = guard
        new.guard_negated = negated
        return new


@dataclasses.dataclass
class Assign(Stmt):
    """``target = fn(*[env[v] for v in args])``.

    ``effect`` marks external writes (e.g. ``log``/``print``/DB update —
    §3.1 "External data dependencies"); such statements are modelled
    conservatively as writing the external resource named by ``effect``.
    """

    target: Optional[str] = None
    fn: Callable[..., Any] = None  # type: ignore[assignment]
    args: tuple[str, ...] = ()
    effect: Optional[str] = None

    def reads(self) -> frozenset[str]:
        return frozenset(self.args) | self._guard_reads()

    def writes(self) -> frozenset[str]:
        return frozenset([self.target]) if self.target else frozenset()

    def external_writes(self) -> bool:
        return self.effect is not None

    def __repr__(self) -> str:  # readable transformed programs (§4.1 goal 1)
        g = f"[{'!' if self.guard_negated else ''}{self.guard}] " if self.guard else ""
        t = f"{self.target} = " if self.target else ""
        return f"{g}{t}{getattr(self.fn, '__name__', 'fn')}({', '.join(self.args)})"


@dataclasses.dataclass
class Query(Stmt):
    """``target = executeQuery(query_name, params...)`` — the blocking call.

    ``updates_db`` marks data-modifying statements (INSERT/UPDATE): they are
    external writes, any query is an external read (§3.1, §8 "update
    transactions" — conservative model).
    """

    target: Optional[str] = None
    query_name: str = ""
    params: tuple[str, ...] = ()
    updates_db: bool = False

    def reads(self) -> frozenset[str]:
        return frozenset(self.params) | self._guard_reads()

    def writes(self) -> frozenset[str]:
        return frozenset([self.target]) if self.target else frozenset()

    def external_reads(self) -> bool:
        return True

    def external_writes(self) -> bool:
        return self.updates_db

    def __repr__(self) -> str:
        g = f"[{'!' if self.guard_negated else ''}{self.guard}] " if self.guard else ""
        return (
            f"{g}{self.target} = executeQuery({self.query_name!r}, "
            f"{', '.join(self.params)})"
        )


@dataclasses.dataclass
class _Submit(Stmt):
    """``handle = submitQuery(...)`` — produced by Rule A, non-blocking."""

    target: Optional[str] = None
    query_name: str = ""
    params: tuple[str, ...] = ()

    def reads(self) -> frozenset[str]:
        return frozenset(self.params) | self._guard_reads()

    def writes(self) -> frozenset[str]:
        return frozenset([self.target]) if self.target else frozenset()

    def external_reads(self) -> bool:
        return True

    def __repr__(self) -> str:
        g = f"[{'!' if self.guard_negated else ''}{self.guard}] " if self.guard else ""
        return (
            f"{g}{self.target} = submitQuery({self.query_name!r}, "
            f"{', '.join(self.params)})"
        )


@dataclasses.dataclass
class _Fetch(Stmt):
    """``v = fetchResult(handle)`` — produced by Rule A, blocking."""

    target: Optional[str] = None
    handle: str = ""

    def reads(self) -> frozenset[str]:
        return frozenset([self.handle]) | self._guard_reads()

    def writes(self) -> frozenset[str]:
        return frozenset([self.target]) if self.target else frozenset()

    def __repr__(self) -> str:
        g = f"[{'!' if self.guard_negated else ''}{self.guard}] " if self.guard else ""
        return f"{g}{self.target} = fetchResult({self.handle})"


@dataclasses.dataclass
class If(Stmt):
    """``if (pred_var) { then_body } else { else_body }`` (§3.3)."""

    pred: str = ""
    then_body: list[Stmt] = dataclasses.field(default_factory=list)
    else_body: list[Stmt] = dataclasses.field(default_factory=list)

    def reads(self) -> frozenset[str]:
        r = frozenset([self.pred]) | self._guard_reads()
        for s in itertools.chain(self.then_body, self.else_body):
            r |= s.reads()
        return r

    def writes(self) -> frozenset[str]:
        w: frozenset[str] = frozenset()
        for s in itertools.chain(self.then_body, self.else_body):
            w |= s.writes()
        return w

    def external_reads(self) -> bool:
        return any(
            s.external_reads() for s in itertools.chain(self.then_body, self.else_body)
        )

    def external_writes(self) -> bool:
        return any(
            s.external_writes()
            for s in itertools.chain(self.then_body, self.else_body)
        )

    def __repr__(self) -> str:
        return f"if ({self.pred}) {{ {len(self.then_body)} stmts }} else {{ {len(self.else_body)} stmts }}"


@dataclasses.dataclass
class Loop(Stmt):
    """``for item_var in env[iter_var]: body`` — the paper's generic loop.

    The paper presents Rule A for ``while`` loops; our executable form is the
    for-each loop (the paper's own second loop in Rule A's RHS is exactly
    this).  ``while`` loops whose predicate is updated by the body are
    expressible by reordering (Example 4/5) and covered in tests via an
    explicit counter idiom.
    """

    item_var: str = ""
    iter_var: str = ""
    body: list[Stmt] = dataclasses.field(default_factory=list)

    def reads(self) -> frozenset[str]:
        r = frozenset([self.iter_var]) | self._guard_reads()
        for s in self.body:
            r |= s.reads()
        return r - frozenset([self.item_var])

    def writes(self) -> frozenset[str]:
        w: frozenset[str] = frozenset()
        for s in self.body:
            w |= s.writes()
        return w

    def external_reads(self) -> bool:
        return any(s.external_reads() for s in self.body)

    def external_writes(self) -> bool:
        return any(s.external_writes() for s in self.body)

    def __repr__(self) -> str:
        return f"for {self.item_var} in {self.iter_var}: {{ {len(self.body)} stmts }}"


@dataclasses.dataclass
class Proc:
    """A named procedure definition (Guravannavar thesis, ch. on procedure
    boundaries): formal parameters, a statement body executed in its OWN
    scope (callees cannot read caller variables — every body read must be a
    formal or a previously-written local), and an optional ``result`` local
    returned to the caller.

    ``Proc`` is a definition, not a statement: it only runs when a
    :class:`Call` names it.  Because callee scopes are isolated, a call's
    dataflow summary is exact — reads = args, writes = {target} — which is
    what lets :func:`inline_call` rename the body into the caller without
    changing any dependence.
    """

    name: str = "proc"
    formals: tuple[str, ...] = ()
    body: list[Stmt] = dataclasses.field(default_factory=list)
    result: Optional[str] = None

    def __repr__(self) -> str:
        return (
            f"proc {self.name}({', '.join(self.formals)}) "
            f"{{ {len(self.body)} stmts }} -> {self.result}"
        )


@dataclasses.dataclass
class Call(Stmt):
    """``target = proc(args...)`` — procedure invocation by direct reference.

    The callee runs in a fresh scope seeded only with ``formals`` bound to
    the caller's ``args`` values; on return, the callee's ``result`` local
    (if any) is assigned to ``target``.  External effects (queries, logs)
    inside the body happen against the shared service, so the call's
    external read/write summary is the body's.
    """

    target: Optional[str] = None
    proc: Proc = None  # type: ignore[assignment]
    args: tuple[str, ...] = ()

    def reads(self) -> frozenset[str]:
        return frozenset(self.args) | self._guard_reads()

    def writes(self) -> frozenset[str]:
        return frozenset([self.target]) if self.target else frozenset()

    def external_reads(self) -> bool:
        return any(s.external_reads() for s in self.proc.body)

    def external_writes(self) -> bool:
        return any(s.external_writes() for s in self.proc.body)

    def __repr__(self) -> str:
        g = f"[{'!' if self.guard_negated else ''}{self.guard}] " if self.guard else ""
        t = f"{self.target} = " if self.target else ""
        return f"{g}{t}{self.proc.name}({', '.join(self.args)})"


@dataclasses.dataclass
class _ProducerConsumer(Stmt):
    """Result of Rule A: producer loop + consumer loop over a context table.

    Executed by the interpreter either sequentially (basic Rule A) or with
    the producer in its own thread over a blocking queue (§5.1 overlap,
    ``overlap=True``).
    """

    producer: Loop = None  # type: ignore[assignment]
    consumer_body: list[Stmt] = dataclasses.field(default_factory=list)
    table_var: str = ""
    record_var: str = ""
    split_vars: tuple[str, ...] = ()
    overlap: bool = False

    def reads(self) -> frozenset[str]:
        r = self.producer.reads()
        for s in self.consumer_body:
            r |= s.reads()
        return r - frozenset(self.split_vars) - frozenset([self.table_var, self.record_var])

    def writes(self) -> frozenset[str]:
        w = self.producer.writes()
        for s in self.consumer_body:
            w |= s.writes()
        return w

    def external_reads(self) -> bool:
        return True

    def external_writes(self) -> bool:
        # A fissioned loop still performs whatever external writes (logs,
        # effects) its statements perform — an enclosing loop's dependence
        # analysis must keep seeing them or nested fission would reorder
        # emissions it may not.
        return self.producer.external_writes() or any(
            s.external_writes() for s in self.consumer_body
        )

    def __repr__(self) -> str:
        mode = "overlap" if self.overlap else "two-phase"
        return (
            f"fissioned[{mode}](producer={self.producer!r}, "
            f"consumer={{ {len(self.consumer_body)} stmts }})"
        )


@dataclasses.dataclass
class Program:
    """A statement sequence + the set of input variables."""

    body: list[Stmt]
    inputs: tuple[str, ...] = ()

    def __repr__(self) -> str:
        return "\n".join(repr(s) for s in self.body)


# ---------------------------------------------------------------------------
# Data dependence graph (§3.1)
# ---------------------------------------------------------------------------


class DepKind(enum.Enum):
    FLOW = "FD"
    ANTI = "AD"
    OUTPUT = "OD"
    LOOP_FLOW = "LFD"
    LOOP_ANTI = "LAD"
    LOOP_OUTPUT = "LOD"
    EXT_FLOW = "xFD"
    EXT_ANTI = "xAD"
    EXT_OUTPUT = "xOD"
    EXT_LOOP_FLOW = "xLFD"
    EXT_LOOP_ANTI = "xLAD"
    EXT_LOOP_OUTPUT = "xLOD"

    @property
    def loop_carried(self) -> bool:
        return self in (
            DepKind.LOOP_FLOW,
            DepKind.LOOP_ANTI,
            DepKind.LOOP_OUTPUT,
            DepKind.EXT_LOOP_FLOW,
            DepKind.EXT_LOOP_ANTI,
            DepKind.EXT_LOOP_OUTPUT,
        )

    @property
    def external(self) -> bool:
        return self.value.startswith("x")

    @property
    def flow(self) -> bool:
        return self in (
            DepKind.FLOW,
            DepKind.LOOP_FLOW,
            DepKind.EXT_FLOW,
            DepKind.EXT_LOOP_FLOW,
        )


@dataclasses.dataclass(frozen=True)
class DepEdge:
    src: int  # statement index
    dst: int
    kind: DepKind
    var: str  # variable (or external resource) carrying the dependence

    def __repr__(self) -> str:
        return f"s{self.src} --{self.kind.value}[{self.var}]--> s{self.dst}"


@dataclasses.dataclass
class DataDependenceGraph:
    stmts: list[Stmt]
    edges: list[DepEdge]

    def edges_from(self, i: int) -> list[DepEdge]:
        return [e for e in self.edges if e.src == i]

    def edges_to(self, i: int) -> list[DepEdge]:
        return [e for e in self.edges if e.dst == i]

    def intra_edges(self) -> list[DepEdge]:
        return [e for e in self.edges if not e.kind.loop_carried]

    def loop_carried_edges(self) -> list[DepEdge]:
        return [e for e in self.edges if e.kind.loop_carried]


_EXT = "__db__"  # §3.1: model the whole database as one external variable


def build_ddg(body: Sequence[Stmt], loop_body: bool = True) -> DataDependenceGraph:
    """Build the DDG of a statement sequence (Fig. 1 of the paper).

    With ``loop_body=True`` the sequence is treated as the body of a loop and
    loop-carried edges are added: for every (write in s_a, read in s_b) pair
    with a ≥ b order in the *next* iteration, an ``LFD`` edge, etc.  External
    dependencies conservatively route through the single resource ``__db__``
    (every query reads it, every update/effect writes it).
    """
    stmts = list(body)
    edges: list[DepEdge] = []

    def rw(s: Stmt) -> tuple[frozenset[str], frozenset[str]]:
        r, w = s.reads(), s.writes()
        if s.external_reads():
            r = r | {_EXT}
        if s.external_writes():
            w = w | {_EXT}
        return r, w

    rws = [rw(s) for s in stmts]

    # Intra-iteration edges (forward control flow only).
    for a in range(len(stmts)):
        ra, wa = rws[a]
        for b in range(a + 1, len(stmts)):
            rb, wb = rws[b]
            for v in wa & rb:  # a writes, b reads  → flow
                kind = DepKind.EXT_FLOW if v == _EXT else DepKind.FLOW
                edges.append(DepEdge(a, b, kind, v))
            for v in ra & wb:  # a reads, b writes  → anti
                kind = DepKind.EXT_ANTI if v == _EXT else DepKind.ANTI
                edges.append(DepEdge(a, b, kind, v))
            for v in wa & wb:  # both write         → output
                kind = DepKind.EXT_OUTPUT if v == _EXT else DepKind.OUTPUT
                edges.append(DepEdge(a, b, kind, v))

    if loop_body:
        # Loop-carried edges: s_a in iteration t, s_b in iteration t+1, for
        # *all* (a, b) pairs including a >= b (that is what makes them
        # loop-carried).
        for a in range(len(stmts)):
            ra, wa = rws[a]
            for b in range(len(stmts)):
                rb, wb = rws[b]
                for v in wa & rb:
                    kind = DepKind.EXT_LOOP_FLOW if v == _EXT else DepKind.LOOP_FLOW
                    edges.append(DepEdge(a, b, kind, v))
                for v in ra & wb:
                    kind = DepKind.EXT_LOOP_ANTI if v == _EXT else DepKind.LOOP_ANTI
                    edges.append(DepEdge(a, b, kind, v))
                for v in wa & wb:
                    kind = (
                        DepKind.EXT_LOOP_OUTPUT if v == _EXT else DepKind.LOOP_OUTPUT
                    )
                    edges.append(DepEdge(a, b, kind, v))

    return DataDependenceGraph(stmts, edges)


# ---------------------------------------------------------------------------
# Rule B (§3.3): control → flow dependencies
# ---------------------------------------------------------------------------


def apply_rule_b(
    body: Sequence[Stmt],
    *,
    reserved: Sequence[str] = (),
    _fresh: Optional["_FreshNames"] = None,
) -> list[Stmt]:
    """Flatten ``If`` statements into guarded statements (paper Rule B).

    ``if (p) {ss1} else {ss2}`` becomes ``cv = p; [cv] ss1; [!cv] ss2``.
    The predicate is already a variable in our IR, so no fresh assignment is
    needed unless the branch bodies might overwrite it — we always introduce
    the fresh ``cv`` for fidelity with the rule (and safety).

    ``reserved`` holds names that fresh guard variables must additionally
    avoid — callers transforming a whole program pass every name the
    program uses anywhere, so a generated ``cv_N`` can never collide with a
    user variable outside this body (see :class:`_FreshNames`).
    """
    out: list[Stmt] = []
    # One namer is shared across the whole recursion: If.reads()/writes()
    # aggregate their branch bodies, so the top-level namer already knows
    # every nested name, and sharing it keeps sibling/nested scopes from
    # reusing each other's generated guards.
    fresh = _fresh if _fresh is not None else _FreshNames(body, reserved=reserved)
    for s in body:
        if isinstance(s, If):
            inner_then = apply_rule_b(s.then_body, _fresh=fresh)
            inner_else = apply_rule_b(s.else_body, _fresh=fresh)
            cv = fresh("cv")
            # cv = p  (possibly itself guarded — nested Ifs come pre-flattened
            # by the recursive call, so s.guard is from an outer construct)
            cap = Assign(target=cv, fn=lambda p: bool(p), args=(s.pred,))
            if s.guard is not None:
                cap = cap.with_guard(s.guard, s.guard_negated)
            out.append(cap)
            for t in inner_then:
                out.append(_conjoin_guard(t, cv, False, fresh, out))
            for t in inner_else:
                out.append(_conjoin_guard(t, cv, True, fresh, out))
        else:
            out.append(s)
    return out


def _conjoin_guard(
    s: Stmt, cv: str, negated: bool, fresh: "_FreshNames", out: list[Stmt]
) -> Stmt:
    """Guard ``s`` with ``cv`` (negated as requested), conjoining any
    existing guard through a fresh boolean (guards are single variables)."""
    if s.guard is None:
        return s.with_guard(cv, negated)
    g_old, old_neg = s.guard, s.guard_negated
    conj = fresh("cv")

    def _and(a, b, _n1=old_neg, _n2=negated):
        va = (not a) if _n1 else bool(a)
        vb = (not b) if _n2 else bool(b)
        return va and vb

    _and.__name__ = "and"
    out.append(Assign(target=conj, fn=_and, args=(g_old, cv)))
    t = dataclasses.replace(s)
    t.guard = conj
    t.guard_negated = False
    return t


def collect_names(stmts: Sequence[Stmt]) -> set[str]:
    """Every variable name a statement sequence mentions anywhere: reads,
    writes, loop binders, guards — recursing into ``If``/``Loop`` bodies and
    into the bodies of procedures reachable through :class:`Call` (callee
    locals live in their own scope, but counting them keeps fresh names
    unique program-wide, which inlining relies on)."""
    names: set[str] = set()
    seen_procs: set[int] = set()

    def visit(seq: Sequence[Stmt]) -> None:
        for s in seq:
            names.update(s.reads() | s.writes())
            if s.guard:
                names.add(s.guard)
            if isinstance(s, If):
                visit(s.then_body)
                visit(s.else_body)
            elif isinstance(s, Loop):
                names.add(s.item_var)
                names.add(s.iter_var)
                visit(s.body)
            elif isinstance(s, _ProducerConsumer):
                names.update(s.split_vars)
                names.update((s.table_var, s.record_var))
                visit([s.producer])
                visit(s.consumer_body)
            elif isinstance(s, Call):
                names.update(s.args)
                if id(s.proc) not in seen_procs:
                    seen_procs.add(id(s.proc))
                    names.update(s.proc.formals)
                    visit(s.proc.body)

    visit(stmts)
    names.discard(None)  # unguarded / targetless statements
    return names


class _FreshNames:
    """Fresh-name allocator seeded with every name the given body mentions
    plus an explicit ``reserved`` set.

    The ``reserved`` parameter exists because seeding from one loop body is
    not enough: Rule A's generated names (``handle_N``, ``cv_N``, …) land in
    the shared environment at run time, so they must avoid collision with
    *program-wide* names, not just the body being fissioned — a program
    using ``handle_0`` outside the loop would otherwise be silently
    clobbered (a real miscompile the differential harness pinned down).
    Whole-program callers pass :func:`collect_names` of the full program.
    """

    def __init__(self, body: Sequence[Stmt], reserved: Sequence[str] = ()):
        self._used = set(reserved)
        self._used |= collect_names(body)
        self._n = 0

    def __call__(self, prefix: str) -> str:
        while True:
            name = f"{prefix}_{self._n}"
            self._n += 1
            if name not in self._used:
                self._used.add(name)
                return name


# ---------------------------------------------------------------------------
# Statement reordering ([4]) — enable Rule A when LC flow deps cross the split
# ---------------------------------------------------------------------------


class FissionError(ValueError):
    """Raised when the Rule A preconditions cannot be satisfied."""


def _find_query(body: Sequence[Stmt]) -> Optional[int]:
    for i, s in enumerate(body):
        if isinstance(s, Query):
            return i
    return None


def reorder_for_fission(body: Sequence[Stmt], qi: int) -> tuple[list[Stmt], int]:
    """Reorder loop-body statements so Rule A applies at the query ``qi``.

    The paper's sufficient condition ([4]): the query must not lie on a
    true-dependence (flow) cycle in the DDG.  We compute, over *flow* edges
    only (intra + loop-carried), the set of statements transitively required
    to produce the query's inputs (``pre``) and schedule them (in original
    order) before the query; all other statements go after it.  The schedule
    is then checked: it must respect every *intra-iteration* dependence
    (flow, anti and output); if not, fission is impossible by reordering.

    Returns the reordered body and the new query index.
    """
    ddg = build_ddg(body, loop_body=True)
    n = len(body)

    # Transitive predecessors of the query over flow edges (both intra and
    # loop-carried): these statements feed the query's parameters, possibly
    # through values carried around the loop, so they must stay on the
    # producer side.
    flow_preds: dict[int, set[int]] = {i: set() for i in range(n)}
    for e in ddg.edges:
        if e.kind.flow:
            flow_preds[e.dst].add(e.src)
    pre: set[int] = set()
    stack = [qi]
    while stack:
        cur = stack.pop()
        for p in flow_preds[cur]:
            if p != qi and p not in pre:
                pre.add(p)
                stack.append(p)
    if qi in pre or any(
        e.src == qi and e.dst == qi and e.kind.flow for e in ddg.edges
    ):
        raise FissionError(
            "query lies on a true-dependence cycle (its inputs depend on its "
            "own result); Rule A is inapplicable (paper §4.1)"
        )

    order = [i for i in range(n) if i in pre] + [qi] + [
        i for i in range(n) if i not in pre and i != qi
    ]

    # Validate: the new order must respect all intra-iteration dependencies.
    pos = {old: new for new, old in enumerate(order)}
    for e in ddg.intra_edges():
        if pos[e.src] > pos[e.dst]:
            raise FissionError(
                f"reordering would violate intra-iteration dependence {e!r}"
            )
    new_body = [body[i] for i in order]
    return new_body, pos[qi]


# ---------------------------------------------------------------------------
# Rule A (§3.2): loop fission
# ---------------------------------------------------------------------------


def _check_rule_a_preconditions(body: Sequence[Stmt], qi: int) -> None:
    """Rule A preconditions (the paper's relaxed form):

    (a) no loop-carried *flow* dependencies (external or otherwise) cross the
        split points before/after the query statement ``s``;
    (b) no loop-carried *external* anti or output dependencies cross them.

    "Crossing" means: the edge connects a statement in ``ss2`` (after s) to a
    statement in ``ss1 ∪ {s}`` (at or before s) in a later iteration —
    i.e. src ∈ after-side, dst ∈ before-side.  (Plain loop-carried anti /
    output deps on program variables are *allowed* to cross — that is the
    paper's improvement over [1]; the loop context table renames them away.)

    A third check guards the context-table capture itself:

    (c) a split variable written by the consumer side must have at least one
        *unconditional* producer-side write.  The table captures split
        variables unconditionally after each producer iteration; when every
        producer write of ``v`` is guarded and the guard is off for
        iteration ``i``, the captured value is whatever the producer phase
        last left in ``v`` — NOT the consumer's iteration ``i-1`` write that
        the synchronous program would observe.  (Found by the differential
        harness; see test_hir_rules.py's minimized regression.)
    """
    ddg = build_ddg(body, loop_body=True)
    before = set(range(qi + 1))  # ss1 ∪ {s}
    after = set(range(qi + 1, len(body)))  # ss2

    for e in ddg.loop_carried_edges():
        crosses = e.src in after and e.dst in before
        if not crosses:
            continue
        if e.kind.flow:
            raise FissionError(
                f"loop-carried flow dependence crosses the split: {e!r} "
                f"(precondition (a) of Rule A)"
            )
        if e.kind.external:
            raise FissionError(
                f"loop-carried external {e.kind.value} dependence crosses the "
                f"split: {e!r} (precondition (b) of Rule A)"
            )

    after_writes: set[str] = set()
    for i in after:
        after_writes |= body[i].writes()
    for v in sorted(set(_split_variables(body, qi)) & after_writes):
        writers = [body[i] for i in before if v in body[i].writes()]
        if writers and all(s.guard is not None for s in writers):
            raise FissionError(
                f"split variable {v!r} is written only conditionally by the "
                f"producer side but rewritten by the consumer side — the "
                f"unconditional context-table restore would clobber the "
                f"consumer's previous-iteration value (precondition (c))"
            )


def _split_variables(body: Sequence[Stmt], qi: int) -> tuple[str, ...]:
    """SV of Rule A: variables with an LCAD or LCOD edge crossing the split
    boundary, i.e. read/written on the consumer side while (re)written on the
    producer side in a later iteration — they must be captured per-iteration
    in the loop context table.

    We compute them directly: any variable that the consumer side (ss2)
    reads, and that the producer side (ss1 ∪ s) writes, must be captured
    (the producer of a *later* iteration would otherwise clobber the value
    the consumer of an *earlier* iteration needs — exactly the LCAD case).
    Variables the consumer both writes before reading are still captured
    when a producer write may reach a consumer read.  Capture happens after
    the producer's write of the same iteration and restore is unconditional,
    which is equivalent as long as precondition (c) of
    :func:`_check_rule_a_preconditions` holds (some producer-side write of
    the variable is unconditional whenever the consumer side rewrites it).

    The query statement itself is *excluded* from the producer-side write
    set: its target is written by the consumer's ``_Fetch``, never by the
    producer (the submit writes the handle), so capturing it would snapshot
    a stale pre-loop value — and the unconditional restore would clobber
    the loop-carried previous-iteration value the consumer relies on when
    the query is guarded and the guard is false (fuzz-found miscompile).
    The query's guard variable is added back by :func:`apply_rule_a`.
    """
    before = list(body[:qi])
    after = list(body[qi + 1 :])
    written_before: set[str] = set()
    for s in before:
        written_before |= s.writes()
        # Loop item var and guards of queries also flow through records.
        written_before |= {g for g in [s.guard] if g}
    read_after: set[str] = set()
    for s in after:
        read_after |= s.reads()
    return tuple(sorted((written_before & read_after)))


def apply_rule_a(
    loop: Loop,
    *,
    overlap: bool = False,
    reorder: bool = True,
    reserved: Sequence[str] = (),
) -> _ProducerConsumer:
    """Split ``loop`` at its first Query statement (paper Rule A).

    ``overlap=True`` produces the §5.1 variant (producer in its own thread,
    blocking-queue context table).  ``reorder=True`` first applies the
    statement-reordering algorithm when the preconditions fail.
    ``reserved`` names are kept out of the generated fresh variables
    (``handle_N``, ``cv_N``, …); whole-program callers pass every name the
    surrounding program uses so the handle variable cannot clobber a program
    variable outside this loop.
    """
    body = apply_rule_b(loop.body, reserved=reserved)
    qi = _find_query(body)
    if qi is None:
        raise FissionError("loop contains no query execution statement")

    try:
        _check_rule_a_preconditions(body, qi)
    except FissionError:
        if not reorder:
            raise
        body, qi = reorder_for_fission(body, qi)
        _check_rule_a_preconditions(body, qi)

    q = body[qi]
    assert isinstance(q, Query)
    if q.updates_db:
        raise FissionError(
            "data-modifying query cannot be submitted asynchronously under "
            "the conservative external-dependence model (paper §8)"
        )

    fresh = _FreshNames(body, reserved=reserved)
    table_var = fresh("t")
    record_var = fresh("r")
    handle_attr = fresh("handle")
    sv = _split_variables(body, qi)

    # Producer body: ss1' = ss1 with capture of split variables, then
    # r.handle = submitQuery(q).
    producer_body: list[Stmt] = list(body[:qi])
    submit = _Submit(
        target=handle_attr,
        query_name=q.query_name,
        params=q.params,
    )
    if q.guard is not None:
        submit = submit.with_guard(q.guard, q.guard_negated)
    producer_body.append(submit)

    producer = Loop(
        item_var=loop.item_var,
        iter_var=loop.iter_var,
        body=producer_body,
    )

    # Consumer body: ss_r (restore) is handled by the interpreter (it binds
    # the record's captured variables into the environment); then
    # v = fetchResult(handle); ss2.
    fetch = _Fetch(target=q.target, handle=handle_attr)
    if q.guard is not None:
        fetch = fetch.with_guard(q.guard, q.guard_negated)
    consumer_body: list[Stmt] = [fetch] + list(body[qi + 1 :])

    split_vars = tuple(
        sorted(set(sv) | {loop.item_var} | ({q.guard} if q.guard else set()))
    )

    return _ProducerConsumer(
        producer=producer,
        consumer_body=consumer_body,
        table_var=table_var,
        record_var=record_var,
        split_vars=split_vars,
        overlap=overlap,
    )


def fission_loop(loop: Loop, **kw) -> Stmt:
    """Public alias of :func:`apply_rule_a`."""
    return apply_rule_a(loop, **kw)


# ---------------------------------------------------------------------------
# Procedure inlining (Guravannavar thesis: inline-then-fission)
# ---------------------------------------------------------------------------


def _proc_has_query(proc: Proc, _seen: Optional[set[int]] = None) -> bool:
    """Whether the procedure (transitively) executes any query."""
    seen = _seen if _seen is not None else set()
    if id(proc) in seen:
        return False
    seen.add(id(proc))

    def visit(stmts: Sequence[Stmt]) -> bool:
        for s in stmts:
            if isinstance(s, (Query, _Submit)):
                return True
            if isinstance(s, If) and (visit(s.then_body) or visit(s.else_body)):
                return True
            if isinstance(s, Loop) and visit(s.body):
                return True
            if isinstance(s, Call) and _proc_has_query(s.proc, seen):
                return True
        return False

    return visit(proc.body)


def _proc_local_names(proc: Proc) -> set[str]:
    """Names bound inside the procedure's scope: formals, every write
    target, and loop binders — exactly the names :func:`inline_call` must
    rename to keep the inlined body out of the caller's namespace."""
    local = set(proc.formals)

    def visit(stmts: Sequence[Stmt]) -> None:
        for s in stmts:
            local.update(s.writes())
            if isinstance(s, If):
                visit(s.then_body)
                visit(s.else_body)
            elif isinstance(s, Loop):
                local.add(s.item_var)
                visit(s.body)

    visit(proc.body)
    return local


def can_inline(proc: Proc) -> tuple[bool, str]:
    """§6.2-style applicability check for inline-then-fission.

    Refuses (with a reason) when inlining would be unsound or undefined:

    * **recursion** — a procedure (transitively) calling itself cannot be
      inlined by substitution;
    * **free variables** — a body read that is neither a formal nor a
      procedure-local write has no value in the callee scope (the program
      is invalid; refusing keeps the transformer from "fixing" it by
      capturing caller state the synchronous semantics never read);
    * **undefined result** — ``result`` must be a formal or a body write.
    """
    # Recursion: can `proc` reach itself over the static call graph?
    def callees(p: Proc) -> list[Proc]:
        found: list[Proc] = []

        def walk(stmts: Sequence[Stmt]) -> None:
            for s in stmts:
                if isinstance(s, Call):
                    found.append(s.proc)
                elif isinstance(s, If):
                    walk(s.then_body)
                    walk(s.else_body)
                elif isinstance(s, Loop):
                    walk(s.body)

        walk(p.body)
        return found

    stack, seen = [proc], set()
    while stack:
        p = stack.pop()
        if id(p) in seen:
            continue
        seen.add(id(p))
        for callee in callees(p):
            if callee is proc:
                return False, (
                    f"procedure {proc.name!r} is (transitively) recursive"
                )
            stack.append(callee)

    local = _proc_local_names(proc)
    free: set[str] = set()
    for s in proc.body:
        free |= s.reads()
    free -= local
    if free:
        return False, (
            f"procedure {proc.name!r} reads undefined (free) variables "
            f"{sorted(free)} — callee scopes are isolated"
        )
    if proc.result is not None and proc.result not in local:
        return False, (
            f"procedure {proc.name!r} result {proc.result!r} is never bound"
        )
    return True, ""


def _rename_stmt(s: Stmt, ren: Mapping[str, str]) -> Stmt:
    """Alpha-rename one statement (recursively) under ``ren``; names not in
    the map — including ``Assign.effect`` resource names — pass through."""

    def r(name: Optional[str]) -> Optional[str]:
        return ren.get(name, name) if name is not None else None

    t = dataclasses.replace(s)
    t.guard = r(s.guard)
    if isinstance(t, Assign):
        t.target = r(t.target)
        t.args = tuple(r(a) for a in t.args)
    elif isinstance(t, (Query, _Submit)):
        t.target = r(t.target)
        t.params = tuple(r(p) for p in t.params)
    elif isinstance(t, _Fetch):
        t.target = r(t.target)
        t.handle = r(t.handle)
    elif isinstance(t, If):
        t.pred = r(t.pred)
        t.then_body = [_rename_stmt(b, ren) for b in s.then_body]
        t.else_body = [_rename_stmt(b, ren) for b in s.else_body]
    elif isinstance(t, Loop):
        t.item_var = r(t.item_var)
        t.iter_var = r(t.iter_var)
        t.body = [_rename_stmt(b, ren) for b in s.body]
    elif isinstance(t, Call):
        t.target = r(t.target)
        t.args = tuple(r(a) for a in t.args)
        # the callee's own scope is untouched: its locals are not ours
    else:
        raise TypeError(f"cannot rename statement {type(s)}")
    return t


def _identity(v: Any) -> Any:
    return v


def _negate(v: Any) -> bool:
    return not bool(v)


def inline_call(call: Call, fresh: _FreshNames) -> list[Stmt]:
    """Substitute a :class:`Call` with its procedure body (thesis
    inline-then-fission, step 1).

    Every callee-scope name is alpha-renamed to a fresh caller name
    (``<proc>_<var>_N``), formals become explicit copy assignments from the
    caller's argument variables, and ``target = result`` closes the call.  A
    guarded call wraps the whole expansion in an ``If`` on the (possibly
    freshly negated) guard so Rule B can later flatten it — callee
    statements keep their own inner guards, and nested guards are illegal.

    Callers must have verified :func:`can_inline` first.
    """
    proc = call.proc
    ren = {
        v: fresh(f"{proc.name}_{v}")
        for v in sorted(_proc_local_names(proc))
    }
    stmts: list[Stmt] = []
    for formal, arg in zip(proc.formals, call.args):
        stmts.append(
            Assign(target=ren[formal], fn=_identity, args=(arg,))
        )
    stmts.extend(_rename_stmt(s, ren) for s in proc.body)
    if call.target is not None and proc.result is not None:
        stmts.append(
            Assign(target=call.target, fn=_identity, args=(ren[proc.result],))
        )
    if call.guard is None:
        return stmts
    pred = call.guard
    out: list[Stmt] = []
    if call.guard_negated:
        pred = fresh("cv")
        out.append(Assign(target=pred, fn=_negate, args=(call.guard,)))
    out.append(If(pred=pred, then_body=stmts))
    return out


def transform_program(
    prog: Program,
    *,
    overlap: bool = False,
    max_depth: int = 8,
    sites: Optional[Sequence[int]] = None,
) -> Program:
    """Transform every fissionable loop in ``prog`` (nested loops §3.4:
    innermost-first, then the outer loop sees the fissioned inner statement
    as an opaque external-reading statement and may itself be fissioned when
    preconditions hold — matching the paper's nested-table construction
    conceptually, executed here via the runtime queue which is shared).
    Loops whose preconditions fail are left untouched (rule application can
    stop at any point — §3).

    Query-bearing :class:`Call` statements are inlined first (thesis
    inline-then-fission) when :func:`can_inline` approves, so Rule A/B and
    reordering apply across procedure boundaries; unsafe inlines (recursion,
    free variables) leave the call in place.

    ``sites`` optionally restricts Rule A to a subset of loop sites, named
    by their preorder index over the post-inline traversal (the numbering
    :func:`enumerate_fission_sites` reports) — the handle the synthesis
    search in :mod:`repro.core.equivalence` uses to enumerate *which*
    queries to asynchronize.
    """
    return _transform(prog, overlap=overlap, max_depth=max_depth, sites=sites)


def _transform(
    prog: Program,
    *,
    overlap: bool = False,
    max_depth: int = 8,
    sites: Optional[Sequence[int]] = None,
    report: Optional[list] = None,
) -> Program:
    """Shared engine behind :func:`transform_program` and
    :func:`enumerate_fission_sites`: one deterministic traversal that
    numbers loop sites in preorder (post-inline), optionally restricted to
    ``sites``, optionally appending ``(site, fissioned, reason)`` triples
    to ``report``."""
    fresh = _FreshNames(prog.body, reserved=prog.inputs)
    allowed = None if sites is None else set(sites)
    counter = itertools.count()

    def rewrite(stmts: list[Stmt], depth: int) -> list[Stmt]:
        out: list[Stmt] = []
        for s in stmts:
            if (
                isinstance(s, Call)
                and depth < max_depth
                and _proc_has_query(s.proc)
                and can_inline(s.proc)[0]
            ):
                out.extend(rewrite(inline_call(s, fresh), depth + 1))
                continue
            if isinstance(s, Loop) and depth < max_depth:
                site = next(counter)
                s = dataclasses.replace(s, body=rewrite(s.body, depth + 1))
                if allowed is None or site in allowed:
                    try:
                        out.append(
                            apply_rule_a(
                                s, overlap=overlap,
                                reserved=frozenset(fresh._used),
                            )
                        )
                        if report is not None:
                            report.append((site, True, ""))
                        continue
                    except FissionError as e:
                        if report is not None:
                            report.append((site, False, str(e)))
            if isinstance(s, If):
                s = dataclasses.replace(
                    s,
                    then_body=rewrite(s.then_body, depth),
                    else_body=rewrite(s.else_body, depth),
                )
            out.append(s)
        return out

    return Program(body=rewrite(list(prog.body), 0), inputs=prog.inputs)


def enumerate_fission_sites(
    prog: Program, *, overlap: bool = False, max_depth: int = 8
) -> list[tuple[int, bool, str]]:
    """Attempt Rule A at every loop site of the (inlined) program; return
    ``(site_index, fissioned, reason)`` per site in the same deterministic
    preorder numbering ``transform_program(sites=...)`` accepts.  The
    synthesis-lite search enumerates subsets of the fissioned sites and
    re-checks equivalence per candidate."""
    report: list[tuple[int, bool, str]] = []
    _transform(prog, overlap=overlap, max_depth=max_depth, report=report)
    return report


# ---------------------------------------------------------------------------
# Applicability analysis (§6.2, Table 1)
# ---------------------------------------------------------------------------


def analyze_applicability(prog: Program) -> dict[str, Any]:
    """Count query-in-loop opportunities and how many Rule A (with Rule B +
    reordering + procedure inlining) can transform — the paper's Table 1.

    The analysis runs over the *inlined* program so opportunities inside
    procedures called from loops are visited exactly as
    :func:`transform_program` would see them; query-bearing calls whose
    inline is refused (recursion, free variables) are reported in
    ``failures`` and their internal opportunities are not counted — the
    transformer will not enter them either, so the counts and the rewrite
    agree."""
    opportunities = 0
    transformed = 0
    failures: list[str] = []

    fresh = _FreshNames(prog.body, reserved=prog.inputs)

    def inline_visible(stmts: Sequence[Stmt], depth: int = 0) -> list[Stmt]:
        out: list[Stmt] = []
        for s in stmts:
            if (
                isinstance(s, Call)
                and depth < 8
                and _proc_has_query(s.proc)
            ):
                ok, reason = can_inline(s.proc)
                if ok:
                    out.extend(inline_call(s, fresh))
                    continue
                failures.append(f"inline refused: {reason}")
            out.append(s)
        return out

    def visit(stmts: Sequence[Stmt], depth: int = 0):
        nonlocal opportunities, transformed
        for s in inline_visible(stmts, depth):
            if isinstance(s, Loop):
                body = inline_visible(s.body, depth + 1)
                s = dataclasses.replace(s, body=body)
                flat = apply_rule_b(body)
                n_queries = sum(1 for t in flat if isinstance(t, Query))
                opportunities += n_queries
                probe = s
                for _ in range(n_queries):
                    try:
                        pc = apply_rule_a(probe)
                        transformed += 1
                        # Remaining queries live in the consumer; probe again.
                        probe = Loop(
                            item_var=pc.record_var,
                            iter_var=pc.table_var,
                            body=pc.consumer_body[1:],
                        )
                    except FissionError as e:
                        failures.append(str(e))
                        break
                visit(body, depth + 1)
            elif isinstance(s, If):
                visit(s.then_body, depth)
                visit(s.else_body, depth)

    visit(prog.body)
    pct = 100.0 * transformed / opportunities if opportunities else 100.0
    return {
        "opportunities": opportunities,
        "transformed": transformed,
        "applicability_pct": pct,
        "failures": failures,
    }


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------


class Interpreter:
    """Executes HIR programs against a query service.

    ``service`` must provide ``execute(query_name, params) -> result``.  For
    transformed programs it must additionally provide the asynchronous API
    ``submit(query_name, params) -> handle`` and ``fetch(handle) -> result``
    (see :class:`repro.core.runtime.AsyncQueryRuntime`).  The untransformed
    and transformed programs then execute observably identically — the
    property our tests check.
    """

    def __init__(self, service, outputs: Optional[Callable[[Any], None]] = None):
        self.service = service
        self.emitted: list[Any] = []  # ordered observable outputs (print/log)
        # Optional output sink: called with each (effect, value) pair as it
        # is emitted, alongside the `emitted` log — a streaming consumer
        # (print, logger, socket) sees outputs in program order without
        # waiting for run() to return.
        self.outputs = outputs

    # -- public --------------------------------------------------------------
    def run(self, prog: Program, inputs: Mapping[str, Any]) -> dict[str, Any]:
        env = dict(inputs)
        self._exec_block(prog.body, env)
        return env

    # -- internals -----------------------------------------------------------
    def _guard_ok(self, s: Stmt, env: dict) -> bool:
        if s.guard is None:
            return True
        v = bool(env[s.guard])
        return (not v) if s.guard_negated else v

    def _exec_block(self, stmts: Sequence[Stmt], env: dict) -> None:
        for s in stmts:
            self._exec(s, env)

    def _exec(self, s: Stmt, env: dict) -> None:
        if not self._guard_ok(s, env):
            return
        if isinstance(s, Assign):
            val = s.fn(*[env[a] for a in s.args])
            if s.effect is not None:
                self.emitted.append((s.effect, val))
                if self.outputs is not None:
                    self.outputs((s.effect, val))
            if s.target is not None:
                env[s.target] = val
        elif isinstance(s, Query):
            env[s.target] = self.service.execute(s.query_name, tuple(env[p] for p in s.params))
        elif isinstance(s, _Submit):
            env[s.target] = self.service.submit(s.query_name, tuple(env[p] for p in s.params))
        elif isinstance(s, _Fetch):
            env[s.target] = self.service.fetch(env[s.handle])
        elif isinstance(s, If):
            branch = s.then_body if bool(env[s.pred]) else s.else_body
            self._exec_block(branch, env)
        elif isinstance(s, Loop):
            for item in list(env[s.iter_var]):
                env[s.item_var] = item
                self._exec_block(s.body, env)
        elif isinstance(s, Call):
            # Callee scopes are isolated: the local environment holds ONLY
            # the formals (bound to the caller's argument values); a body
            # read of anything else is a KeyError in the callee, same as in
            # the inlined form where the free variable was never assigned.
            local = {
                f: env[a] for f, a in zip(s.proc.formals, s.args)
            }
            self._exec_block(s.proc.body, local)
            if s.target is not None:
                env[s.target] = (
                    local[s.proc.result] if s.proc.result is not None else None
                )
        elif isinstance(s, _ProducerConsumer):
            self._exec_fissioned(s, env)
        else:
            raise TypeError(f"unknown statement {type(s)}")

    def _exec_fissioned(self, s: _ProducerConsumer, env: dict) -> None:
        from repro_torch.core.loop_context import LoopContextTable

        table = LoopContextTable(blocking=s.overlap)

        # In overlap mode (§5.1) the producer runs in its own thread over a
        # *snapshot* of the environment: by Rule A's preconditions there are
        # no dependences between producer and consumer other than through the
        # loop context table, so the snapshot is safe; it prevents the
        # low-level race of both threads mutating one dict entry (the paper's
        # Java tool gets this for free from per-iteration locals).
        penv = dict(env) if s.overlap else env

        # A producer exception must not strand the consumer: the table is
        # closed in a `finally` (the consumer's `for record in table:` would
        # otherwise block forever on the overlap path) and the exception is
        # captured and re-raised on the caller's thread after join — the
        # §5.1 thread must neither swallow errors nor hang the program.
        producer_error: list[BaseException] = []

        def produce():
            try:
                for item in list(penv[s.producer.iter_var]):
                    penv[s.producer.item_var] = item
                    self._exec_block(s.producer.body, penv)
                    record = {v: penv[v] for v in s.split_vars if v in penv}
                    # the submit handle:
                    for st in s.producer.body:
                        if isinstance(st, _Submit):
                            if self._guard_ok(st, penv):
                                record[st.target] = penv[st.target]
                            else:
                                record[st.target] = None
                    table.put(record)
            except BaseException as e:  # noqa: BLE001 — re-raised after join
                producer_error.append(e)
                return
            finally:
                table.close()
            # The producer loop has submitted everything: strategies that
            # wait for the full request set (PureBatch) may now fire.
            done_hook = getattr(self.service, "producer_done", None)
            if done_hook is not None:
                done_hook()

        if s.overlap:
            import threading

            th = threading.Thread(target=produce, name="hir-producer")
            th.start()
        else:
            produce()
            if producer_error:
                raise producer_error[0]

        for record in table:
            env.update(record)
            self._exec_block(s.consumer_body, env)

        if s.overlap:
            th.join()
            if producer_error:
                raise producer_error[0]
            # Merge back producer-only writes (vars the consumer neither
            # restores nor writes), preserving the original program's final
            # values: per body order, a consumer write supersedes the
            # producer's, otherwise the producer's final value stands.
            consumer_writes: set[str] = set()
            for st in s.consumer_body:
                consumer_writes |= st.writes()
            producer_writes = s.producer.writes() | {s.producer.item_var}
            for v in producer_writes - consumer_writes - set(s.split_vars):
                if v in penv:
                    env[v] = penv[v]
