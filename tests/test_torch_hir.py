"""The port's HIR transformation layer against the JAX package's.

``repro_torch.core.hir`` (Rule A loop fission, Rule B predication,
statement reordering, procedure inlining, the ``Interpreter``) and the
differential harness ``core/equivalence.py`` are copies of the reference
modules; these tests hold them to the reference's results on the same
programs:

* programs from the reference's generator (``tests/hir_strategies.py``),
  translated into the port's classes by class name and fields, for 40
  seeds: ``check_program``, ``transform_program`` (two-phase and overlap),
  ``analyze_applicability`` and ``count_fissioned`` must agree on every
  result — observables, emissions, round trips, fission counts and the
  transformed program, compared as a deep dump of the statement tree;
* twins of ``tests/test_hir_rules.py``'s Rule A and Rule B cases, each
  program built once with each package's own classes and run through
  both, synchronous = transformed within each package and equal results
  across them.

Every service has zero latency and no assertion reads a clock.
"""
from __future__ import annotations

import dataclasses
import enum
import random
import sys
import types

import pytest

import repro.core.equivalence as j_equivalence
import repro.core.hir as j_hir
import repro.core.runtime as j_runtime
import repro.core.services as j_services
import repro.core.strategies as j_strategies
import repro_torch.core.equivalence as t_equivalence
import repro_torch.core.hir as t_hir
import repro_torch.core.runtime as t_runtime
import repro_torch.core.services as t_services
import repro_torch.core.strategies as t_strategies
from hir_strategies import gen_program

JAX = types.SimpleNamespace(name="repro", H=j_hir, E=j_equivalence, R=j_runtime,
                            S=j_services, ST=j_strategies)
PORT = types.SimpleNamespace(name="repro_torch", H=t_hir, E=t_equivalence, R=t_runtime,
                             S=t_services, ST=t_strategies)
PKGS = (JAX, PORT)

TABLES = {"part": {i: i * 10 + 1 for i in range(1000)}}
SEEDS = range(40)


def add(a, b):
    return a + b


# ------------------------------------------------------------- translation
def translate(obj, H, memo=None):
    """The same program in ``H``'s classes: every dataclass is rebuilt as
    the class of the same name in ``H``, field by field.  Objects are
    memoized by ``id`` so that a ``Proc`` named by several ``Call``s (or by
    a call in its own body) stays one object."""
    memo = {} if memo is None else memo
    if isinstance(obj, list):
        return [translate(x, H, memo) for x in obj]
    if isinstance(obj, tuple):
        return tuple(translate(x, H, memo) for x in obj)
    if isinstance(obj, enum.Enum):
        return getattr(H, type(obj).__name__)[obj.name]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if id(obj) in memo:
            return memo[id(obj)]
        cls = getattr(H, type(obj).__name__)
        new = cls.__new__(cls)
        memo[id(obj)] = new
        for f in dataclasses.fields(obj):
            setattr(new, f.name, translate(getattr(obj, f.name), H, memo))
        return new
    return obj


def dump(obj, seen=None) -> str:
    """A deep, package-independent rendering of a statement tree: class
    names, every field, functions by name, a ``Proc`` expanded once."""
    seen = set() if seen is None else seen
    if isinstance(obj, (list, tuple)):
        inner = ", ".join(dump(x, seen) for x in obj)
        return f"[{inner}]" if isinstance(obj, list) else f"({inner})"
    if isinstance(obj, enum.Enum):
        return f"{type(obj).__name__}.{obj.name}"
    if callable(obj) and not dataclasses.is_dataclass(obj):
        return f"<fn {getattr(obj, '__name__', '?')}>"
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if type(obj).__name__ == "Proc":
            if id(obj) in seen:
                return f"<proc {obj.name}>"
            seen.add(id(obj))
        fields = ", ".join(f"{f.name}={dump(getattr(obj, f.name), seen)}"
                           for f in dataclasses.fields(obj))
        return f"{type(obj).__name__}({fields})"
    return repr(obj)


def test_translate_rebuilds_every_class_in_the_port():
    gp = gen_program(random.Random(3))
    prog = translate(gp.program, t_hir)

    def classes(obj, out):
        if isinstance(obj, (list, tuple)):
            for x in obj:
                classes(x, out)
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            if id(obj) not in out:
                out[id(obj)] = type(obj)
                for f in dataclasses.fields(obj):
                    classes(getattr(obj, f.name), out)
        return out

    mods = {c.__module__ for c in classes(prog, {}).values()}
    assert mods == {"repro_torch.core.hir"}
    assert dump(prog) == dump(gp.program)


# ------------------------------------------------------ generated programs
def _run_sides(P, prog, inputs, observe, overlap):
    """Synchronous oracle and transformed program (``PureBatch``: one
    deterministic batch per fissioned loop), each on its own zero-latency
    service; observables, emissions and service counters of both."""
    svc = P.E.make_service()
    sync = P.H.Interpreter(svc)
    env_s = sync.run(prog, dict(inputs))
    svc_a = P.E.make_service()
    rt = P.R.AsyncQueryRuntime(svc_a, n_threads=4, strategy=P.ST.PureBatch())
    async_ = P.H.Interpreter(rt)
    try:
        env_a = async_.run(P.H.transform_program(prog, overlap=overlap), dict(inputs))
    finally:
        rt.drain()
        rt.shutdown()
    stats = {k: v for k, v in svc_a.stats.snapshot().items() if k != "busy_time"}
    return ({k: env_s.get(k, "<unset>") for k in observe}, sync.emitted,
            {k: env_a.get(k, "<unset>") for k in observe}, async_.emitted,
            int(svc.stats.round_trips), stats)


def _results(P, prog, gp, overlap):
    res = P.E.check_program(prog, gp.inputs, gp.observe, overlap=overlap)
    t2 = P.H.transform_program(prog)
    t_ov = P.H.transform_program(prog, overlap=True)
    return dict(
        trial=(res.equivalent, res.fissioned, res.approved, res.sync_round_trips,
               res.async_round_trips, res.round_trip_win, res.mismatches),
        violations=res.violations(),
        applicability=P.H.analyze_applicability(prog),
        fissioned=(P.E.count_fissioned(t2.body), P.E.count_fissioned(t_ov.body)),
        repr=(repr(t2), repr(t_ov)),
        dump=(dump(t2.body), dump(t_ov.body)),
        sites=[(s, ok) for s, ok, _ in P.H.enumerate_fission_sites(prog)],
        sides=_run_sides(P, prog, gp.inputs, gp.observe, overlap),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_generated_program_agrees_with_reference(seed):
    gp = gen_program(random.Random(seed))
    overlap = seed % 3 == 2
    want = _results(JAX, gp.program, gp, overlap)
    got = _results(PORT, translate(gp.program, t_hir), gp, overlap)
    assert got == want
    assert not got["violations"], got["violations"]
    env_s, em_s, env_a, em_a, _, _ = got["sides"]
    assert env_s == env_a and em_s == em_a


def test_generated_corpus_fissions_and_saves_round_trips():
    """The corpus is not vacuous: some programs fission and win."""
    wins = fissioned = 0
    for seed in SEEDS:
        gp = gen_program(random.Random(seed))
        res = t_equivalence.check_program(translate(gp.program, t_hir), gp.inputs,
                                          gp.observe)
        fissioned += res.fissioned > 0
        wins += res.round_trip_win
    assert fissioned >= 10 and wins >= 10, (fissioned, wins)


@pytest.mark.parametrize("seed", [0, 1])
def test_run_differential_agrees_with_reference(seed, monkeypatch):
    """The harness's own loop (chaos every 5th trial, overlap every 3rd)
    finds no violation in either package, on the same corpus counts.  The
    port's loop imports the generator by module name, so it is handed one
    that translates each program into the port's classes."""
    import hir_strategies

    want = j_equivalence.run_differential(seed=seed, n_programs=10)

    def port_gen(rng, **kw):
        gp = gen_program(rng, **kw)
        return dataclasses.replace(gp, program=translate(gp.program, t_hir))

    monkeypatch.setitem(sys.modules, "hir_strategies",
                        types.SimpleNamespace(gen_program=port_gen,
                                              GeneratedProgram=hir_strategies.GeneratedProgram))
    got = t_equivalence.run_differential(seed=seed, n_programs=10)
    assert got.ok and want.ok, got.violations
    fields = ("n_programs", "n_fissioned", "n_chaos", "n_overlap", "n_round_trip_wins")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]


# ------------------------------------------------- twins of test_hir_rules
def example2(H):
    """Paper Example 2: query + dependent statement in a loop."""
    return H.Program(inputs=("categories", "sum"), body=[
        H.Loop(item_var="category", iter_var="categories", body=[
            H.Query(target="partCount", query_name="part.lookup", params=("category",)),
            H.Assign(target="sum", fn=add, args=("sum", "partCount")),
        ])]), {"categories": list(range(50)), "sum": 0}


def _mod3(i):
    return i % 3


def _is0(v):
    return v == 0


def example6(H):
    """Paper Example 6: query under an if; Rule B then Rule A."""
    return H.Program(inputs=("items", "acc", "emitted"), body=[
        H.Loop(item_var="i", iter_var="items", body=[
            H.Assign(target="v", fn=_mod3, args=("i",)),
            H.Assign(target="is0", fn=_is0, args=("v",)),
            H.If(pred="is0", then_body=[
                H.Query(target="v", query_name="part.lookup", params=("i",)),
                H.Assign(target="emitted", fn=add, args=("emitted", "v")),
            ]),
            H.Assign(target="acc", fn=add, args=("acc", "v")),
        ])]), {"items": list(range(40)), "acc": 0, "emitted": 0}


def example4(H):
    """Paper Example 4/5: an accumulator written after the query forces
    reordering before fission applies."""
    return H.Program(inputs=("cats", "total", "maxv"), body=[
        H.Loop(item_var="c", iter_var="cats", body=[
            H.Query(target="n", query_name="part.lookup", params=("c",)),
            H.Assign(target="total", fn=add, args=("total", "n")),
            H.Assign(target="maxv", fn=max, args=("maxv", "n")),
        ])]), {"cats": list(range(30)), "total": 0, "maxv": -1}


def _mod100(r):
    return r % 100


def dependence_cycle(H):
    """The query key depends on the previous iteration's result: refused."""
    return H.Program(inputs=("items", "key"), body=[
        H.Loop(item_var="i", iter_var="items", body=[
            H.Query(target="r", query_name="part.lookup", params=("key",)),
            H.Assign(target="key", fn=_mod100, args=("r",)),
        ])]), {"items": list(range(10)), "key": 5}


def _key(i, j):
    return (i * 7 + j) % 1000


def nested_loops(H):
    return H.Program(inputs=("outer", "inner", "total"), body=[
        H.Loop(item_var="i", iter_var="outer", body=[
            H.Loop(item_var="j", iter_var="inner", body=[
                H.Assign(target="k", fn=_key, args=("i", "j")),
                H.Query(target="x", query_name="part.lookup", params=("k",)),
                H.Assign(target="total", fn=add, args=("total", "x")),
            ]),
        ])]), {"outer": list(range(6)), "inner": list(range(5)), "total": 0}


def _plus3(x):
    return (x + 3) % 1000


def two_queries(H):
    return H.Program(inputs=("items", "a", "b"), body=[
        H.Loop(item_var="i", iter_var="items", body=[
            H.Query(target="x", query_name="part.lookup", params=("i",)),
            H.Assign(target="j", fn=_plus3, args=("x",)),
            H.Query(target="y", query_name="part.lookup", params=("j",)),
            H.Assign(target="a", fn=add, args=("a", "x")),
            H.Assign(target="b", fn=add, args=("b", "y")),
        ])]), {"items": list(range(25)), "a": 0, "b": 0}


def _is_even(p):
    return p % 2 == 0


def _next_p(r):
    return (r + 3) % 50


def guard_writes_own_param(H):
    """The guarded block writes the query's own parameter: refused."""
    return H.Program(inputs=("items", "p", "acc"), body=[
        H.Loop(item_var="i", iter_var="items", body=[
            H.Assign(target="g", fn=_is_even, args=("p",)),
            H.If(pred="g", then_body=[
                H.Query(target="r", query_name="part.lookup", params=("p",)),
                H.Assign(target="p", fn=_next_p, args=("r",)),
            ]),
            H.Assign(target="acc", fn=add, args=("acc", "p")),
        ])]), {"items": list(range(10)), "p": 4, "acc": 0}


def _cursor(row):
    return (row + 7) % 900


def nested_cursor(H):
    """An inner query advances the cursor the next inner read uses: refused."""
    return H.Program(inputs=("outer", "inner", "cur", "acc"), body=[
        H.Loop(item_var="i", iter_var="outer", body=[
            H.Loop(item_var="j", iter_var="inner", body=[
                H.Query(target="row", query_name="part.lookup", params=("cur",)),
                H.Assign(target="cur", fn=_cursor, args=("row",)),
            ]),
            H.Assign(target="acc", fn=add, args=("acc", "cur")),
        ])]), {"outer": list(range(4)), "inner": list(range(5)), "cur": 3, "acc": 0}


def _inc(q):
    return q + 1


def guarded_target(H):
    """A guarded query whose target is read under the same guard."""
    return H.Program(inputs=("items", "q", "u"), body=[
        H.Loop(item_var="it", iter_var="items", body=[
            H.Assign(target="g", fn=_is_even, args=("it",)),
            H.Query(target="q", query_name="part.lookup", params=("it",), guard="g"),
            H.Assign(target="u", fn=_inc, args=("q",), guard="g"),
        ])]), {"items": [2, 4, 6, 8, 5], "q": -1, "u": -1}


def _pack(a, b, c):
    return a * 10000 + b * 100 + c


def fresh_names(H):
    """A program that already uses the transformer's name shapes."""
    return H.Program(inputs=("items", "handle_2", "cv_0", "t_0"), body=[
        H.Loop(item_var="i", iter_var="items", body=[
            H.Query(target="q_0", query_name="part.lookup", params=("i",)),
            H.Assign(target="acc", fn=add, args=("q_0", "q_0")),
        ]),
        H.Assign(target="out", fn=_pack, args=("handle_2", "cv_0", "t_0")),
    ]), {"items": list(range(6)), "handle_2": 11, "cv_0": 22, "t_0": 33}


def _ident(it):
    return it


def _precondition_c_body(H):
    return [
        H.Assign(target="g", fn=_is_even, args=("it",)),
        H.Assign(target="acc", fn=_ident, args=("it",), guard="g"),
        H.Query(target="q", query_name="part.lookup", params=("it",)),
        H.Assign(target="acc", fn=add, args=("acc", "q")),
    ]


def precondition_c(H):
    """A conditional producer-side write that reordering rescues."""
    return H.Program(inputs=("items", "acc"), body=[
        H.Loop(item_var="it", iter_var="items", body=_precondition_c_body(H))]), \
        {"items": [2, 1, 4, 7, 8], "acc": 0}


def _neg(i):
    return -i


def _twice(r):
    return r * 2


def guarded_call(H):
    """A guarded Call inlines under an If; Rule B flattens, Rule A fissions."""
    proc = H.Proc(name="look", formals=("k",), body=[
        H.Query(target="r", query_name="part.lookup", params=("k",)),
        H.Assign(target="o", fn=_twice, args=("r",)),
    ], result="o")
    return H.Program(inputs=("items", "acc"), body=[
        H.Loop(item_var="i", iter_var="items", body=[
            H.Assign(target="g", fn=_is_even, args=("i",)),
            H.Assign(target="v", fn=_neg, args=("i",)),
            H.Call(target="v", proc=proc, args=("i",), guard="g", guard_negated=True),
            H.Assign(target="acc", fn=add, args=("acc", "v")),
        ])]), {"items": list(range(12)), "acc": 0}


CASES = {f.__name__: f for f in (
    example2, example6, example4, dependence_cycle, nested_loops, two_queries,
    guard_writes_own_param, nested_cursor, guarded_target, fresh_names, precondition_c,
    guarded_call)}
# (opportunities, transformed) of analyze_applicability, as the reference's tests state
APPLICABILITY = {"example4": (1, 1), "dependence_cycle": (1, 0), "two_queries": (2, 2),
                 "guard_writes_own_param": (None, 0), "nested_cursor": (None, 0)}


def _case_results(P, name, overlap):
    prog, inputs = CASES[name](P.H)
    names = tuple(sorted(P.H.collect_names(prog.body) | set(prog.inputs)))
    base = P.H.Interpreter(P.S.TableService(TABLES)).run(prog, dict(inputs))
    svc = P.S.TableService(TABLES)
    rt = P.R.AsyncQueryRuntime(svc, n_threads=4, strategy=P.ST.PureBatch())
    try:
        out = P.H.Interpreter(rt).run(P.H.transform_program(prog, overlap=overlap),
                                      dict(inputs))
    finally:
        rt.drain()
        rt.shutdown()
    res = P.E.check_program(prog, inputs, overlap=overlap)
    t = P.H.transform_program(prog, overlap=overlap)
    rep = P.H.analyze_applicability(prog)
    return dict(
        sync={k: base.get(k) for k in names}, transformed={k: out.get(k) for k in names},
        stats={k: v for k, v in svc.stats.snapshot().items() if k != "busy_time"},
        trial=(res.equivalent, res.fissioned, res.approved, res.sync_round_trips,
               res.async_round_trips, res.mismatches),
        applicability=rep, repr=repr(t), dump=dump(t.body))


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_case_agrees_with_reference(name, overlap):
    want = _case_results(JAX, name, overlap)
    got = _case_results(PORT, name, overlap)
    assert got == want
    assert got["sync"] == got["transformed"]
    assert got["trial"][0], got["trial"]
    opp, done = APPLICABILITY.get(name, (None, None))
    rep = got["applicability"]
    if opp is not None:
        assert rep["opportunities"] == opp
    if done is not None:
        assert rep["transformed"] == done
    if done == 0:
        assert got["trial"][1] == 0  # nothing fissioned where refused


@pytest.mark.parametrize("strategy", ["PureAsync", "OneOrAll", "LowerThreshold",
                                      "GrowingUpperThreshold"])
def test_example2_every_strategy_matches_reference(strategy):
    """Every batching strategy gives the reference's result (the batches
    they form depend on thread timing, so only results are compared)."""
    kw = {"LowerThreshold": dict(bt=3),
          "GrowingUpperThreshold": dict(initial_upper=4, bt=3)}.get(strategy, {})
    outs = []
    for P in PKGS:
        prog, _ = example2(P.H)
        inputs = {"categories": list(range(60)), "sum": 0}
        base = P.H.Interpreter(P.S.TableService(TABLES)).run(prog, dict(inputs))
        rt = P.R.AsyncQueryRuntime(P.S.TableService(TABLES), n_threads=4,
                                   strategy=getattr(P.ST, strategy)(**kw))
        try:
            out = P.H.Interpreter(rt).run(P.H.transform_program(prog), dict(inputs))
        finally:
            rt.drain()
            rt.shutdown()
        assert base["sum"] == out["sum"]
        outs.append(out["sum"])
    assert outs[0] == outs[1]


def _refusals(P):
    """Rule A's refusals and the helpers' static results, in one package."""
    H = P.H
    out = {}
    prog, _ = dependence_cycle(H)
    updates = H.Loop(item_var="i", iter_var="items", body=[
        H.Query(target="r", query_name="part.lookup", params=("i",), updates_db=True)])
    cond = H.Loop(item_var="it", iter_var="items", body=_precondition_c_body(H))
    for label, loop, kw in (("cycle", prog.body[0], {}), ("updates_db", updates, {}),
                            ("precondition_c", cond, dict(reorder=False))):
        with pytest.raises(H.FissionError) as e:
            H.apply_rule_a(loop, **kw)
        out[label] = str(e.value)
    ddg = H.build_ddg(example2(H)[0].body[0].body, loop_body=True)
    out["ddg"] = sorted((e.src, e.dst, e.kind.value, sorted(e.vars) if hasattr(e, "vars")
                         else None) for e in ddg.edges)
    flat = H.apply_rule_b([H.If(pred="p", then_body=[H.Assign(target="x", fn=_zero,
                                                              args=())],
                                else_body=[H.Assign(target="x", fn=_zero, args=())])])
    out["rule_b"] = (len(flat), [repr(s) for s in flat], flat[1].guard is not None,
                     flat[2].guard_negated)
    rec = H.Proc(name="rec", formals=("n",), body=[
        H.Query(target="r", query_name="part.lookup", params=("n",))], result="r")
    rec.body.append(H.Call(target=None, proc=rec, args=("n",)))
    free = H.Proc(name="leaky", formals=("a",),
                  body=[H.Assign(target="x", fn=add, args=("a", "outside"))], result="x")
    unbound = H.Proc(name="nores", formals=("a",),
                     body=[H.Assign(target="x", fn=_ident, args=("a",))], result="y")
    out["can_inline"] = [H.can_inline(p) for p in (rec, free, unbound)]
    loop_prog = H.Program(inputs=("items",), body=[
        H.Loop(item_var="i", iter_var="items", body=[
            H.Call(target="v", proc=rec, args=("i",))])])
    t = H.transform_program(loop_prog)
    out["recursive_call"] = (P.E.count_fissioned(t.body), type(t.body[0].body[0]).__name__,
                             H.analyze_applicability(loop_prog))
    return out


def _zero():
    return 0


def test_refusals_and_static_analyses_match_reference():
    want, got = _refusals(JAX), _refusals(PORT)
    assert got == want
    assert any(k[2] == "LAD" for k in got["ddg"]) and (0, 1, "FD") in {
        k[:3] for k in got["ddg"]}
    assert "precondition (c)" in got["precondition_c"]
    oks = [ok for ok, _ in got["can_inline"]]
    assert oks == [False, False, False]
    n, kind, rep = got["recursive_call"]
    assert n == 0 and kind == "Call" and rep["transformed"] == 0
    assert any("inline refused" in f for f in rep["failures"])


def test_interpreter_outputs_sink_matches_reference():
    """Effect emissions reach the ``outputs`` sink in program order, the
    same in both packages, on the original and the transformed program."""
    def effect(H):
        return H.Program(inputs=("categories",), body=[
            H.Loop(item_var="c", iter_var="categories", body=[
                H.Query(target="n", query_name="part.lookup", params=("c",)),
                H.Assign(target=None, fn=_ident, args=("n",), effect="log"),
            ])])

    seen = {}
    for P in PKGS:
        sink, sink_t = [], []
        P.H.Interpreter(P.S.TableService(TABLES), outputs=sink.append).run(
            effect(P.H), {"categories": list(range(12))})
        rt = P.R.AsyncQueryRuntime(P.S.TableService(TABLES), n_threads=3)
        try:
            P.H.Interpreter(rt, outputs=sink_t.append).run(
                P.H.transform_program(effect(P.H), overlap=True),
                {"categories": list(range(12))})
        finally:
            rt.drain()
            rt.shutdown()
        assert len(sink) == 12 and sorted(sink_t) == sorted(sink)
        seen[P.name] = sink
    assert seen["repro"] == seen["repro_torch"]
