"""Device-level Rule A in the port against the JAX package, on the CPU.

Twins of ``tests/test_fission_jaxpr.py``: each case builds the same numpy
inputs from a seed, runs the reference's ``fission_scan``/``lax.scan``
and the port's ``fission_scan``/``scan`` (:mod:`repro_torch.core.fission`)
on them, and compares in float32 at ``rtol = atol = 1e-5``, as the
reference does (1e-4 where the reference uses 1e-4).  The port must
refuse the same bodies with ``FissionPreconditionError``.  The reference's
HLO-count test becomes a count over the fissioned program traced with
``make_fx``: exactly one ``batched_gather`` and no per-iteration query.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax import lax
from torch.fx.experimental.proxy_tensor import make_fx

from repro.core import fission as jf
from repro.core.query import async_query as jquery, table_gather_spec as jspec
from repro_torch.core.ddg import FissionPreconditionError, ScanBodyDDG
from repro_torch.core.fission import (
    FissionReport,
    count_queries,
    fission_scan,
    scan,
    scan_with_queries,
    trace_body,
)
from repro_torch.core.query import async_query, table_gather_spec

_rng = np.random.default_rng(7)
TABLE_NP = _rng.standard_normal((128, 8), dtype=np.float32)
IDS_NP = ((np.arange(24) * 5 + 3) % 128).astype(np.int32)
JT, JI = jnp.asarray(TABLE_NP), jnp.asarray(IDS_NP)
TT, TI = torch.from_numpy(TABLE_NP), torch.from_numpy(IDS_NP)


def f32(v: float):
    return jnp.float32(v), torch.tensor(v, dtype=torch.float32)


def close(jax_tree, torch_tree, rtol=1e-5, atol=1e-5):
    la = jax.tree_util.tree_leaves(jax_tree)
    lb = [x for x in torch.utils._pytree.tree_leaves(torch_tree) if x is not None]
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_allclose(np.asarray(a, np.float32), b.detach().float().numpy(),
                                   rtol=rtol, atol=atol)


def both(jbody, tbody, jinit, tinit, report=None, **tol):
    """JAX lax.scan vs the port's fission_scan and scan on the same body."""
    ref = lax.scan(jbody, jinit, JI)
    close(ref, fission_scan(tbody, tinit, TI, report=report), **tol)
    close(ref, scan(tbody, tinit, TI), **tol)
    return ref


def test_basic_equivalence():
    both(lambda c, i: (c + (r := jquery(jspec, JT, i)).sum(), r[0]),
         lambda c, i: (c + (r := async_query(table_gather_spec, TT, i)).sum(), r[0]),
         *f32(0.0))
    close(jf.fission_scan(lambda c, i: (c + jquery(jspec, JT, i).sum(), None),
                          jnp.float32(0), JI),
          fission_scan(lambda c, i: (c + async_query(table_gather_spec, TT, i).sum(), None),
                       torch.tensor(0.0), TI))


def test_report_counts():
    def body(c, i):
        return c + async_query(table_gather_spec, TT, i).sum(), None

    rep = FissionReport()
    fission_scan(body, torch.tensor(0.0), TI, report=rep)
    jrep = jf.FissionReport()
    jf.fission_scan(lambda c, i: (c + jquery(jspec, JT, i).sum(), None), jnp.float32(0), JI,
                    report=jrep)
    assert (rep.n_queries_found, rep.n_queries_batched) == (
        jrep.n_queries_found, jrep.n_queries_batched) == (1, 1)
    assert rep.batched_specs == ["table_gather"]
    assert count_queries(body, torch.tensor(0.0), TI) == 1


def test_producer_recurrence_allowed():
    """Example 2's pattern: loop-carried dep entirely on the producer side."""

    def jbody(carry, i):
        acc, key = carry
        key = (key * 7 + 13) % 128
        row = jquery(jspec, JT, key)
        return (acc + row.mean(), key), row[:2]

    def tbody(carry, i):
        acc, key = carry
        key = (key * 7 + 13) % 128
        row = async_query(table_gather_spec, TT, key)
        return (acc + row.mean(), key), row[:2]

    both(jbody, tbody, (jnp.float32(0), jnp.int32(3)),
         (torch.tensor(0.0), torch.tensor(3, dtype=torch.int32)))


def test_consumer_recurrence_allowed():
    """Accumulator over query results: consumer-side recurrence is fine."""
    both(lambda c, i: (c * 0.9 + jquery(jspec, JT, i).sum(), c),
         lambda c, i: (c * 0.9 + async_query(table_gather_spec, TT, i).sum(), c),
         *f32(1.0))


def test_cycle_rejected():
    def jbody(key, i):
        row = jquery(jspec, JT, key)
        return jnp.argmax(row).astype(jnp.int32), row.sum()

    def tbody(key, i):
        row = async_query(table_gather_spec, TT, key)
        return torch.argmax(row).to(torch.int32), row.sum()

    with pytest.raises(jf.FissionPreconditionError):
        jf.fission_scan(jbody, jnp.int32(0), JI)
    with pytest.raises(FissionPreconditionError):
        fission_scan(tbody, torch.tensor(0, dtype=torch.int32), TI)


def test_two_independent_queries_both_batched():
    def jbody(c, i):
        r1, r2 = jquery(jspec, JT, i), jquery(jspec, JT, (i + 7) % 128)
        return c + r1.sum() + r2.sum(), (r1[0], r2[1])

    def tbody(c, i):
        r1 = async_query(table_gather_spec, TT, i)
        r2 = async_query(table_gather_spec, TT, (i + 7) % 128)
        return c + r1.sum() + r2.sum(), (r1[0], r2[1])

    rep = FissionReport()
    both(jbody, tbody, *f32(0.0), report=rep, rtol=1e-4)
    assert rep.n_queries_batched == 2


def test_chained_queries_both_batched():
    def jbody(c, i):
        r1 = jquery(jspec, JT, i)
        r2 = jquery(jspec, JT, jnp.abs(r1[0] * 100).astype(jnp.int32) % 128)
        return c + r2.sum(), r2[0]

    def tbody(c, i):
        r1 = async_query(table_gather_spec, TT, i)
        r2 = async_query(table_gather_spec, TT, (r1[0] * 100).abs().to(torch.int32) % 128)
        return c + r2.sum(), r2[0]

    rep = FissionReport()
    both(jbody, tbody, *f32(0.0), report=rep, rtol=1e-4)
    assert rep.n_queries_batched == 2


def test_nested_fission():
    def jinner(c, j):
        return c + jquery(jspec, JT, j).sum(), None

    def jouter(c, i):
        s, _ = lax.scan(jinner, jnp.float32(0), (i + jnp.arange(4)) % 128)
        r = jquery(jspec, JT, i)
        return c + s + r[0], s

    def tinner(c, j):
        return c + async_query(table_gather_spec, TT, j).sum(), None

    def touter(c, i):
        s, _ = fission_scan(tinner, torch.tensor(0.0), (i + torch.arange(4)) % 128)
        r = async_query(table_gather_spec, TT, i)
        return c + s + r[0], s

    rep = FissionReport()
    close(lax.scan(jouter, jnp.float32(0), JI),
          fission_scan(touter, torch.tensor(0.0), TI, report=rep), rtol=1e-4)
    assert rep.n_queries_batched == 1  # the outer query; the inner loop fissions alone


def test_grad_through_fission():
    def jloss(t):
        return jf.fission_scan(
            lambda c, i: (c + (jquery(jspec, t, i) ** 2).sum(), None), jnp.float32(0), JI)[0]

    def tloss(t, scan_fn):
        return scan_fn(lambda c, i: (c + (async_query(table_gather_spec, t, i) ** 2).sum(),
                                     None), torch.tensor(0.0), TI)[0]

    want = jax.grad(jloss)(JT)
    for scan_fn in (fission_scan, scan):
        t = TT.clone().requires_grad_()
        (got,) = torch.autograd.grad(tloss(t, scan_fn), t)
        close(want, got)


def test_vmap_over_fission():
    def jf_(ii):
        return jf.fission_scan(lambda c, i: (c + jquery(jspec, JT, i).sum(), None),
                               jnp.float32(0), ii)[0]

    def tf_(ii):
        return fission_scan(lambda c, i: (c + async_query(table_gather_spec, TT, i).sum(),
                                          None), torch.tensor(0.0), ii)[0]

    batched = np.stack([IDS_NP, (IDS_NP + 1) % 128, (IDS_NP + 2) % 128])
    want = jax.vmap(jf_)(jnp.asarray(batched))
    close(want, torch.vmap(tf_)(torch.from_numpy(batched)))
    close(want, torch.stack([tf_(r) for r in torch.from_numpy(batched)]))


def _gathers(f, *args):
    """(batched_gather nodes, table_gather query nodes) of ``f`` traced."""
    g = make_fx(f)(*args).graph
    names = [n.target.__name__ for n in g.nodes if n.op == "call_function"]
    return names.count("batched_gather.default"), names.count("table_gather.default")


def test_fissioned_program_holds_one_gather_outside_the_loop():
    """The port's counterpart of the reference's HLO-count test: traced
    end to end, the fissioned program executes ONE batched gather for the
    whole loop, while the baseline issues one query per iteration."""

    def mk(scan_fn):
        def f(t, ii):
            return scan_fn(lambda c, i: (c + async_query(table_gather_spec, t, i).sum(), None),
                           torch.zeros(()), ii)[0]
        return f

    assert _gathers(mk(fission_scan), TT, TI) == (1, 0)
    assert _gathers(mk(scan), TT, TI) == (0, len(IDS_NP))


def test_no_queries_falls_back_to_scan():
    both(lambda c, i: (c + i, c), lambda c, i: (c + i, c),
         jnp.int32(0), torch.tensor(0, dtype=torch.int32))


def test_scan_with_queries_switch():
    def tbody(c, i):
        return c + async_query(table_gather_spec, TT, i).sum(), None

    want = jf.scan_with_queries(lambda c, i: (c + jquery(jspec, JT, i).sum(), None),
                                jnp.float32(0), JI, fission=True)
    for fission in (True, False):
        close(want, scan_with_queries(tbody, torch.tensor(0.0), TI, fission=fission))


_COUNTER = torch.zeros(())


def _print_effect(c):
    torch.ops.aten._print("i")
    return c


def _write_closed_over(c):
    _COUNTER.add_(1)  # external state, mutated per iteration
    return c


@pytest.mark.parametrize("effect", [_print_effect, _write_closed_over])
def test_effectful_body_rejected(effect):
    def jbody(c, i):
        jax.debug.print("i={i}", i=i)
        return c + jquery(jspec, JT, i).sum(), None

    def tbody(c, i):
        return effect(c) + async_query(table_gather_spec, TT, i).sum(), None

    with pytest.raises(jf.FissionPreconditionError):
        jf.fission_scan(jbody, jnp.float32(0), JI)
    with pytest.raises(FissionPreconditionError):
        fission_scan(tbody, torch.tensor(0.0), TI)


def test_inplace_temporaries_keep_their_order():
    """In-place writes to the body's own temporaries are allowed and keep
    program order across the split: a consumer-side read of a value that a
    later statement writes in place sees the old contents (the write
    follows its readers to the consumer side)."""

    def jbody(c, i):
        b0 = i.astype(jnp.float32) * 2.0
        y = b0 + jquery(jspec, JT, i).sum()
        return c + y + (b0 + 1.0), y

    def tbody(c, i):
        buf = i.float() * 2.0  # producer side
        y = buf + async_query(table_gather_spec, TT, i).sum()  # reads buf, consumer
        buf.add_(1.0)  # reads no query result, yet must run after y
        return c + y + buf, y

    both(jbody, tbody, *f32(0.5))


def test_masked_conditional_query():
    """Rule B, device form: predication by masking (neutral key + select)."""

    def jbody(c, i):
        use = (i % 2) == 0
        val = jnp.where(use, jquery(jspec, JT, jnp.where(use, i, 0)).sum(), 0.0)
        return c + val, val

    def tbody(c, i):
        use = (i % 2) == 0
        row = async_query(table_gather_spec, TT, torch.where(use, i, torch.zeros_like(i)))
        val = torch.where(use, row.sum(), torch.zeros(()))
        return c + val, val

    both(jbody, tbody, *f32(0.0))


def test_ddg_reads_the_traced_graph():
    """The DDG's view of a traced body: placeholders are [carry, x], the
    table is a constant, the query's consumers are downstream of it."""
    tr = trace_body(lambda c, i: (c + async_query(table_gather_spec, TT, i).sum(), None),
                    torch.tensor(0.0), TI)
    ddg = ScanBodyDDG(tr.gm.graph, tr.n_carry)
    assert len(ddg.carry_in) == 1 and len(ddg.x_in) == 1 and len(ddg.consts) == 1
    q = next(i for i, e in enumerate(ddg.eqns) if "table_gather" in str(e.target))
    assert ddg.downstream(q) == set(range(q, len(ddg.eqns)))
    producer, consumer = ddg.classify_carry(ddg.downstream(q))
    assert (producer, consumer) == (set(), {0})


# ---------------------------------------------------------------------------
# property test: random scan bodies, built alike in both packages
# ---------------------------------------------------------------------------


@st.composite
def scan_body(draw):
    """Random body: producer chain → query on derived key → consumer chain,
    with randomized carry usage (the reference's generator)."""
    n_carry = draw(st.integers(1, 3))
    use_prod_rec = draw(st.booleans())
    use_cons_rec = draw(st.booleans())
    coefs = [draw(st.floats(0.1, 1.9)) for _ in range(4)]
    emit_row = draw(st.booleans())

    def make(query, table, f32_, to_i32):
        def body(carry, i):
            cs = list(carry)
            if use_prod_rec:
                cs[0] = cs[0] * coefs[0] + f32_(1.0)
            key = (i + (to_i32(cs[0] * 3) if use_prod_rec else 0)) % 128
            row = query(table, key)
            v = (row * coefs[1]).sum()
            if use_cons_rec and n_carry > 1:
                cs[1] = cs[1] * coefs[2] + v
            elif not use_prod_rec or n_carry > 1:
                cs[-1] = v + coefs[3]
            return tuple(cs), (row[0] if emit_row else v)
        return body

    jbody = make(lambda t, k: jquery(jspec, t, k), JT, jnp.float32,
                 lambda x: x.astype(jnp.int32))
    tbody = make(lambda t, k: async_query(table_gather_spec, t, k), TT,
                 lambda v: torch.tensor(v, dtype=torch.float32),
                 lambda x: x.to(torch.int32))
    inits = [float(k + 1) for k in range(n_carry)]
    return (jbody, tuple(jnp.float32(v) for v in inits),
            tbody, tuple(torch.tensor(v) for v in inits))


@settings(max_examples=25, deadline=None)
@given(scan_body(), st.integers(2, 24))
def test_property_fission_equals_scan(bodies, n):
    jbody, jinit, tbody, tinit = bodies
    ids = ((np.arange(n) * 11 + 2) % 128).astype(np.int32)
    ref = lax.scan(jbody, jinit, jnp.asarray(ids))
    close(ref, fission_scan(tbody, tinit, torch.from_numpy(ids)), rtol=1e-4, atol=1e-4)
