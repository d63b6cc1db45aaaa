"""The port's ``ModelService`` against the JAX package's.

``repro_torch.core.services.ModelService`` is the paper's ML
instantiation rewritten in PyTorch: ``single_fn`` called as it is,
``batch_fn`` defaulting to ``torch.func.vmap(single_fn)``, per-request
parameters stacked with ``torch.stack``, power-of-two lane buckets with
``pad_batches``, and a non-blocking ``execute_batch_async`` whose resolver
splits every leaf per request.  The same numpy-made ``W`` and items go
through both packages' services for ``tests/test_system.py``'s cases:
results agree within rtol 1e-5 and ``stats``, ``lane_buckets`` and
``padded_items`` are identical.  Each forward is a compiled step, one per
shape (on the CPU it runs the function on its static inputs): the steps
are counted, and two batches of one shape dispatched before either is
resolved keep their own results.  The end-to-end program (a loop of
per-item queries, transformed and run on the async runtime) and the
table-scoring query the card drives through ``batched_gather`` run in
both packages too.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hir as j_hir
import repro.core.runtime as j_runtime
import repro.core.services as j_services
import repro.core.strategies as j_strategies
import repro_torch.core.hir as t_hir
import repro_torch.core.runtime as t_runtime
import repro_torch.core.services as t_services
import repro_torch.core.strategies as t_strategies
from repro_torch.kernels import registry
from repro_torch.kernels.batched_gather.ops import gather_op

RTOL = 1e-5


def _stats(svc) -> dict:
    return {k: v for k, v in svc.stats.snapshot().items() if k != "busy_time"}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((16, 16), dtype=np.float32),
            [rng.standard_normal(16, dtype=np.float32) for _ in range(40)])


def _scores(W):
    Wj, Wt = jnp.asarray(W), torch.as_tensor(W)
    return (lambda x: jnp.tanh(x @ Wj).sum()), (lambda x: torch.tanh(x @ Wt).sum())


def _batched_scores(W):
    Wj, Wt = jnp.asarray(W), torch.as_tensor(W)
    return (lambda xs: jnp.tanh(xs @ Wj).sum(-1)), (lambda xs: torch.tanh(xs @ Wt).sum(-1))


def _close(got, want):
    np.testing.assert_allclose(np.asarray([float(g) for g in got]),
                               np.asarray([float(w) for w in want]), rtol=RTOL)


@pytest.mark.parametrize("explicit", [False, True])
def test_execute_and_batch_match_reference(data, explicit):
    W, items = data
    js, ts = _scores(W)
    jb, tb = _batched_scores(W) if explicit else (None, None)
    jsvc, tsvc = j_services.ModelService(js, jb), t_services.ModelService(ts, tb)
    jx, tx = [jnp.asarray(x) for x in items], [torch.as_tensor(x) for x in items]
    _close([tsvc.execute("score", (x,)) for x in tx[:5]],
           [jsvc.execute("score", (x,)) for x in jx[:5]])
    got = tsvc.execute_batch("score", [(x,) for x in tx[5:30]])
    want = jsvc.execute_batch("score", [(x,) for x in jx[5:30]])
    assert len(got) == len(want) == 25
    assert all(isinstance(g, torch.Tensor) and g.shape == () for g in got)
    _close(got, want)
    assert _stats(tsvc) == _stats(jsvc) == {
        "round_trips": 5 + 3, "single_queries": 5, "batches": 1, "batched_items": 25,
        "padded_items": 0}


def test_default_batch_fn_is_torch_vmap(data):
    W, items = data
    _, ts = _scores(W)
    svc = t_services.ModelService(ts)
    xs = torch.stack([torch.as_tensor(x) for x in items[:7]])
    torch.testing.assert_close(svc.batch_fn(xs), torch.func.vmap(ts)(xs))


def test_pad_batches_lane_buckets_match_reference(data):
    """Each lane settles on one power-of-two shape; the filler rows are
    counted and sliced away, in both packages alike."""
    W, items = data
    js, ts = _scores(W)
    jsvc = j_services.ModelService(js, pad_batches=True)
    tsvc = t_services.ModelService(ts, pad_batches=True)
    plan = [("score", slice(0, 3)), ("score", slice(3, 5)), ("score", slice(0, 6)),
            ("embed", slice(0, 2)), ("score", slice(6, 7)), ("embed", slice(2, 7))]
    buckets = []
    for name, sl in plan:
        got = tsvc.execute_batch(name, [(torch.as_tensor(x),) for x in items[sl]])
        want = jsvc.execute_batch(name, [(jnp.asarray(x),) for x in items[sl]])
        assert len(got) == len(want) == sl.stop - sl.start
        _close(got, want)
        assert tsvc.lane_buckets == jsvc.lane_buckets
        buckets.append(dict(tsvc.lane_buckets))
    assert buckets[:4] == [{"score": 4}, {"score": 4}, {"score": 8},
                           {"score": 8, "embed": 2}]
    assert _stats(tsvc) == _stats(jsvc)
    assert tsvc.stats.padded_items == 1 + 2 + 2 + 0 + 7 + 3
    # padded results equal unpadded ones
    ref = t_services.ModelService(ts).execute_batch(
        "score", [(torch.as_tensor(x),) for x in items[3:5]])
    again = t_services.ModelService(ts, pad_batches=True).execute_batch(
        "score", [(torch.as_tensor(x),) for x in items[3:5]])
    _close(again, ref)


def test_execute_batch_async_resolver_splits_every_leaf(data):
    """The async form returns before waiting; its resolver splits a pytree
    result (a tuple and a dict) per request, as the reference's does."""
    W, items = data
    Wj, Wt = jnp.asarray(W), torch.as_tensor(W)

    def j_single(x, k):
        h = jnp.tanh(x @ Wj)
        return h.sum() * k, {"head": h[:3]}

    def t_single(x, k):
        h = torch.tanh(x @ Wt)
        return h.sum() * k, {"head": h[:3]}

    jsvc, tsvc = j_services.ModelService(j_single), t_services.ModelService(t_single)
    ks = np.arange(1, 9, dtype=np.float32)
    resolve = tsvc.execute_batch_async(
        "f", [(torch.as_tensor(x), torch.tensor(k)) for x, k in zip(items, ks)])
    assert callable(resolve) and tsvc.stats.batches == 1  # dispatched, not resolved
    got = resolve()
    want = jsvc.execute_batch_async(
        "f", [(jnp.asarray(x), jnp.asarray(k)) for x, k in zip(items, ks)])()
    assert len(got) == len(want) == 8
    for (gs, gd), (ws, wd) in zip(got, want):
        np.testing.assert_allclose(float(gs), float(ws), rtol=RTOL)
        assert gd["head"].shape == (3,)
        np.testing.assert_allclose(gd["head"].numpy(), np.asarray(wd["head"]), rtol=RTOL)
    assert _stats(tsvc) == _stats(jsvc)


def _close_abs(got, want):
    """``_close`` with atol 1e-5 as well: a score is a sum of unit-sized
    terms of both signs, so one near 0 keeps its terms' float32 error."""
    np.testing.assert_allclose(np.asarray([float(g) for g in got]),
                               np.asarray([float(w) for w in want]), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("pad", [False, True])
def test_one_compiled_step_per_shape(data, pad):
    """Single queries share one step; a batch's step is keyed on its
    stacked shape (with ``pad_batches``, the lane's bucket), built at its
    first use; results equal JAX's ``ModelService``'s."""
    W, items = data
    js, ts = _scores(W)
    jsvc = j_services.ModelService(js, pad_batches=pad)
    tsvc = t_services.ModelService(ts, pad_batches=pad)
    plan = [None, 5, None, 3, 5, None, 4, 2]  # None: a single query
    at = 0
    for n in plan:
        chunk = items[at: at + (n or 1)]
        at += n or 1
        if n is None:
            _close_abs([tsvc.execute("score", (torch.as_tensor(chunk[0]),))],
                   [jsvc.execute("score", (jnp.asarray(chunk[0]),))])
        else:
            _close_abs(tsvc.execute_batch("score", [(torch.as_tensor(x),) for x in chunk]),
                   jsvc.execute_batch("score", [(jnp.asarray(x),) for x in chunk]))
    steps = tsvc.steps[torch.device("cpu")].steps
    sizes = sorted(k[1] for k in steps if k[0])
    assert sum(1 for k in steps if not k[0]) == 1
    assert sizes == ([8] if pad else [2, 3, 4, 5])
    assert _stats(tsvc) == _stats(jsvc)


def test_async_batches_of_one_shape_keep_their_own_results(data):
    """Two batches of one shape dispatched before either is resolved, and
    resolved in reverse order, each return their own results (copied out
    of the step before the next one ran)."""
    W, items = data
    js, ts = _scores(W)
    jsvc, tsvc = j_services.ModelService(js), t_services.ModelService(ts)
    first, second = items[:6], items[6:12]
    r1 = tsvc.execute_batch_async("score", [(torch.as_tensor(x),) for x in first])
    r2 = tsvc.execute_batch_async("score", [(torch.as_tensor(x),) for x in second])
    assert len(tsvc.steps[torch.device("cpu")].steps) == 1
    got2, got1 = r2(), r1()
    _close_abs(got1, jsvc.execute_batch("score", [(jnp.asarray(x),) for x in first]))
    _close_abs(got2, jsvc.execute_batch("score", [(jnp.asarray(x),) for x in second]))
    assert not np.allclose([float(g) for g in got1], [float(g) for g in got2])


def test_torch_block_is_a_no_op_on_cpu():
    tree = {"a": torch.ones(3), "b": (torch.zeros(2), 5)}
    assert t_services.torch_block(tree) is tree
    assert "torch_block" in t_services.__all__


def _program(H, name, target):
    """``total += float(s)`` over the items' queries; ``log`` keeps each
    query's result in program order."""
    return H.Program(inputs=("items", "total", "log"), body=[
        H.Loop(item_var="x", iter_var="items", body=[
            H.Query(target=target, query_name=name, params=("x",)),
            H.Assign(target="total", fn=lambda t, s: t + float(s), args=("total", target)),
            H.Assign(target="log", fn=lambda lg, s: lg + (float(s),), args=("log", target)),
        ])])


def _inputs(items):
    return {"items": items, "total": 0.0, "log": ()}


def _same_run(got, want):
    """Per-query results within rtol 1e-5 (atol 1e-5: a result is a sum of
    unit-sized terms of both signs, so one near 0 keeps its terms' float32
    error); the totals within 1e-5 of the sum of the results' magnitudes."""
    np.testing.assert_allclose(got["log"], want["log"], rtol=RTOL, atol=RTOL)
    scale = float(np.abs(np.asarray(want["log"])).sum())
    assert abs(got["total"] - want["total"]) <= RTOL * scale


def _end_to_end(H, R, S, ST, score, items, strategy, overlap=True, n_threads=2):
    prog = _program(H, "score", "s")
    base = H.Interpreter(S.ModelService(score)).run(prog, _inputs(items))
    svc = S.ModelService(score)
    rt = R.AsyncQueryRuntime(svc, n_threads=n_threads, strategy=strategy(ST))
    try:
        out = H.Interpreter(rt).run(H.transform_program(prog, overlap=overlap),
                                    _inputs(items))
    finally:
        rt.drain()
        rt.shutdown()
    return base, out, svc


@pytest.mark.parametrize("strategy", ["LowerThreshold", "PureBatch"])
def test_model_service_end_to_end_matches_reference(data, strategy):
    """``tests/test_system.py``'s program: a loop of per-item forwards,
    synchronous and transformed, in both packages."""
    W, items = data
    js, ts = _scores(W)
    pick = {"LowerThreshold": lambda ST: ST.LowerThreshold(bt=3),
            "PureBatch": lambda ST: ST.PureBatch()}[strategy]
    jb, ja, jsvc = _end_to_end(j_hir, j_runtime, j_services, j_strategies, js,
                               [jnp.asarray(x) for x in items], pick,
                               overlap=strategy != "PureBatch")
    tb, ta, tsvc = _end_to_end(t_hir, t_runtime, t_services, t_strategies, ts,
                               [torch.as_tensor(x) for x in items], pick,
                               overlap=strategy != "PureBatch")
    for got in (tb, ta, ja):
        _same_run(got, jb)
    assert tsvc.stats.batches >= 1
    assert tsvc.stats.single_queries + tsvc.stats.batched_items == 40
    if strategy == "PureBatch":  # one batch of all 40, in both packages
        assert _stats(tsvc) == _stats(jsvc) == {
            "round_trips": 3, "single_queries": 0, "batches": 1, "batched_items": 40,
            "padded_items": 0}


@pytest.mark.parametrize("pad", [False, True])
def test_table_scoring_through_batched_gather_matches_reference(pad):
    """The query the card drives: ``embed.score(t)`` reads row ``t`` of an
    embedding table through ``batched_gather`` (its plain version here)
    and scores it against ``w``; ids are 0-d int64 tensors, stacked by the
    service.  Both packages give the same totals, synchronous and
    transformed (``GrowingUpperThreshold``, overlap), and each gather is
    one query or one batch."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((1000, 64), dtype=np.float32)
    w = rng.standard_normal(64, dtype=np.float32)
    ids = rng.integers(0, 1000, 256)
    tt, tw = torch.as_tensor(table), torch.as_tensor(w)
    jt, jw = jnp.asarray(table), jnp.asarray(w)

    def t_batch(t):
        return (gather_op(tt, t).float() * tw).sum(-1)

    def t_single(t):
        return t_batch(t[None])[0]

    def j_batch(t):
        return (jt[t].astype(jnp.float32) * jw).sum(-1)

    def j_single(t):
        return j_batch(t[None])[0]

    totals = {}
    for name, S, H, R, ST, single, batch, items in (
            ("jax", j_services, j_hir, j_runtime, j_strategies, j_single, j_batch,
             [jnp.asarray(i) for i in ids]),
            ("torch", t_services, t_hir, t_runtime, t_strategies, t_single, t_batch,
             [torch.tensor(int(i)) for i in ids])):
        prog = _program(H, "embed.score", "s")
        sync_svc = S.ModelService(single, batch)
        base = H.Interpreter(sync_svc).run(prog, _inputs(items))
        svc = S.ModelService(single, batch, pad_batches=pad)
        rt = R.AsyncQueryRuntime(svc, n_threads=4,
                                 strategy=ST.GrowingUpperThreshold(initial_upper=8, bt=3))
        registry.reset_launches()
        try:
            out = H.Interpreter(rt).run(H.transform_program(prog, overlap=True),
                                        _inputs(items))
        finally:
            rt.drain()
            rt.shutdown()
        assert registry.launch_counts()["batched_gather"] == 0  # the plain version on the CPU
        assert svc.stats.single_queries + svc.stats.batched_items == len(ids)
        assert svc.stats.batches >= 1
        if pad:
            assert all(b & (b - 1) == 0 for b in svc.lane_buckets.values())
        totals[name] = (base, out)
    rows = (table[ids].astype(np.float64) * w).sum(-1)
    want = {"log": tuple(rows), "total": float(rows.sum())}
    for b, a in totals.values():
        _same_run(b, want)
        _same_run(a, want)
