"""The port's query runtime against the JAX package's.

``repro_torch.core.runtime`` (the sharded ``AsyncQueryRuntime``),
``core/runtime_baseline.py`` (the global-lock ``GlobalLockRuntime``),
``core/faults.py`` (``ChaosPlan``, ``ChaosService``) and the services
are copies of the reference modules.  Each scenario below twins a case of
``tests/test_runtime.py``, ``tests/test_runtime_lanes.py`` or the
``ChaosService`` cases of ``tests/test_resilience.py``: it runs once in
each package, on ``TableService`` or ``SimulatedDBService`` with zero
latency, keeps the reference test's own assertions, and returns its
results and counters, which must be equal across the packages.  Only
scenarios whose counters do not depend on thread timing compare counters
(``PureBatch``, one worker, or gated services); no assertion reads a clock.
"""
from __future__ import annotations

import threading
import types

import pytest

import repro.core.faults as j_faults
import repro.core.resilience as j_resilience
import repro.core.runtime as j_runtime
import repro.core.runtime_baseline as j_baseline
import repro.core.services as j_services
import repro.core.strategies as j_strategies
import repro_torch.core.faults as t_faults
import repro_torch.core.resilience as t_resilience
import repro_torch.core.runtime as t_runtime
import repro_torch.core.runtime_baseline as t_baseline
import repro_torch.core.services as t_services
import repro_torch.core.strategies as t_strategies

JAX = types.SimpleNamespace(name="repro", R=j_runtime, B=j_baseline, S=j_services,
                            ST=j_strategies, F=j_faults, RS=j_resilience)
PORT = types.SimpleNamespace(name="repro_torch", R=t_runtime, B=t_baseline, S=t_services,
                             ST=t_strategies, F=t_faults, RS=t_resilience)

TABLES = {"t": {i: i * 3 for i in range(10_000)}}
N_TEMPLATES = 4
LANE_TABLES = {f"t{i}": {k: k * (i + 1) for k in range(1000)} for i in range(N_TEMPLATES)}
CHAOS_TABLES = {"t": {i: i * 10 for i in range(512)}}


def _runtime(P, kind):
    return P.R.AsyncQueryRuntime if kind == "sharded" else P.B.GlobalLockRuntime


def _svc_stats(svc) -> dict:
    return {k: v for k, v in svc.stats.snapshot().items() if k != "busy_time"}


def _rt_stats(rt) -> dict:
    snap = rt.stats.snapshot()
    keep = ("submitted", "completed", "deduped", "cache_hits", "single_executions",
            "batch_executions")
    return {k: snap[k] for k in keep if k in snap} | {
        "lane_sizes": {k: sorted(s for _, s in v) for k, v in snap["lane_traces"].items()},
        "mean_batch_size": snap["mean_batch_size"]}


def _interleaved(rt, n_per_template: int):
    """Submit A,B,C,D,A,B,... — the single queue's worst case."""
    return [(rt.submit(f"t{i}.lookup", (k,)), k * (i + 1))
            for k in range(n_per_template) for i in range(N_TEMPLATES)]


def _both(scenario, *args):
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


# ----------------------------------------------------------------- strategies
def _decisions(P):
    ST = P.ST
    out = {"async": [ST.PureAsync().decide(n, False) for n in (0, 1, 100)],
           "batch": [ST.PureBatch().decide(50, False), ST.PureBatch().decide(50, True)],
           "one_or_all": [ST.OneOrAll().decide(n, False) for n in (1, 7)],
           "lower": [ST.LowerThreshold(bt=3).decide(n, False) for n in (2, 3, 4)]}
    with pytest.raises(ValueError):
        ST.LowerThreshold(bt=2)
    g = ST.GrowingUpperThreshold(initial_upper=4, bt=None)
    out["growing"] = [g.decide(3, False), g.decide(10, False), g.upper,
                      g.decide(10, False), g.upper]
    g.reset()
    out["growing"].append(g.upper)
    g2 = ST.GrowingUpperThreshold(initial_upper=8, bt=3)
    out["growing_bt"] = [g2.decide(2, False), g2.decide(6, False)]
    out["from_name"] = [type(ST.from_name(n)).__name__ for n in ("async", "adaptive")]
    with pytest.raises(KeyError):
        ST.from_name("nope")
    a = ST.AdaptiveCost(alpha=0.3)
    for _ in range(8):
        a.observe(1, 1.0)
    for n in (4, 8, 16, 32, 6, 12):
        a.observe(n, 3.0 + 0.1 * n)
    out["adaptive"] = [a.threshold, a.estimates(), a.decide(3, False), a.decide(5, False)]
    d = ST.AdaptiveCost(alpha=0.5)
    for _ in range(5):
        d.observe(1, 0.1)
    for n in (4, 8, 16, 24, 12):
        d.observe(n, 1.0 + 0.5 * n)
    out["degrades"] = [d.threshold, d.decide(100, False)]
    e = ST.AdaptiveCost(min_samples=2)
    out["explores"] = [e.decide(1, False), sorted({e.decide(10, False) for _ in range(4)})]
    return out


def test_strategy_decisions_match_reference():
    got = _both(_decisions)
    assert got["growing"] == [3, 4, 8, 8, 16, 4]
    assert got["adaptive"][0] == pytest.approx(3.333, abs=0.3)
    assert got["degrades"] == [float("inf"), 1]
    assert got["explores"] == [1, [1, 10]]


# ------------------------------------------------------- runtime behaviour
def _order_and_values(P, kind):
    with _runtime(P, kind)(P.S.TableService(TABLES), n_threads=4,
                           strategy=P.ST.OneOrAll()) as rt:
        handles = [rt.submit("t.lookup", (i,)) for i in range(200)]
        results = [rt.fetch(h) for h in handles]
    assert results == [i * 3 for i in range(200)]
    return results


def _lower_threshold(P, kind):
    svc = P.S.TableService(TABLES)
    rt = _runtime(P, kind)(svc, n_threads=2, strategy=P.ST.LowerThreshold(bt=3))
    handles = [rt.submit("t.lookup", (i,)) for i in range(100)]
    rt.drain()
    results = [rt.fetch(h) for h in handles]
    rt.shutdown()
    assert svc.stats.batched_items + svc.stats.single_queries == 100
    return results


def _pure_batch(P, kind):
    svc = P.S.TableService(TABLES)
    rt = _runtime(P, kind)(svc, n_threads=4, strategy=P.ST.PureBatch())
    handles = [rt.submit("t.lookup", (i,)) for i in range(50)]
    rt.producer_done()
    results = [rt.fetch(h) for h in handles]
    rt.shutdown()
    assert results == [i * 3 for i in range(50)]
    assert svc.stats.batches == 1 and svc.stats.batched_items == 50
    return results, _svc_stats(svc), _rt_stats(rt)


def _error_through_fetch(P, kind):
    svc = P.S.TableService({"t": {}}, queries={"boom": lambda tables, p: 1 / 0})
    rt = _runtime(P, kind)(svc, n_threads=1)
    with pytest.raises(ZeroDivisionError):
        rt.fetch(rt.submit("boom", ()))
    rt.shutdown()
    return _svc_stats(svc)


def _bounded_queue(P, kind):
    svc = P.S.TableService(TABLES)
    rt = _runtime(P, kind)(svc, n_threads=1, strategy=P.ST.PureAsync(), max_pending=4)
    handles = [rt.submit("t.lookup", (i,)) for i in range(20)]
    rt.drain()
    results = [rt.fetch(h) for h in handles]
    rt.shutdown()
    assert results == [i * 3 for i in range(20)]
    return results, _svc_stats(svc)


def _lanes(P, kind, sharded):
    svc = P.S.TableService(LANE_TABLES)
    rt = _runtime(P, kind)(svc, n_threads=4, strategy=P.ST.PureBatch(), sharded=sharded)
    handles = _interleaved(rt, 40)
    rt.drain()
    for h, want in handles:
        assert rt.fetch(h) == want
    rt.shutdown()
    if sharded:
        assert svc.stats.batches == N_TEMPLATES and svc.stats.single_queries == 0
    else:
        assert svc.stats.batches == 0 and svc.stats.single_queries == 40 * N_TEMPLATES
    return _svc_stats(svc), _rt_stats(rt), rt._lanes == {}


def _queued_duplicates(P, kind, dedup):
    svc = P.S.TableService(LANE_TABLES)
    rt = _runtime(P, kind)(svc, n_threads=1 if not dedup else 4,
                           strategy=P.ST.PureBatch(), dedup=dedup)
    handles = [rt.submit("t0.lookup", (7,)) for _ in range(10)]
    rt.drain()
    assert [rt.fetch(h) for h in handles] == [7] * 10
    rt.shutdown()
    return _svc_stats(svc), _rt_stats(rt)


class _GatedMixin:
    """execute() blocks until released: pins one call in flight."""

    def _gate_init(self):
        self.started = threading.Event()
        self.release = threading.Event()

    def execute(self, query_name, params):
        self.started.set()
        assert self.release.wait(timeout=5.0)
        return super().execute(query_name, params)


def _gated(P):
    cls = type("Gated", (_GatedMixin, P.S.TableService), {})
    svc = cls(LANE_TABLES)
    svc._gate_init()
    return svc


def _inflight_duplicates(P, kind):
    svc = _gated(P)
    rt = _runtime(P, kind)(svc, n_threads=2)
    h0 = rt.submit("t0.lookup", (3,))
    assert svc.started.wait(timeout=5.0)
    dupes = [rt.submit("t0.lookup", (3,)) for _ in range(5)]
    svc.release.set()
    assert rt.fetch(h0) == 3
    assert [rt.fetch(h) for h in dupes] == [3] * 5
    rt.drain()
    rt.shutdown()
    assert svc.stats.single_queries == 1 and rt.stats.deduped == 5
    return _svc_stats(svc), _rt_stats(rt)


def _bounded_dedup(P, kind):
    svc = _gated(P)
    rt = _runtime(P, kind)(svc, n_threads=1, max_pending=2)
    rt.submit("t0.lookup", (3,))
    assert svc.started.wait(timeout=5.0)
    rt.submit("t0.lookup", (3,))
    passed = threading.Event()

    def third():
        rt.submit("t0.lookup", (3,))
        passed.set()

    th = threading.Thread(target=third, daemon=True)
    th.start()
    blocked = not passed.wait(timeout=0.3)  # held at the bound
    svc.release.set()
    assert passed.wait(timeout=5.0)
    rt.drain()
    rt.shutdown()
    assert blocked
    return _svc_stats(svc), _rt_stats(rt)


def _result_cache(P, kind):
    svc = P.S.TableService(LANE_TABLES)
    rt = _runtime(P, kind)(svc, n_threads=1, result_cache_size=2)
    vals = [rt.fetch(rt.submit("t0.lookup", (k,))) for k in (1, 1, 2, 3, 1)]
    rt.shutdown()
    assert vals == [1, 1, 2, 3, 1] and rt.stats.cache_hits == 1
    assert svc.stats.single_queries == 4
    return vals, _svc_stats(svc), _rt_stats(rt)


def _adaptive_ignores_failures(P, kind):
    strat = P.ST.AdaptiveCost()
    svc = P.S.TableService(TABLES, queries={"boom": lambda tables, p: 1 / 0})
    rt = _runtime(P, kind)(svc, n_threads=1, strategy=strat)
    with pytest.raises(ZeroDivisionError):
        rt.fetch(rt.submit("boom", ()))
    rt.shutdown()
    assert strat._n_single == 0 and strat._n_batch == 0
    return _svc_stats(svc)


def _adaptive_end_to_end(P, kind):
    svc = P.S.TableService(LANE_TABLES)
    rt = _runtime(P, kind)(svc, n_threads=2, strategy=P.ST.AdaptiveCost(alpha=0.3))
    handles = _interleaved(rt, 30)
    rt.drain()
    vals = [rt.fetch(h) for h, _ in handles]
    rt.shutdown()
    assert vals == [want for _, want in handles]
    assert rt.stats.completed == 30 * N_TEMPLATES
    return vals


def _simulated_db(P, kind):
    svc = P.S.SimulatedDBService(rtt=0.0, single_proc=0.0, batch_proc=0.0,
                                 batch_fixed=0.0, concurrency=4)
    one = svc.execute("q", (1,))
    many = svc.execute_batch("q", [(i,) for i in range(50)])
    assert _svc_stats(svc)["round_trips"] == 1 + 3
    return one, many, _svc_stats(svc)


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _order_and_values, _lower_threshold, _pure_batch, _error_through_fetch, _bounded_queue,
    _inflight_duplicates, _bounded_dedup, _result_cache, _adaptive_ignores_failures,
    _adaptive_end_to_end, _simulated_db)}


@pytest.mark.parametrize("kind", ["sharded", "global_lock"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_runtime_scenario_matches_reference(name, kind):
    _both(SCENARIOS[name], kind)


@pytest.mark.parametrize("kind", ["sharded", "global_lock"])
@pytest.mark.parametrize("sharded", [True, False])
def test_lanes_against_single_queue_match_reference(kind, sharded):
    svc_stats, rt_stats, gc = _both(_lanes, kind, sharded)
    if sharded:
        assert rt_stats["lane_sizes"] == {f"t{i}.lookup": [40] for i in range(N_TEMPLATES)}
        assert rt_stats["mean_batch_size"] == 40.0
    else:
        assert rt_stats["mean_batch_size"] == 1.0
    if kind == "sharded":
        assert gc  # drained lanes are dropped from the scan set


@pytest.mark.parametrize("kind", ["sharded", "global_lock"])
@pytest.mark.parametrize("dedup", [True, False])
def test_queued_duplicates_match_reference(kind, dedup):
    svc_stats, rt_stats = _both(_queued_duplicates, kind, dedup)
    if dedup:
        assert svc_stats["single_queries"] + svc_stats["batched_items"] == 1
        assert rt_stats["deduped"] == 9
    else:
        assert rt_stats["deduped"] == 0 and svc_stats["batched_items"] == 10


# ------------------------------------------------ ChaosService on the runtime
def _chaos_plan(P):
    p1, p2 = P.F.ChaosPlan(seed=5, fail_rate=0.3), P.F.ChaosPlan(seed=5, fail_rate=0.3)
    ids = [("t.lookup", (i,)) for i in range(64)]
    marks = [p1.poisoned(*i) for i in ids]
    assert marks == [p2.poisoned(*i) for i in ids] and any(marks) and not all(marks)
    svc = P.F.ChaosService(P.S.TableService(CHAOS_TABLES),
                           P.F.ChaosPlan(seed=1, transient_rate=1.0, transient_repeats=2))
    outs = []
    for _ in range(3):
        try:
            outs.append(svc.execute("t.lookup", (3,)))
        except P.F.InjectedFault as e:
            outs.append(type(e).__name__)
    assert outs == ["InjectedFault", "InjectedFault", 30]
    return marks, outs, P.RS.hash_unit(7, "poison", "t.lookup", (3,))


def _absorbs_transients(P):
    svc = P.F.ChaosService(P.S.TableService(CHAOS_TABLES),
                           P.F.ChaosPlan(seed=2, transient_rate=1.0, transient_repeats=1))
    with P.R.AsyncQueryRuntime(svc, n_threads=1, resilience=P.RS.Resilience()) as rt:
        vals = [rt.fetch(rt.submit("t.lookup", (i,))) for i in range(8)]
    assert vals == [i * 10 for i in range(8)]
    assert int(rt.stats.retries) > 0 and int(rt.stats.failures) > 0
    return vals, int(rt.stats.retries), int(rt.stats.failures)


def _fission_isolates(P, fission):
    plan = P.F.ChaosPlan(seed=3, fail_rate=0.25)
    svc = P.F.ChaosService(P.S.TableService(CHAOS_TABLES), plan)
    ids = list(range(48 if fission else 16))
    poisoned = {i for i in ids if plan.poisoned("t.lookup", (i,))}
    assert poisoned and len(poisoned) < len(ids)
    res = (P.RS.Resilience() if fission else
           P.RS.Resilience(fission=False, retry=P.RS.RetryPolicy(max_attempts=1)))
    svc_kw = dict(n_threads=1, strategy=P.ST.PureBatch(), dedup=False, resilience=res)
    outs = {}
    with P.R.AsyncQueryRuntime(svc, **svc_kw) as rt:
        hs = {i: rt.submit("t.lookup", (i,)) for i in ids}
        rt.producer_done()
        for i, h in hs.items():
            try:
                outs[i] = rt.fetch(h)
            except P.F.InjectedParamError as e:
                outs[i] = ("own", e.params)
            except Exception as e:  # noqa: BLE001 — the batch's error, by name
                outs[i] = type(e).__name__
    if fission:
        assert all(outs[i] == ("own", (i,)) for i in poisoned)
        assert all(outs[i] == i * 10 for i in ids if i not in poisoned)
        assert int(rt.stats.fissions) > 0
    else:
        assert sum(not isinstance(v, int) for v in outs.values()) >= len(poisoned)
        assert int(rt.stats.fissions) == 0
    return outs, int(rt.stats.fissions), int(rt.stats.completed), _svc_stats(svc.inner)


def _dry_budget(P):
    svc = P.F.ChaosService(P.S.TableService(CHAOS_TABLES),
                           P.F.ChaosPlan(seed=11, transient_rate=1.0, transient_repeats=1))
    rt = P.R.AsyncQueryRuntime(svc, n_threads=1, resilience=P.RS.Resilience())
    try:
        budget = rt._fd.budget(rt._lane_key("t.lookup"))
        while budget.try_spend():
            pass
        val = rt.fetch(rt.submit("t.lookup", (9,)))
        assert val == 90 and int(rt.stats.retries) >= 1
        return val, int(rt.stats.retries)
    finally:
        rt.shutdown()


def _chaos_sweep(P, seed):
    """Seeded poison, transients and latency spikes across concurrent
    producers: each request completes with its fault-free value or raises
    its own injected error, with no lost or duplicated delivery."""
    plan = P.F.ChaosPlan(seed=seed, fail_rate=0.12, transient_rate=0.2,
                         transient_repeats=1)
    svc = P.F.ChaosService(P.S.TableService(CHAOS_TABLES), plan)
    rt = P.R.AsyncQueryRuntime(svc, n_threads=4, resilience=P.RS.Resilience())
    results, lock = {}, threading.Lock()

    def producer(w):
        local = [((w * 12 + j) % 256, None) for j in range(12)]
        local = [(i, rt.submit("t.lookup", (i,))) for i, _ in local]
        for i, h in local:
            try:
                out = ("ok", rt.fetch(h))
            except P.F.InjectedParamError as e:
                out = ("poisoned", e.params)
            with lock:
                results[(w, i)] = out

    threads = [threading.Thread(target=producer, args=(w,), daemon=True) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive(), "a producer hung under chaos"
    rt.drain()
    rt.shutdown()
    assert len(results) == 8 * 12
    assert int(rt.stats.completed) == int(rt.stats.submitted)
    for (w, i), (kind, val) in results.items():
        want = ("poisoned", (i,)) if plan.poisoned("t.lookup", (i,)) else ("ok", i * 10)
        assert (kind, val) == want
    return sorted(results.items())


def test_chaos_plan_and_service_match_reference():
    _both(_chaos_plan)


def test_runtime_absorbs_transient_faults_like_reference():
    _both(_absorbs_transients)


@pytest.mark.parametrize("fission", [True, False])
def test_fission_retry_isolation_matches_reference(fission):
    _both(_fission_isolates, fission)


def test_dry_retry_budget_matches_reference():
    _both(_dry_budget)


@pytest.mark.parametrize("seed", [0, 101])
def test_chaos_sweep_deliveries_match_reference(seed):
    _both(_chaos_sweep, seed)


def test_chaos_seed_env_matches_reference(monkeypatch):
    monkeypatch.setenv("REPRO_CHAOS_SEED", "17")
    assert t_faults.chaos_seed() == j_faults.chaos_seed() == 17
    monkeypatch.delenv("REPRO_CHAOS_SEED")
    assert t_faults.chaos_seed(3) == j_faults.chaos_seed(3) == 3
