"""The port's HIR → scheduler bridge against the JAX package's.

``repro_torch.serving.hir_bridge`` (``TraceSimEngine``,
``SchedulerQueryService``) and ``core/app_traces.py`` are copies of the
reference modules.  The three application traces (admin workflow, user
flow, RAG pipeline) run the reference's Part 10 way in each package: the
synchronous program on ``Interpreter``, one scheduler drive per query,
against ``transform_program``'s output on ``AsyncQueryRuntime``
(``PureBatch``), one drive per cohort.

* Over ``TraceSimEngine`` (sleep off): drives, every query's token tuple
  and every trace's observables equal the JAX bridge's, bit for bit.
* Over the real paged engine: both packages' ``PagedInferenceEngine`` on
  the same reduced llama3-8b in float32 (JAX draws the weights,
  ``params_from_numpy`` carries them across), its vocabulary raised to
  65536 because the bridge's prompt encoding emits tokens up to 50020.
  Every query's greedy token tuple, every drive count and every trace's
  observables are equal across the packages, and synchronous =
  transformed in each.

A prompt token outside the vocabulary is a ``ValueError`` in the port,
where the reference's gather clamps it to the table's edge: the last test
pins that difference.
"""
from __future__ import annotations

import dataclasses
import types

import jax
import numpy as np
import pytest

import repro.core.app_traces as j_app_traces
import repro.core.hir as j_hir
import repro.core.runtime as j_runtime
import repro.core.strategies as j_strategies
import repro.serving.hir_bridge as j_bridge
import repro_torch.core.app_traces as t_app_traces
import repro_torch.core.hir as t_hir
import repro_torch.core.runtime as t_runtime
import repro_torch.core.strategies as t_strategies
import repro_torch.serving.hir_bridge as t_bridge
from repro.models.registry import get_arch as j_get_arch
from repro.serving.paged_kv import PagedInferenceEngine as JPagedEngine
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_arch
from repro_torch.serving.paged_kv import PagedInferenceEngine

JAX = types.SimpleNamespace(name="repro", H=j_hir, R=j_runtime, ST=j_strategies,
                            B=j_bridge, AT=j_app_traces)
PORT = types.SimpleNamespace(name="repro_torch", H=t_hir, R=t_runtime, ST=t_strategies,
                             B=t_bridge, AT=t_app_traces)
VOCAB = 65536
TRACES = ("admin_workflow", "user_flow", "rag_pipeline")


class Recorder:
    """A service facade logging each query's result by its identity."""

    def __init__(self, svc):
        self.svc = svc
        self.log = {}

    def _key(self, query_name, params):
        return query_name, tuple(int(p) for p in params)

    def execute(self, query_name, params):
        out = self.svc.execute(query_name, params)
        self.log[self._key(query_name, params)] = out
        return out

    def execute_batch(self, query_name, params_list):
        outs = self.svc.execute_batch(query_name, params_list)
        for p, o in zip(params_list, outs):
            self.log[self._key(query_name, p)] = o
        return outs


def run_trace(P, name, make_engine):
    """One trace, synchronous and transformed, each over a fresh engine."""
    tr = {t.name: t for t in P.AT.all_traces()}[name]
    sync = Recorder(P.B.SchedulerQueryService(make_engine()))
    env_s = P.H.Interpreter(sync).run(tr.program, dict(tr.inputs))
    trans = Recorder(P.B.SchedulerQueryService(make_engine()))
    rt = P.R.AsyncQueryRuntime(trans, n_threads=4, strategy=P.ST.PureBatch())
    try:
        env_a = P.H.Interpreter(rt).run(P.H.transform_program(tr.program), dict(tr.inputs))
    finally:
        rt.drain()
        rt.shutdown()
    st_s, st_a = sync.svc.stats, trans.svc.stats
    return dict(
        n_queries=tr.n_queries,
        observe_sync={k: env_s.get(k) for k in tr.observe},
        observe_async={k: env_a.get(k) for k in tr.observe},
        drives=(st_s.round_trips, st_a.round_trips),
        singles=(st_s.single_drives, st_a.single_drives),
        batches=(st_s.batch_drives, st_a.batch_drives),
        requests=(st_s.requests, st_a.requests),
        tokens=(st_s.tokens, st_a.tokens),
        log_sync=sync.log, log_async=trans.log)


def _check_one_package(res):
    assert res["drives"][0] == res["n_queries"]  # one drive per synchronous query
    assert res["drives"][1] < res["drives"][0]   # the transformed program's win
    assert res["observe_sync"] == res["observe_async"]
    # each query identity gets the same tokens on both sides
    assert res["log_async"] == {k: res["log_sync"][k] for k in res["log_async"]}
    assert all(len(toks) == 4 for toks in res["log_sync"].values())


# ------------------------------------------------------------ TraceSimEngine
def _sim(P):
    return lambda: P.B.TraceSimEngine(sleep=lambda dt: None)


@pytest.mark.parametrize("name", TRACES)
def test_trace_sim_engine_matches_reference(name):
    want = run_trace(JAX, name, _sim(JAX))
    got = run_trace(PORT, name, _sim(PORT))
    assert got == want
    _check_one_package(got)


def test_trace_counts_are_the_papers():
    """9, 25 and 15 synchronous queries: 49 drives in all."""
    n = [t.n_queries for t in t_app_traces.all_traces()]
    assert n == [t.n_queries for t in j_app_traces.all_traces()] == [9, 25, 15]


# -------------------------------------------------------- the paged engines
@pytest.fixture(scope="module")
def engines():
    jarch = j_get_arch("llama3-8b")
    jarch = dataclasses.replace(jarch, cfg=dataclasses.replace(jarch.cfg.reduced(),
                                                               vocab_size=VOCAB))
    jparams = jarch.init(jax.random.PRNGKey(0))
    arch = get_arch("llama3-8b")
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg.reduced(),
                                                             vocab_size=VOCAB))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), arch.cfg,
                                device="cpu")
    kw = dict(n_lanes=8, max_prompt_len=8, max_len=16, page_size=8)
    return ({"jax": lambda: JPagedEngine(jarch, jparams, **kw),
             "torch": lambda: PagedInferenceEngine(arch, tparams, device="cpu", **kw)},
            arch, tparams)


@pytest.mark.parametrize("name", TRACES)
def test_paged_engine_traces_match_reference(engines, name):
    make, _, _ = engines
    want = run_trace(JAX, name, make["jax"])
    got = run_trace(PORT, name, make["torch"])
    _check_one_package(want)
    _check_one_package(got)
    assert got == want
    assert all(0 <= t < VOCAB for toks in got["log_sync"].values() for t in toks)


def test_out_of_vocabulary_prompt_raises_in_the_port(engines):
    """At the reduced vocabulary of 256 the bridge's prompts fall outside
    it: the reference clamps them; the port refuses with ``ValueError``
    before any device work, and the engine stays usable."""
    _, arch, tparams = engines
    small = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    params = dict(tparams, embed={"table": tparams["embed"]["table"][:256]})
    if "lm_head" in tparams:
        params["lm_head"] = {"w": tparams["lm_head"]["w"][:, :256]}
    eng = PagedInferenceEngine(small, params, n_lanes=2, max_prompt_len=8, max_len=16,
                               page_size=8, device="cpu")
    svc = t_bridge.SchedulerQueryService(eng)
    with pytest.raises(ValueError, match="vocabulary"):
        svc.execute("users.list", (300,))
    assert eng.n_free == 2 and eng.dispatches == 0
    assert len(svc.execute("users.list", (7,))) == 4
