"""The port's twins of the JAX package's examples against the reference.

``src/repro_torch/examples/`` holds one twin per ``examples/*.py``.  Each
test feeds both packages the same inputs (reduced llama3-8b and olmo-1b
in float32, the JAX weights carried across with ``params_from_numpy``;
the JAX example's table) and compares:

* serving: the reference's ``overlap_kv_demo`` and ``depth_spill_demo``
  (imported from ``examples/`` as ``tests/test_serving.py`` does) against
  the port's, greedy streams per ``rid``; and a depth sweep, ``spec_depth``
  1, 2 and 4 on the port's dense and paged engines (the fused chunk tick
  included), streams per request equal to depth 1's and to the JAX
  engine's at the same depth.  Settle order and abort counts depend on
  the speculation threads' timing and are not compared;
* the engines' template shape pin under two speculation threads at once;
* training: ``run`` against the same steps written with the JAX
  package's ``make_train_step``, ``CheckpointManager`` and
  ``PrefetchLoader``; the restart bit for bit; the port's checkpoint
  restored by the JAX manager;
* device fission: the scan results, the batched query count and the
  gradient's nonzero rows against the JAX example's.

The quickstart is a verbatim copy, held by ``tests/test_torch_copies.py``.
"""
from __future__ import annotations

import dataclasses
import re
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import strategies as j_strategies
from repro.data.pipeline import PrefetchLoader as JLoader
from repro.data.pipeline import SyntheticLMStream as JStream
from repro.models.registry import get_arch as j_get_arch
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.paged_kv import PagedInferenceEngine as JPagedEngine
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import ContinuousBatchingScheduler as JScheduler
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import cosine_schedule as j_cosine
from repro.train.step import TrainStepConfig as JTSConfig
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.core import strategies
from repro_torch.core.fission import fission_scan, scan
from repro_torch.examples import device_fission, serve_continuous_batching
from repro_torch.examples import train_checkpoint_restart
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_arch
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.paged_kv import PagedInferenceEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

ROOT = Path(__file__).resolve().parents[1]


def _reference_example(name: str):
    """A module of the JAX package's ``examples/``, imported by file name."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _pair(name: str):
    jarch = j_get_arch(name)
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.reduced())
    jparams = jarch.init(jax.random.PRNGKey(0))
    arch = get_arch(name)
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    return jarch, jparams, arch, _port_params(jparams, arch)


def _port_params(jparams, arch):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), arch.cfg,
                             device="cpu")


@pytest.fixture(scope="module")
def llama():
    return _pair("llama3-8b")


def _streams(done) -> dict:
    return {r.rid: list(r.generated) for r in done}


def _balanced(st) -> bool:
    return st.spec_dispatched == st.spec_committed + st.spec_aborted


# ------------------------------------------------------------------ serving

@pytest.mark.parametrize("demo", ["overlap_kv_demo", "depth_spill_demo"])
def test_serving_demo_equals_reference(llama, demo):
    """The reference demo and the port's twin on the same prompts: every
    request done, greedy streams equal per ``rid``, both speculation
    ledgers balanced; the depth-2 demo chunks its oversized prompt and
    restores every lane it spilled, in both packages."""
    jarch, jparams, arch, tparams = llama
    ref = getattr(_reference_example("serve_continuous_batching"), demo)
    jdone, jst = ref(jarch, jparams, verbose=False)
    tdone, tst = getattr(serve_continuous_batching, demo)(arch, tparams, verbose=False,
                                                          device="cpu")
    assert len(tdone) == len(jdone) and all(r.done for r in tdone)
    assert _streams(tdone) == _streams(jdone)
    assert _balanced(jst) and _balanced(tst)
    if demo == "depth_spill_demo":
        for st in (jst, tst):
            assert st.spec_chunks >= 1
            assert st.kv_restored == st.kv_spilled


def test_mixed_lanes_demo_admits_homogeneous_batches(llama):
    """``main``'s lane demo: each template's prefills pin their own bucket
    (chat prompts at 8, summarize at 16), as the reference's do."""
    jarch, jparams, arch, tparams = llama
    done, sched, eng = serve_continuous_batching.mixed_lanes_demo(
        arch, tparams, np.random.default_rng(0), verbose=False, device="cpu")
    assert len(done) == 16
    assert eng.template_shapes["chat"][1] == 8 and eng.template_shapes["summarize"][1] == 16
    assert {t: sum(n for _, n in tr) for t, tr in sched.stats.lane_admissions.items()} == \
        {"chat": 8, "summarize": 8}


def _depth_traffic(n_per: int = 4, n_templates: int = 6) -> list:
    """``bench_lanes.run_overlap_depth``'s shape: single-request bets over
    six templates, generation lengths staggered over 2-8 tokens, prompts
    of 4-16 tokens and three of 20-29, longer than ``max_prompt_len`` 16
    and chunked."""
    rng = np.random.default_rng(0)
    out = []
    for j in range(n_per):
        for i in range(n_templates):
            m = int(rng.integers(4, 17))
            out.append(dict(rid=j * 100 + i, prompt=rng.integers(1, 256, size=m).astype(np.int32),
                            max_new_tokens=int(rng.integers(2, 9)), template=f"t{i}"))
    for at in (3, 10, 17):
        out[at]["prompt"] = rng.integers(1, 256, size=int(rng.integers(20, 30))).astype(np.int32)
    return out


def _depth_run(Engine, Scheduler, Req, strats, arch, params, depth: int, paged: bool,
               **kw):
    eng = Engine(arch, params, n_lanes=4, max_prompt_len=16, max_len=48,
                 **({"page_size": 8} if paged else {}), **kw)
    sched = Scheduler(eng, strategy=strats.PureAsync(), overlap=True, spec_depth=depth,
                      chunk_tokens=8)
    reqs = [Req(**t) for t in _depth_traffic()]
    for r in reqs:
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained()
    assert all(r.done for r in reqs)
    return _streams(reqs), sched.stats, eng


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_depth_sweep_streams_equal_depth_one_and_reference(llama, paged):
    """``spec_depth`` 1, 2 and 4 over the port's engine: up to k
    speculation threads alive at once, sharing the engine's prefill
    steps, staging cache and chunk steps.  Every request's greedy stream
    equals depth 1's and the JAX engine's at the same depth; no
    speculation crash; the ledger balances; the paged engine folds chunks
    into its ticks."""
    jarch, jparams, arch, tparams = llama
    port = (PagedInferenceEngine if paged else InferenceEngine, ContinuousBatchingScheduler,
            Request, strategies)
    ref = (JPagedEngine if paged else JEngine, JScheduler, JRequest, j_strategies)
    base = None
    for depth in (1, 2, 4):
        got, st, eng = _depth_run(*port, arch, tparams, depth, paged, device="cpu")
        want, jst, _je = _depth_run(*ref, jarch, jparams, depth, paged)
        base = got if base is None else base
        assert got == base and got == want, depth
        assert st.spec_crashes == 0 and _balanced(st) and _balanced(jst)
        assert st.spec_chunks >= 1
        if paged:
            assert eng.fused_folds >= 1


def test_template_shape_pin_is_raised_under_a_lock(llama):
    """Two speculation threads dispatching one template's prefills at once
    (``spec_depth > 1``): the second waits while the first reads and
    raises the pinned bucket, so the pin ends at the larger bucket.  With
    the read and the write apart, the second thread's (2, 16) was
    overwritten by the first's (1, 4)."""
    _j, _jp, arch, tparams = llama
    eng = InferenceEngine(arch, tparams, n_lanes=4, max_prompt_len=16, max_len=48,
                          device="cpu")

    class Gate(dict):
        """Holds the first reader of the pin until ``go`` is set."""

        def __init__(self):
            super().__init__()
            self.entered, self.go, self.first = threading.Event(), threading.Event(), True

        def get(self, key, default=None):
            value = super().get(key, default)
            if self.first:
                self.first = False
                self.entered.set()
                self.go.wait(10)
            return value

    eng.template_shapes = gate = Gate()
    small = Request(rid=0, prompt=np.arange(1, 4, dtype=np.int32), max_new_tokens=1)
    big = [Request(rid=i, prompt=np.arange(1, 13, dtype=np.int32), max_new_tokens=1)
           for i in (1, 2)]
    first = threading.Thread(target=eng.prefill_dispatch, args=([small], "t"))
    first.start()
    assert gate.entered.wait(10)
    second = threading.Thread(target=eng.prefill_dispatch, args=(big, "t"))
    second.start()
    second.join(0.5)
    gate.go.set()
    first.join(30)
    second.join(30)
    assert not first.is_alive() and not second.is_alive()
    assert eng.template_shapes["t"] == (2, 16)


# ----------------------------------------------------------------- training

STEPS, EVERY, RESUME = 6, 2, 2


def _jax_run(jarch, jparams, ckpt_dir):
    """The reference example's three phases with the JAX package, at
    ``STEPS`` / ``EVERY`` / ``RESUME``."""
    opt = JAdamW(lr=3e-3, schedule=j_cosine(3e-3, warmup=10, total=120))
    init_state, step = j_make_train_step(jarch, opt, JTSConfig(donate=False))
    stream = JStream(jarch.cfg.vocab_size, seq_len=32, batch=8)
    params, state, losses = jparams, init_state(jparams), []
    with JManager(ckpt_dir, keep_last=2) as mgr:
        for i, batch in enumerate(JLoader(stream, n_prefetch=4, max_steps=STEPS)):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            if (i + 1) % EVERY == 0:
                mgr.save(i + 1, params, state)
        mgr.on_preempt(STEPS, params, state)
    with JManager(ckpt_dir) as mgr2:
        step_no, params2, state2 = mgr2.restore_latest(params, state)
        resumed = []
        for batch in JLoader(stream, n_prefetch=4, start_step=step_no, max_steps=RESUME):
            params2, state2, m = step(params2, state2, batch)
            resumed.append(float(m["loss"]))
    return losses, step_no, resumed, params, state


@pytest.fixture(scope="module")
def olmo():
    return _pair("olmo-1b")


def test_train_restart_equals_reference(olmo, tmp_path):
    """``run`` against the same steps written with the JAX package: losses
    within ``make_train_step``'s tolerance, the same step resumed at; the
    first resumed loss bit for bit the uninterrupted run's (the preempted
    parameters and state continued in memory through the same compiled
    step); the port's preempted checkpoint restored by the JAX manager,
    value for value; ``STEPS / EVERY`` writes, the preemption's save of an
    already durable step writing nothing."""
    jarch, jparams, arch, tparams = olmo
    jl, jat, jres, jp, js = _jax_run(jarch, jparams, tmp_path / "jax")
    out = train_checkpoint_restart.run(arch, tparams, steps=STEPS, every=EVERY,
                                       resume=RESUME, ckpt_dir=tmp_path / "port",
                                       verbose=False)
    np.testing.assert_allclose(out["losses"], jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["resumed"], jres, rtol=1e-4, atol=1e-4)
    assert out["resumed_at"] == jat == STEPS
    assert [w["step"] for w in out["writes"]] == list(range(EVERY, STEPS + 1, EVERY))
    assert len(out["save_blocked"]) == STEPS // EVERY

    params, state, step = out["params"], out["state"], out["step"]
    twin = []
    for i in range(RESUME):
        params, state, m = step(params, state, out["stream"].batch_at(STEPS + i))
        twin.append(float(m["loss"]))
    assert twin[0] == out["resumed"][0]
    np.testing.assert_allclose(out["resumed"], twin, rtol=1e-6)

    with JManager(tmp_path / "port") as mgr:
        got_at, got_p, got_s = mgr.restore_latest(jp, js)
    assert got_at == STEPS
    want_p = dict(_flat(out["params"]))
    for path, leaf in jax.tree_util.tree_flatten_with_path(got_p)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      want_p[key].float().numpy(), err_msg=key)
    assert len(jax.tree_util.tree_leaves(got_s)) == len(list(_flat(out["state"])))


def _flat(tree, prefix: str = ""):
    """(path, tensor) pairs of a nested dict, the leaves of lists too."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ----------------------------------------------------------- device fission

def test_device_fission_equals_reference_example(capsys):
    """The JAX example's table and ids through the port's twin: the plain
    and fissioned loops within 1e-5 of ``lax.scan``, one query batched as
    in the reference, the traced program's gathers (256 per-iteration
    queries against one batched gather), and the gradient's nonzero rows
    equal to the reference example's."""
    from repro.core.fission import FissionReport as JReport
    from repro.core.fission import fission_scan as j_fission_scan
    from repro.core.query import async_query as jquery
    from repro.core.query import table_gather_spec as jspec
    from repro_torch.core.fission import FissionReport

    _reference_example("device_fission").main()
    printed = capsys.readouterr().out
    j_batched = int(re.search(r"\((\d+) query batched\)", printed).group(1))
    j_rows = int(re.search(r"nonzero rows: (\d+)", printed).group(1))

    jtable = jax.random.normal(jax.random.PRNGKey(0), (5000, 64))
    jids = (jnp.arange(256) * 37) % 5000

    def jbody(carry, i):
        row = jquery(jspec, jtable, i)
        return carry + row.sum(), row.mean()

    jref = jax.lax.scan(jbody, jnp.float32(0), jids)
    jrep = JReport()
    j_fission_scan(jbody, jnp.float32(0), jids, report=jrep)

    table = torch.from_numpy(np.array(jtable))
    ids = torch.from_numpy(np.array(jids, np.int32))
    rep = FissionReport()
    for got in (device_fission.loop(scan, table, ids),
                device_fission.loop(fission_scan, table, ids, report=rep)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(jref[0]), rtol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(jref[1]), rtol=1e-5, atol=1e-6)
    assert rep.n_queries_batched == jrep.n_queries_batched == j_batched
    assert device_fission.structure(scan, table, ids) == {"table_gather": 256,
                                                          "batched_gather": 0}
    assert device_fission.structure(fission_scan, table, ids) == {"table_gather": 0,
                                                                  "batched_gather": 1}
    g, rows = device_fission.table_grad(table, ids)
    assert rows == j_rows == len(set(np.asarray(jids).tolist()))
    assert torch.equal(torch.nonzero(g.abs().sum(-1)).flatten().sort().values,
                       ids.long().unique())

