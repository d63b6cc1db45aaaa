"""The port's distribution layer on real ranks: 4 ``gloo`` CPU processes at
mesh (data=2, model=2), spawned once for the module, and 8 at (4, 2) for
the elastic restore.

* ``make_train_step(..., mesh=)`` on reduced llama3-8b (float32,
  ``query_embedding``: the masked vocabulary-parallel gather), reduced
  deepseek-moe-16b (the expert-parallel branch inside the step) and
  reduced mamba2-1.3b (the SSD scan on each rank's heads), 2 steps:
  losses within 1e-5 and parameters within 1e-4 of the port's unsharded
  step (the same float32 arithmetic, summed over ranks in another order;
  observed 0 and 3.3e-6), llama3's losses within 1e-4 of the JAX package's
  unsharded ``make_train_step`` (the tolerance of ``test_torch_train.py``);
  ``wq``'s local shard.
* ``moe`` on reduced deepseek-moe-16b (one shared expert, replicated over
  ``model``) and reduced kimi-k2 with DTensor operands: output and aux
  within 1e-5 of the port's single-device ``moe`` and 1e-4 of the JAX
  package's, and one all-reduce over ``model`` per call.
* Rule A on the sharded step: reduced llama3-8b and deepseek-moe-16b
  (``query_embedding``), 4 microbatches, 2 steps, fissioned and not, on
  the mesh: each rank executes the gather query once a step fissioned and
  4 times not; losses within 1e-5 and parameters within 1e-4 of each
  other, losses within 1e-4 of the JAX package's unsharded fissioned
  ``make_train_step(microbatches=4)``; over 3 steps each rank traces its
  program in the first step only, and the losses equal a run that
  traces every step (the first bit for bit).
* The twin of ``test_checkpoint.py::test_elastic_restore_onto_8_devices``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.registry import get_arch as jget_arch
from repro.train import optimizer as jopt
from repro.train.step import TrainStepConfig as JTSConfig
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.launch import run_ranks
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.registry import get_arch
from repro_torch.train import optimizer as topt
from repro_torch.train.step import TrainStepConfig, make_train_step

LR = 1e-3
TIMEOUT_S = 600
STEP_ARCHS = ("llama3-8b", "deepseek-moe-16b", "mamba2-1.3b")
FISSION_ARCHS = ("llama3-8b", "deepseek-moe-16b")
MICROBATCHES = 4


def _archs(name: str, **overrides):
    ja, ta = jget_arch(name), get_arch(name)
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(ja.cfg.reduced(), **overrides))
    ta = dataclasses.replace(ta, cfg=dataclasses.replace(ta.cfg.reduced(), **overrides))
    return ja, ta


def _tokens(seed: int, b: int = 8, s: int = 16):
    t = np.random.default_rng(seed).integers(0, 256, size=(b, s)).astype(np.int32)
    return {"tokens": t, "labels": t}


def _moe_case(name: str, seed: int):
    """Numpy MoE layer weights and input x (8, 12, d) for a reduced config."""
    _ja, ta = _archs(name)
    c = ta.cfg
    rng = np.random.default_rng(seed)
    d, f, E = c.d_model, c.moe_d_ff, c.n_experts

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    p = {"router": {"w": w(d, E)},
         "experts": {"w_gate": w(E, d, f), "w_in": w(E, d, f), "w_out": w(E, f, d)}}
    if c.n_shared_experts:
        n = c.n_shared_experts
        p["shared"] = {"w_gate": w(n, d, f), "w_in": w(n, d, f), "w_out": w(n, f, d)}
    return p, rng.standard_normal((8, 12, d)).astype(np.float32)


def _steps(ta, params, batches, mesh=None, **ts_kw):
    init, step = make_train_step(ta, topt.AdamWConfig(lr=LR), TrainStepConfig(**ts_kw),
                                 mesh=mesh)
    state, losses = init(params), []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    return losses, params


def _fissioned_steps(ta, tree, batches, mesh, fission: bool):
    """The sharded step at ``MICROBATCHES`` microbatches: its losses, the
    gather query's executions in each step, and the full parameters."""
    from repro_torch.core import query
    from repro_torch.distributed.sharding import distribute_params

    calls, inner = [], query.gather_op

    def counted(*args):
        calls.append(1)
        return inner(*args)

    params = distribute_params(mesh, params_from_numpy(tree, ta.cfg, device="cpu"))
    init, step = make_train_step(ta, topt.AdamWConfig(lr=LR),
                                 TrainStepConfig(microbatches=MICROBATCHES, fission=fission),
                                 mesh=mesh)
    state, losses, gathers = init(params), [], []
    query.gather_op = counted
    try:
        for b in batches:
            calls.clear()
            params, state, m = step(params, state, b)
            gathers.append(len(calls))
            losses.append(float(m["loss"]))
    finally:
        query.gather_op = inner
    return {"losses": losses, "gathers": gathers, "params": _full_numpy(params)}


def _traced_steps(ta, tree, batches, mesh, retrace: bool):
    """The fissioned sharded step at ``MICROBATCHES`` microbatches over
    ``batches``: its losses and ``trace_body`` calls in each step;
    ``retrace`` clears ``train_step.plans`` before every step."""
    from repro_torch.core import fission
    from repro_torch.distributed.sharding import distribute_params

    calls, real = [], fission.trace_body

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    params = distribute_params(mesh, params_from_numpy(tree, ta.cfg, device="cpu"))
    init, step = make_train_step(ta, topt.AdamWConfig(lr=LR),
                                 TrainStepConfig(microbatches=MICROBATCHES, fission=True),
                                 mesh=mesh)
    state, losses, traces = init(params), [], []
    fission.trace_body = counted
    try:
        for b in batches:
            if retrace:
                step.plans.clear()
            n0 = len(calls)
            params, state, m = step(params, state, b)
            traces.append(len(calls) - n0)
            losses.append(float(m["loss"]))
    finally:
        fission.trace_body = real
    return {"losses": losses, "traces": traces}


def _full_numpy(tree):
    return {k: _full_numpy(v) if isinstance(v, dict) else v.full_tensor().numpy()
            for k, v in tree.items()}


def _worker(rank, world, np_params, batches, moe_cases):
    """One rank of the (2, 2) gloo mesh: every check's sharded half."""
    from repro_torch.distributed.sharding import distribute_params, mesh_context
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.op_cost import OpCost
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = make_test_mesh(2, 2, device_type="cpu")
    out = {}
    for name, tree in np_params.items():
        _ja, ta = _archs(name, query_embedding=True, remat=False)
        params = distribute_params(mesh, params_from_numpy(tree, ta.cfg, device="cpu"))
        out[name] = {}
        if "attn" in params["layers"]:
            wq = params["layers"]["attn"]["wq"]
            out[name] = {"wq_local": tuple(wq.to_local().shape),
                         "wq_shards": int(np.prod([mesh.size(i) for i, p in
                                                   enumerate(wq.placements)
                                                   if isinstance(p, Shard)]))}
        out[name]["losses"], params = _steps(ta, params, batches, mesh)
        full = _full_numpy(params)  # a collective: every rank takes part
        out[name]["params"] = full if rank == 0 else None
        if name in FISSION_ARCHS:
            for fission in (False, True):
                run = _fissioned_steps(ta, tree, batches, mesh, fission)
                if rank:
                    run["params"] = None
                out[name][f"microbatched_fission_{fission}"] = run
        if name == "llama3-8b":
            out[name]["traced"] = {r: _traced_steps(ta, tree, batches + [_tokens(3)], mesh, r)
                                   for r in (False, True)}
    for name, (p, x) in moe_cases.items():
        _ja, ta = _archs(name[: -len("-moe")])
        tp = distribute_params(mesh, params_from_numpy({"moe": p}, ta.cfg, device="cpu"))
        tx = distribute_tensor(torch.from_numpy(x), mesh, [Shard(0), Replicate()],
                               src_data_rank=None)
        oc = OpCost(mesh)
        with mesh_context(mesh), oc:
            y, aux = tmoe.moe(tp["moe"], ta.cfg, tx)
            y, aux = y.full_tensor(), aux.full_tensor()
        out[name] = {"y": y.numpy(), "aux": float(aux),
                     "all_reduce_model": oc.count("all-reduce", "model")}
    return out


@pytest.fixture(scope="module")
def ranks():
    np_params, batches = {}, [_tokens(1), _tokens(2)]
    for name in STEP_ARCHS:
        ja, _ta = _archs(name, query_embedding=True, remat=False)
        np_params[name] = jax.tree_util.tree_map(np.asarray, ja.init(jax.random.PRNGKey(0)))
    moe_cases = {"deepseek-moe-16b-moe": _moe_case("deepseek-moe-16b", 3),
                 "kimi-k2-1t-a32b-moe": _moe_case("kimi-k2-1t-a32b", 4)}
    results = run_ranks(_worker, 4, np_params, batches, moe_cases, timeout_s=TIMEOUT_S)
    return np_params, batches, moe_cases, results


@pytest.mark.parametrize("name", STEP_ARCHS)
def test_sharded_step_matches_unsharded(ranks, name):
    np_params, batches, _moe, results = ranks
    _ja, ta = _archs(name, query_embedding=True, remat=False)
    want_losses, want = _steps(ta, params_from_numpy(np_params[name], ta.cfg, device="cpu"),
                               batches)
    for r in results:  # every rank reports the same, global, loss
        np.testing.assert_allclose(r[name]["losses"], want_losses, rtol=0, atol=1e-5)
    got, want = results[0][name]["params"], params_to_numpy(want)

    def walk(a, b, path):
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert a[k].shape == b[k].shape, path + k
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4, err_msg=f"{path}/{k}")

    walk(got, want, "")


def test_sharded_step_matches_jax_unsharded(ranks):
    np_params, batches, _moe, results = ranks
    ja, _ta = _archs("llama3-8b", query_embedding=True, remat=False)
    init, step = jmake_train_step(ja, jopt.AdamWConfig(lr=LR), JTSConfig(donate=False))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params["llama3-8b"])
    state, losses = init(jp), []
    for b in batches:
        jp, state, m = step(jp, state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(results[0]["llama3-8b"]["losses"], losses, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", FISSION_ARCHS)
def test_fissioned_sharded_step_matches_unfissioned(ranks, name):
    """Rule A on the mesh: the fissioned microbatch loop gives the
    unfissioned one's losses (1e-5) and parameters (1e-4): the same float32
    arithmetic, the microbatches' gathers done in one."""
    results = ranks[3]
    for r in results:
        fis, plain = (r[name][f"microbatched_fission_{f}"] for f in (True, False))
        np.testing.assert_allclose(fis["losses"], plain["losses"], rtol=0, atol=1e-5)
    fis, plain = (results[0][name][f"microbatched_fission_{f}"] for f in (True, False))
    for path, a in jax.tree_util.tree_flatten_with_path(plain["params"])[0]:
        b = dict(jax.tree_util.tree_flatten_with_path(fis["params"])[0])[path]
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("name", FISSION_ARCHS)
def test_fissioned_sharded_step_gathers_once_a_step(ranks, name):
    """Each rank executes the gather query once a step fissioned (one
    ``batched_gather`` launch on the card) and once a microbatch not."""
    for r in ranks[3]:
        assert r[name]["microbatched_fission_True"]["gathers"] == [1, 1]
        assert r[name]["microbatched_fission_False"]["gathers"] == [MICROBATCHES] * 2


def test_fissioned_sharded_step_traces_once_over_three_steps(ranks):
    """Three fissioned steps on the mesh trace each rank's program in the
    first step only (its plan kept in ``train_step.plans`` under the local
    signature and placements), where a run that clears the plans traces
    as much every step; the first loss is bit for bit the re-tracing
    run's, the later ones within 1e-5."""
    for r in ranks[3]:
        cached, again = (r["llama3-8b"]["traced"][f] for f in (False, True))
        first = cached["traces"][0]
        assert first >= 1 and cached["traces"] == [first, 0, 0]
        assert again["traces"] == [first] * 3
        assert cached["losses"][0] == again["losses"][0]
        np.testing.assert_allclose(cached["losses"], again["losses"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", FISSION_ARCHS)
def test_fissioned_sharded_step_matches_jax_fissioned(ranks, name):
    """Against the JAX package's unsharded ``make_train_step`` with the
    same 4 microbatches, fissioned: losses within 1e-4."""
    np_params, batches, _moe, results = ranks
    ja, _ta = _archs(name, query_embedding=True, remat=False)
    init, step = jmake_train_step(ja, jopt.AdamWConfig(lr=LR),
                                  JTSConfig(microbatches=MICROBATCHES, fission=True,
                                            donate=False))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params[name])
    state, losses = init(jp), []
    for b in batches:
        jp, state, m = step(jp, state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    got = results[0][name]["microbatched_fission_True"]["losses"]
    np.testing.assert_allclose(got, losses, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["llama3-8b", "deepseek-moe-16b"])
def test_wq_local_shard(ranks, name):
    """wq (L, d, H, hd) = (L, 64, 4, 16): d over data, heads over model."""
    results = ranks[3]
    L = 2 if name == "llama3-8b" else 1
    for r in results:
        assert r[name]["wq_local"] == (L, 32, 2, 16)
        assert r[name]["wq_shards"] == 4


@pytest.mark.parametrize("name", ["deepseek-moe-16b-moe", "kimi-k2-1t-a32b-moe"])
def test_expert_parallel_moe_matches_single_device(ranks, name):
    _np, _b, moe_cases, results = ranks
    arch_name = name[: -len("-moe")]
    p, x = moe_cases[name]
    ja, ta = _archs(arch_name)
    tp = params_from_numpy({"moe": p}, ta.cfg, device="cpu")["moe"]
    y1, aux1 = tmoe.moe(tp, ta.cfg, torch.from_numpy(x))
    jy, jaux = jmoe.moe(jax.tree_util.tree_map(jnp.asarray, p), ja.cfg, jnp.asarray(x))
    for r in results:
        np.testing.assert_allclose(r[name]["y"], y1.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(r[name]["y"], np.asarray(jy), rtol=0, atol=1e-4)
        assert abs(r[name]["aux"] - float(aux1)) <= 1e-5
        assert abs(r[name]["aux"] - float(jaux)) <= 1e-4


@pytest.mark.parametrize("name", ["deepseek-moe-16b-moe", "kimi-k2-1t-a32b-moe"])
def test_expert_parallel_moe_holds_one_all_reduce_over_model(ranks, name):
    for r in ranks[3]:
        assert r[name]["all_reduce_model"] == 1


def _elastic_worker(rank, world, root):
    from repro_torch.launch.mesh import make_test_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    mesh = make_test_mesh(4, 2, device_type="cpu")
    like = {"w": distribute_tensor(torch.empty((16, 8)), mesh, [Shard(0), Shard(1)],
                                   src_data_rank=None)}
    with CheckpointManager(root) as mgr:
        step, params, _ = mgr.restore_latest(like)
    w = params["w"]
    return step, float(w.to_local().sum()), tuple(w.to_local().shape), w.full_tensor().numpy()


def test_elastic_restore_onto_8_ranks(tmp_path):
    w = torch.arange(128, dtype=torch.float32).reshape(16, 8)
    with CheckpointManager(tmp_path) as mgr:
        mgr.save(7, {"w": w}, blocking=True)
    res = run_ranks(_elastic_worker, 8, str(tmp_path), timeout_s=TIMEOUT_S)
    assert [r[0] for r in res] == [7] * 8
    assert all(r[2] == (4, 4) for r in res)
    assert abs(sum(r[1] for r in res) - float(w.sum())) < 1e-3
    np.testing.assert_array_equal(res[0][3], w.numpy())
