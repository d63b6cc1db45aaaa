"""The port's trainer against the JAX package, on the CPU.

Optimizer, clipping and schedule on the same numpy trees; cross entropy;
the synthetic stream bit for bit; the prefetch loader; the training
forward; the bf16 head's gradient; and ``make_train_step`` on reduced
llama3-8b (float32, ``query_embedding=True``, ``remat=False``) with
parameters carried across by ``params_from_numpy``.

Tolerances: optimizer steps on float32 trees 1e-6 (the same float32
arithmetic, constants rounded alike); the bf16 head's gradient one bf16
ulp (2^-7 relative: the float32 sums run in another order and can round
the other way); the train step 1e-4 on losses, as the reference's own
fission test (observed 5e-7).  Parameters after 2 steps, leaf by leaf:
1e-4 for all but max(1, 0.1 %) of a leaf's entries and for every entry
of a norm gain, and 2 x ``lr`` for every entry.  Adam's step is
about ``lr * sign(g)`` whatever the gradient's size, so an entry whose
gradient is near ``eps`` (or, with ``int8_ef``, on a rounding boundary of
the int8 grid) moves differently on a float32 difference of 1e-7 in its
gradient (observed: one of 8192 ``wo`` entries at 1.3e-4 without
compression, others below 4.3e-5).
"""
from __future__ import annotations

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLMStream as JStream
from repro.models import transformer as jtf
from repro.models.registry import get_arch as jget_arch
from repro.train import optimizer as jopt
from repro.train.step import TrainStepConfig as JTSConfig
from repro.train.step import cross_entropy as jcross_entropy
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.core import fission as fission_mod
from repro_torch.data.pipeline import PrefetchLoader, SyntheticLMStream
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.registry import get_arch
from repro_torch.train import optimizer as topt
from repro_torch.train import step as step_mod
from repro_torch.train.step import TrainStepConfig, cross_entropy, make_train_step

LR = 1e-3


def _np_tree(seed: int, shapes: dict) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


SHAPES = {"w": (37, 19), "b": (70,), "s": (3, 5, 130)}


# -------------------------------------------------------------- optimizer

@pytest.mark.parametrize("moments", ["float32", "int8"])
@pytest.mark.parametrize("inplace", [False, True])
def test_adamw_update_matches_reference(moments, inplace):
    """Five AdamW steps on the same parameters and gradients, weight decay
    and clipping on: parameters and (dequantized) moments as the
    reference's."""
    params, kw = _np_tree(0, SHAPES), dict(lr=0.05, moments_dtype=moments, clip_norm=1.0)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _t(params)
    js, ts = jopt.adamw_init(jcfg, jp), topt.adamw_init(tcfg, tp)
    for i in range(5):
        grads = _np_tree(10 + i, SHAPES)
        jp, js, jm = jopt.adamw_update(jcfg, {k: jnp.asarray(v) for k, v in grads.items()},
                                       js, jp)
        tp, ts, tm = topt.adamw_update(tcfg, _t(grads), ts, tp, inplace=inplace)
    assert int(ts["step"]) == int(js["step"]) == 5
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
        for mom in ("m", "v"):
            jmu, tmu = js["mu"][k][mom], ts["mu"][k][mom]
            if moments == "int8":
                # one int8 step of the block's scale: a value on a rounding
                # boundary may round the other way
                step = float(np.asarray(jmu.scale).max())
                jmu, tmu = jopt._dequantize(jmu), topt._dequantize(tmu)
                np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=0,
                                           atol=2 * step * (step if mom == "v" else 1) + 1e-6)
            else:
                np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=1e-6, atol=1e-7)


def test_quantize_roundtrip_matches_reference():
    x = np.random.default_rng(0).standard_normal((37, 19), dtype=np.float32) * 3
    for signed in (True, False):
        ref = jopt._dequantize(jopt._quantize(jnp.asarray(x), signed=signed))
        got = topt._dequantize(topt._quantize(torch.from_numpy(x), signed=signed))
        assert got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_clip_and_schedule_match_reference():
    g = _np_tree(3, SHAPES)
    g["b"] *= 10
    jc, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    tc, tn = topt.clip_by_global_norm(_t(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert float(topt.global_norm(tc)) <= 1.0 + 1e-5
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-6, atol=1e-7)
    js, ts = jopt.cosine_schedule(1e-3, 10, 100), topt.cosine_schedule(1e-3, 10, 100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(ts(torch.tensor(s, dtype=torch.int32))),
                                   float(js(jnp.int32(s))), rtol=1e-6, atol=1e-12)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11), dtype=np.float32) * 3
    labels = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    want = float(jcross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("shard", [0, 1])
def test_synthetic_stream_is_the_reference_stream(shard):
    kw = dict(vocab_size=128256, seq_len=64, batch=4, seed=3, shard=shard, n_shards=2)
    ref, port = JStream(**kw), SyntheticLMStream(**kw)
    for step in (0, 1, 17):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_prefetch_loader_order_and_resume():
    """Batches arrive in step order; a loader started at step 5 resumes the
    stream exactly there (the restart path); ``stop`` ends a loader that
    has no step limit."""
    stream = SyntheticLMStream(100, seq_len=8, batch=2, seed=1)
    got = list(PrefetchLoader(stream, n_prefetch=2, start_step=5, max_steps=4))
    assert len(got) == 4
    for k, b in enumerate(got):
        assert np.array_equal(b["tokens"], stream.batch_at(5 + k)["tokens"])
    loader = PrefetchLoader(stream, n_prefetch=1)
    it = iter(loader)
    assert np.array_equal(next(it)["tokens"], stream.batch_at(0)["tokens"])
    loader.stop()
    loader._thread.join(timeout=10)
    assert not loader._thread.is_alive()


# ------------------------------------------------------------- the model

def _archs(**overrides):
    """(reference arch, port arch) of reduced llama3-8b, with overrides."""
    ja, ta = jget_arch("llama3-8b"), get_arch("llama3-8b")
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(ja.cfg.reduced(), **overrides))
    ta = dataclasses.replace(ta, cfg=dataclasses.replace(ta.cfg.reduced(), **overrides))
    return ja, ta


def _tokens(seed: int, b: int = 8, s: int = 16):
    t = np.random.default_rng(seed).integers(0, 256, size=(b, s)).astype(np.int32)
    return {"tokens": t, "labels": t}


@pytest.mark.parametrize("query_embedding", [False, True])
def test_forward_matches_reference(query_embedding):
    ja, ta = _archs(query_embedding=query_embedding, remat=False)
    jp = ja.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), ta.cfg, device="cpu")
    batch = _tokens(1)
    jl, jaux = ja.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, taux = ta.forward(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.dtype == torch.float32 and tl.shape == tuple(jl.shape)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert float(taux) == float(jaux) == 0.0


def test_forward_refuses_families_not_ported():
    for name in ("mamba2-1.3b",):
        arch = get_arch(name)
        arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
        with pytest.raises(NotImplementedError):
            arch.forward(arch.init(seed=0, device="cpu"),
                         {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def test_head_bf16_gradient_matches_reference():
    """The bf16 head's gradient on the CPU equals ``jax.grad`` of the
    reference's ``_head``: float32 products of the float32 cotangent with
    the operands, each rounded once to bf16."""
    cfg_j = dataclasses.replace(jget_arch("llama3-8b").cfg.reduced(),
                                param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg_t = dataclasses.replace(get_arch("llama3-8b").cfg.reduced(),
                                param_dtype="bfloat16", compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 64), dtype=np.float32)
    w = rng.standard_normal((64, 256), dtype=np.float32) * 0.1
    up = rng.standard_normal((2, 3, 256), dtype=np.float32)
    jx, jw = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(
        jtf._head(cfg_j, {"lm_head": {"w": b}}, a) * jnp.asarray(up)), argnums=(0, 1))(jx, jw)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).bfloat16().requires_grad_()
    out = transformer._head(cfg_t, {"lm_head": {"w": tw}}, tx)
    tgx, tgw = torch.autograd.grad(out, (tx, tw), torch.from_numpy(up))
    for got, want in ((tgx, jgx), (tgw, jgw)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2.0 ** -7, atol=0)


# ------------------------------------------------------------ train step

def _run_reference(ja, jp, ts_kw: dict, batches):
    init, step = jmake_train_step(ja, jopt.AdamWConfig(lr=LR), JTSConfig(donate=False, **ts_kw))
    state, losses = init(jp), []
    for b in batches:
        jp, state, m = step(jp, state, b)
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, jp)


def _run_port(ta, np_params, ts_kw: dict, batches):
    params = params_from_numpy(np_params, ta.cfg, device="cpu")
    init, step = make_train_step(ta, topt.AdamWConfig(lr=LR), TrainStepConfig(**ts_kw))
    state, losses = init(params), []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    return losses, params_to_numpy(params)


@pytest.fixture(scope="module")
def reduced():
    ja, ta = _archs(query_embedding=True, remat=False)
    jp = ja.init(jax.random.PRNGKey(0))
    return ja, ta, jp, jax.tree_util.tree_map(np.asarray, jp), [_tokens(1), _tokens(2)]


def _assert_params_close(got: dict, want: dict):
    """Leaf by leaf: every entry within 2 x ``lr``; above 1e-4 at most
    max(1, 0.1 %) of a leaf's entries, and none of a norm gain's, whose
    gradients are never near ``eps``."""
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        name = jax.tree_util.keystr(path)
        d = np.abs(a - b)
        gain = re.search(r"norm|\['ln\d'\]", name) is not None
        allowed = 0 if gain else max(1, d.size // 1000)
        assert d.max() <= 2 * LR and int((d > 1e-4).sum()) <= allowed, (
            name, float(d.max()), int((d > 1e-4).sum()), allowed)


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
@pytest.mark.parametrize("fission_on", [False, True])
@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_reference(reduced, microbatches, fission_on, compression):
    """Two steps of the port's ``make_train_step`` against the JAX one from
    the same parameters and batches: losses and parameters."""
    ja, ta, jp, np_params, batches = reduced
    ts_kw = dict(microbatches=microbatches, fission=fission_on, grad_compression=compression)
    jl, jparams = _run_reference(ja, jp, ts_kw, batches)
    tl, tparams = _run_port(ta, np_params, ts_kw, batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    _assert_params_close(tparams, jparams)


def test_microbatch_fission_equals_plain(reduced):
    """Within the port, the fissioned microbatch loop gives the
    unfissioned one's losses and parameters (the twin of the reference's
    ``test_microbatch_fission_equals_plain``), and batches the one query."""
    _ja, ta, _jp, np_params, batches = reduced
    reports = []

    def reported(f, init, xs, *, fission=True, length=None):
        assert fission
        rep = fission_mod.FissionReport()
        reports.append(rep)
        return fission_mod.fission_scan(f, init, xs, length=length, report=rep)

    out = {}
    for fission_on in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if fission_on:
                mp.setattr(step_mod, "scan_with_queries", reported)
            out[fission_on] = _run_port(ta, np_params, dict(microbatches=4,
                                                             fission=fission_on), batches)
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-4, atol=1e-4)
    _assert_params_close(out[True][1], out[False][1])
    assert [(r.n_queries_found, r.n_queries_batched) for r in reports] == [(1, 1)] * 2


def test_remat_under_fission_equals_plain(reduced):
    """``cfg.remat`` (``torch.utils.checkpoint`` around each block) traces
    under fission and changes no number."""
    _ja, ta, _jp, np_params, batches = reduced
    ta_remat = dataclasses.replace(ta, cfg=dataclasses.replace(ta.cfg, remat=True))
    ts_kw = dict(microbatches=4, fission=True)
    want = _run_port(ta, np_params, ts_kw, batches)
    got = _run_port(ta_remat, np_params, ts_kw, batches)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    _assert_params_close(got[1], want[1])


def test_train_body_holds_no_frozen_activation(reduced):
    """Traced for fission, a microbatch's forward and backward keep every
    op in the graph: each constant is a parameter (by storage) or small,
    never an activation frozen by a launch the tracer did not see, and the
    embedding and attention ops are nodes."""
    _ja, ta, _jp, np_params, _b = reduced
    params = params_from_numpy(np_params, ta.cfg, device="cpu")
    loss_fn = step_mod.make_loss_fn(ta)
    mb = {k: torch.from_numpy(v).reshape(4, 2, 16) for k, v in _tokens(1).items()}

    def body(c, x):
        (loss, _m), _g = step_mod._value_and_grad(loss_fn, params, x)
        return c + loss, None

    gm = fission_mod.trace_body(body, torch.zeros(()), mb).gm
    ptrs = {p.data_ptr() for p in _leaves(params)}
    for n in gm.graph.nodes:
        if n.op == "get_attr":
            c = getattr(gm, n.target)
            assert c.data_ptr() in ptrs or c.numel() <= 16, (n.target, tuple(c.shape))
    targets = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    assert targets.count("repro_torch.table_gather.default") == 1
    assert targets.count("repro_torch.flash_attention.default") == ta.cfg.n_layers


def test_donate_writes_in_place_and_only_then(reduced):
    _ja, ta, _jp, np_params, batches = reduced
    for donate in (False, True):
        params = params_from_numpy(np_params, ta.cfg, device="cpu")
        before = {id(p): p.clone() for p in _leaves(params)}
        init, step = make_train_step(ta, topt.AdamWConfig(lr=LR),
                                     TrainStepConfig(microbatches=2, donate=donate))
        new, _state, _m = step(params, init(params), batches[0])
        changed = [not torch.equal(p, before[id(p)]) for p in _leaves(params)]
        assert all(changed) if donate else not any(changed)
        assert (new is params) == donate


def test_mesh_is_not_ported():
    _ja, ta = _archs()
    with pytest.raises(NotImplementedError):
        make_train_step(ta, topt.AdamWConfig(), mesh=object())


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])
