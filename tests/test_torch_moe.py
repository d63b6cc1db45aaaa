"""The port's MoE layer and MoE configs against the JAX package.

``repro_torch.models.moe`` (``_capacity``, ``_route``, ``moe``) against
``repro.models.moe`` on the same numpy weights and inputs, reduced
deepseek-moe-16b and kimi-k2-1t-a32b in float32 within ``TOL`` = 1e-4
(the two frameworks sum in another order: about 1e-6 on O(1) values),
with routes compared per token as (expert, gate, position) so that the
order ``top_k`` lists equal probabilities in does not matter.  Cases with
a capacity factor low enough that routes are dropped, and with 0, 1 and 2
shared experts.  bf16 cases state their own tolerance.  Then the two MoE
configs through both packages' engines (``test_torch_configs.engine_case``:
paged and dense, overlap + chunk, prefix sharing, spill, two KV stacks).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as j_moe
from repro.models.registry import get_arch as j_get_arch
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_arch
from test_torch_configs import MODES, engine_case, make_pair

TOL = dict(rtol=1e-4, atol=1e-4)
MOE = ["deepseek-moe-16b", "kimi-k2-1t-a32b"]


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _layer(name: str, seed: int = 0, **over):
    """(JAX cfg, port cfg, JAX moe params, port moe params) of one MoE layer
    of the reduced ``name`` with ``over`` replaced."""
    jcfg = dataclasses.replace(j_get_arch(name).cfg.reduced(), **over)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = j_moe.moe_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _x(cfg, b=3, s=16, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _routes(expert_idx, gate_vals, pos):
    """Per token, {expert: (gate, pos)}: the routes without the slot order."""
    e, g, p = (np.asarray(a) for a in (expert_idx, gate_vals, pos))
    return [[{int(e[b, s, k]): (float(g[b, s, k]), int(p[b, s, k]))
              for k in range(e.shape[2])} for s in range(e.shape[1])] for b in range(e.shape[0])]


@pytest.mark.parametrize("tokens", [1, 2, 7, 16, 64, 256, 1000, 4096])
def test_capacity_matches_reference(tokens):
    for name in MOE:
        for cf in (0.25, 1.0, 1.25, 8.0):
            for cfg in (j_get_arch(name).cfg, j_get_arch(name).cfg.reduced()):
                cfg = dataclasses.replace(cfg, capacity_factor=cf)
                c = t_moe._capacity(ModelConfig(**dataclasses.asdict(cfg)), tokens)
                assert c == j_moe._capacity(cfg, tokens)
                assert c >= 4 and c % 4 == 0
    # deepseek's 256-token prefill bucket holds 32 slots an expert; a decode
    # step (one token a row) 4.
    ds = get_arch("deepseek-moe-16b").cfg
    assert (t_moe._capacity(ds, 256), t_moe._capacity(ds, 1)) == (32, 4)


@pytest.mark.parametrize("cf", [1.25, 0.3])
@pytest.mark.parametrize("name", MOE)
def test_route_matches_reference(name, cf):
    jcfg, tcfg, jp, tp = _layer(name, capacity_factor=cf)
    x = _x(jcfg)
    C = t_moe._capacity(tcfg, x.shape[1])
    probs, e, g, p = t_moe._route(tp["router"]["w"], tcfg, torch.from_numpy(x), C)
    jprobs, je, jg, jpos = j_moe._route(jp["router"]["w"], jcfg, jnp.asarray(x), C)
    np.testing.assert_allclose(probs.numpy(), _np(jprobs), rtol=1e-5, atol=1e-6)
    got, want = _routes(e, g, p), _routes(je, jg, jpos)
    for tb, wb in zip(got, want):
        for ts, ws in zip(tb, wb):
            assert sorted(ts) == sorted(ws)
            for ex in ts:
                assert ts[ex][1] == ws[ex][1]
                assert abs(ts[ex][0] - ws[ex][0]) < 1e-5


@pytest.mark.parametrize("cf", [1.25, 0.3])
@pytest.mark.parametrize("name", MOE)
def test_moe_matches_reference(name, cf):
    """``moe``'s output and aux loss; at capacity factor 0.3 the 16-token
    rows overflow their 4 slots and routes are dropped."""
    jcfg, tcfg, jp, tp = _layer(name, capacity_factor=cf)
    x = _x(jcfg)
    y, aux = t_moe.moe(tp, tcfg, torch.from_numpy(x))
    jy, jaux = j_moe.moe(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-8)
    C = t_moe._capacity(tcfg, x.shape[1])
    _p, _e, g, pos = t_moe._route(tp["router"]["w"], tcfg, torch.from_numpy(x), C)
    drops = int((pos >= C).sum())
    assert (drops > 0) == (cf < 1)
    # dropped routes keep a zero gate and the others are not renormalised
    assert bool((g[pos >= C] == 0).all())
    if drops:
        assert float(g.sum(-1).min()) < 0.999


@pytest.mark.parametrize("n_shared", [0, 1, 2])
def test_moe_shared_experts_match_reference(n_shared):
    jcfg, tcfg, jp, tp = _layer("deepseek-moe-16b", n_shared_experts=n_shared)
    assert ("shared" in tp) == (n_shared > 0)
    if n_shared:
        assert tuple(tp["shared"]["w_gate"].shape) == (n_shared, 64, 32)
    x = _x(jcfg, seed=2)
    y, _aux = t_moe.moe(tp, tcfg, torch.from_numpy(x))
    jy, _jaux = j_moe.moe(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), _np(jy), **TOL)


@pytest.mark.parametrize("name", MOE)
def test_moe_bf16_matches_reference(name):
    """bf16 weights and compute, the router float32, against the reference
    in float32 on the same bf16-rounded weights and input (JAX's CPU backend
    has no bf16 x bf16 -> f32 product): within 2e-2 x max |y|, the rounding
    of bf16's 8-bit mantissa at the reference's cast points; a missing or
    misplaced cast, or a route lost, moves the outputs by far more."""
    jcfg, tcfg, jp, _tp = _layer(name)
    bcfg = dataclasses.replace(tcfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_numpy(tree, bcfg, device="cpu")
    assert tp["router"]["w"].dtype == torch.float32
    assert tp["experts"]["w_in"].dtype == torch.bfloat16
    rounded = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32), tree)
    rounded["router"]["w"] = jnp.asarray(tree["router"]["w"])
    x = torch.from_numpy(_x(jcfg, seed=3)).bfloat16()
    y, _aux = t_moe.moe(tp, bcfg, x)
    jy, _jaux = j_moe.moe(rounded, jcfg, jnp.asarray(x.float().numpy()))
    assert y.dtype == torch.bfloat16
    want = _np(jy)
    np.testing.assert_allclose(y.float().numpy(), want, rtol=0,
                               atol=2e-2 * float(np.abs(want).max()))


def test_moe_is_bit_repeatable_and_decode_never_drops():
    jcfg, tcfg, _jp, tp = _layer("kimi-k2-1t-a32b", capacity_factor=0.3)
    x = torch.from_numpy(_x(jcfg, b=5, s=1, seed=4))
    a, b = t_moe.moe(tp, tcfg, x)[0], t_moe.moe(tp, tcfg, x)[0]
    assert torch.equal(a, b)
    C = t_moe._capacity(tcfg, 1)
    _p, _e, _g, pos = t_moe._route(tp["router"]["w"], tcfg, x, C)
    assert C == 4 and int(pos.max()) == 0  # one token a row: every route slot 0


def test_converter_keeps_the_router_float32():
    """At bf16 ``params_from_numpy`` keeps ``moe.router.w`` (and the SSM
    float32 leaves) float32 by key, everything else bf16; the port's own
    init draws the same dtypes."""
    cfg = dataclasses.replace(get_arch("deepseek-moe-16b").cfg.reduced(),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(j_get_arch("deepseek-moe-16b").cfg.reduced(),
                               param_dtype="bfloat16", compute_dtype="bfloat16")
    jarch = dataclasses.replace(j_get_arch("deepseek-moe-16b"), cfg=jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jarch.init(jax.random.PRNGKey(0)))
    for params in (params_from_numpy(tree, cfg, device="cpu"),
                   dataclasses.replace(get_arch("deepseek-moe-16b"), cfg=cfg).init(
                       seed=0, device="cpu")):
        assert params["layers"]["moe"]["router"]["w"].dtype == torch.float32
        for key in ("experts", "shared"):
            assert params["layers"]["moe"][key]["w_out"].dtype == torch.bfloat16
        assert params["dense_layers"]["mlp"]["w_in"].dtype == torch.bfloat16
        assert params["embed"]["table"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", MOE)
def test_moe_prefill_decode_dropless(name):
    """Twin of ``tests/test_models_smoke.py::test_moe_prefill_decode_dropless``:
    at a dropless capacity factor a decode step after a prefill gives the
    training forward's logits at that position, in the port, and equal to
    the reference's within 1e-4."""
    jarch, jparams, arch, tparams, _tree = make_pair(name, capacity_factor=8.0)
    toks = np.random.default_rng(9).integers(0, 256, size=(2, 17)).astype(np.int32)
    full, _aux = arch.forward(tparams, {"tokens": torch.from_numpy(toks)})
    _last, cache = t_tf.prefill(arch.cfg, tparams, torch.from_numpy(toks[:, :16]), max_len=24)
    lg, _ = arch.decode_step(tparams, torch.from_numpy(toks[:, 16]), cache,
                             torch.full((2,), 16, dtype=torch.int32))
    np.testing.assert_allclose(lg.numpy(), full[:, 16].detach().numpy(), rtol=2e-3, atol=2e-3)
    jfull, _ = jarch.forward(jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(full[:, 16].detach().numpy(), _np(jfull[:, 16]), **TOL)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", MOE)
def test_engine_streams_and_counters_equal_reference(name, mode):
    """Both packages' engines on the MoE config: greedy streams and counters
    equal; every page move covers both KV stacks."""
    engine_case(name, mode)
