"""Every family trains: the port's ``make_train_step`` against the JAX one.

Two steps of ``make_train_step`` on reduced mamba2-1.3b (SSM), hymba-1.5b
(hybrid: the banded flash op and the mixer on one input),
deepseek-moe-16b (a dense stack, then MoE), qwen2-vl-2b (``embeds`` and
(3, B, S) M-RoPE positions whose temporal row the mask compares) and
seamless-m4t-medium (encoder-decoder), float32, from the same parameters
(drawn by the JAX package, carried across by ``params_from_numpy``) and
the same numpy batches, with ``remat`` off and on, and int8 moments on
mamba2.  The training forward of mamba2 and hymba is also held against
the reference's on its own, and the compiled step without donation
(the launcher's) over three steps, its inputs left unwritten.

Tolerances, as ``test_torch_train.py`` states and why: the forward's
logits 1e-4; losses 1e-4; parameters after two steps
``test_torch_train._assert_params_close`` (1e-4 but for the rare Adam
entry whose gradient sits near ``eps``).  MoE routes are compared per
token as (expert, gate, position), as ``test_torch_moe.py`` does: the
port's routes in each step against the reference's ``_route`` on the
same MoE input with the reference's router weights of that step.
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
from repro.train import optimizer as jopt
from repro.train.step import TrainStepConfig as JTSConfig
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.models import moe as t_moe
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.registry import get_arch
from repro_torch.train import optimizer as topt
from repro_torch.train.step import TrainStepConfig, make_train_step
from test_torch_moe import _routes
from test_torch_train import LR, _assert_params_close
from test_torch_vlm import grid_positions

FAMILIES = ["mamba2-1.3b", "hymba-1.5b", "deepseek-moe-16b", "qwen2-vl-2b",
            "seamless-m4t-medium"]


def _archs(name: str, **over):
    ja, ta = j_get_arch(name), get_arch(name)
    return (dataclasses.replace(ja, cfg=dataclasses.replace(ja.cfg.reduced(), **over)),
            dataclasses.replace(ta, cfg=dataclasses.replace(ta.cfg.reduced(), **over)))


def batch_for(cfg, seed: int, b: int = 4, s: int = 24) -> dict:
    """A numpy training batch of ``cfg``'s family: tokens; or embeddings
    with grid positions (a 4 x 4 patch grid, then text); or source frames
    and target tokens.  Labels are the tokens (the loss shifts them)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    if cfg.is_encoder_decoder:
        src = rng.standard_normal((b, 20, cfg.d_model)).astype(np.float32)
        return {"src_embeds": src, "tgt_tokens": tokens, "labels": tokens}
    if cfg.frontend != "none":
        emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        return {"embeds": emb, "positions": grid_positions(b, s), "labels": tokens}
    return {"tokens": tokens, "labels": tokens}


@pytest.mark.parametrize("name", ["mamba2-1.3b", "hymba-1.5b"])
def test_forward_matches_reference(name):
    """The training forward of an SSM and a hybrid stack (S 24 > hymba's
    reduced window of 16, so the band cuts): logits and aux."""
    ja, ta = _archs(name)
    jp = ja.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), ta.cfg, device="cpu")
    batch = batch_for(ta.cfg, 1)
    jl, jaux = ja.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, taux = ta.forward(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.dtype == torch.float32 and tl.shape == tuple(jl.shape)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert float(taux) == float(jaux) == 0.0


def _route_log(monkeypatch):
    """Record every call of the port's ``_route``: (x, router weights, C,
    expert, gate, position)."""
    calls, real = [], t_moe._route

    def logged(w, cfg, x, C):
        out = real(w, cfg, x, C)
        calls.append((x.detach().numpy().copy(), w.detach().numpy().copy(), C,
                      *(a.detach().numpy() for a in out[1:])))
        return out

    monkeypatch.setattr(t_moe, "_route", logged)
    return calls


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_reference(name, remat, monkeypatch):
    """Two steps from the same parameters and batches: losses, and every
    parameter after each step; for MoE, every step's routes."""
    ja, ta = _archs(name, remat=remat)
    jp = ja.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    batches = [batch_for(ta.cfg, 1), batch_for(ta.cfg, 2)]
    jinit, jstep = j_make_train_step(ja, jopt.AdamWConfig(lr=LR), JTSConfig(donate=False))
    tinit, tstep = make_train_step(ta, topt.AdamWConfig(lr=LR), TrainStepConfig())
    tp = params_from_numpy(tree, ta.cfg, device="cpu")
    js, ts = jinit(jp), tinit(tp)
    routes = _route_log(monkeypatch) if ta.cfg.is_moe else None
    for i, b in enumerate(batches):
        router = [np.asarray(jp["layers"]["moe"]["router"]["w"])] if routes is not None else []
        start = len(routes) if routes is not None else 0
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)
        _assert_params_close(params_to_numpy(tp), jax.tree_util.tree_map(np.asarray, jp))
        if routes is not None:
            _check_routes(ja.cfg, routes[start:], router[0])


@pytest.mark.parametrize("name", FAMILIES)
def test_compiled_step_keeping_its_inputs_matches_reference(name):
    """Three steps of the compiled step with ``donate=False`` (the
    launcher's) through its static batch buffers (tokens; float32
    embeddings with (3, B, S) positions; source frames and target tokens):
    losses and parameters against the JAX step; no tensor passed in is
    written; one step, each call a copy in."""
    ja, ta = _archs(name)
    jp = ja.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), ta.cfg, device="cpu")
    jinit, jstep = j_make_train_step(ja, jopt.AdamWConfig(lr=LR), JTSConfig(donate=False))
    tinit, tstep = make_train_step(ta, topt.AdamWConfig(lr=LR), TrainStepConfig(donate=False))
    js, ts = jinit(jp), tinit(tp)
    for seed in (1, 2, 3):
        b = batch_for(ta.cfg, seed)
        given = [t.clone() for t in _flat_tensors((tp, ts))]
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        new_p, new_s, tm = tstep(tp, ts, b)
        assert all(torch.equal(a, c) for a, c in zip(_flat_tensors((tp, ts)), given))
        tp, ts = new_p, new_s
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)
        _assert_params_close(params_to_numpy(tp), jax.tree_util.tree_map(np.asarray, jp))
    assert tstep.copies_in == 3 and len(tstep.cache.steps) == 1


def _flat_tensors(tree) -> list:
    return torch.utils._pytree.tree_leaves(tree)


def _check_routes(jcfg, calls, jrouter) -> None:
    """Each of the step's forward ``_route`` calls (one a MoE layer, and
    ``remat``'s recomputes) against the reference's on the same input,
    with the reference's router weights of that step, layer by layer."""
    n_moe = jcfg.n_layers - jcfg.first_dense_layers
    assert len(calls) in (n_moe, 2 * n_moe)
    for k, (x, _w, C, e, g, p) in enumerate(calls):
        je = j_moe._route(jnp.asarray(jrouter[k % n_moe]), jcfg, jnp.asarray(x), C)
        got, want = _routes(e, g, p), _routes(*je[1:])
        for row_got, row_want in zip(got, want):
            for tok_got, tok_want in zip(row_got, row_want):
                assert tok_got.keys() == tok_want.keys()
                for ex in tok_got:
                    assert tok_got[ex][1] == tok_want[ex][1]
                    np.testing.assert_allclose(tok_got[ex][0], tok_want[ex][0],
                                               rtol=1e-4, atol=1e-5)


def test_int8_moments_train_step_matches_reference():
    """mamba2 with block-quantized int8 AdamW moments, two steps."""
    ja, ta = _archs("mamba2-1.3b")
    jp = ja.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), ta.cfg, device="cpu")
    jinit, jstep = j_make_train_step(ja, jopt.AdamWConfig(lr=LR, moments_dtype="int8"),
                                     JTSConfig(donate=False))
    tinit, tstep = make_train_step(ta, topt.AdamWConfig(lr=LR, moments_dtype="int8"),
                                   TrainStepConfig())
    js, ts = jinit(jp), tinit(tp)
    for seed in (1, 2):
        b = batch_for(ta.cfg, seed)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)
    _assert_params_close(params_to_numpy(tp), jax.tree_util.tree_map(np.asarray, jp))
