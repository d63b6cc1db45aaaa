"""The gradient of the SSD scan and of the Mamba-2 mixer against ``jax.grad``.

``ssd_scan_bwd_ref`` (the ``ssd_scan_bwd`` op's plain version) against
``jax.vjp`` of the reference's inter-chunk scan
(``repro.kernels.ssd_scan.ref.ssd_scan_ref``, the ``lax.scan`` that
``repro.models.ssm.ssd_chunked`` runs) and against autograd of the port's
``ssd_scan_ref``, with and without ``g_final`` and ``initial_state``; the
``ssd_scan`` custom op's backward on the CPU equal to the plain adjoint;
then the gradients of ``ssd_chunked`` and of one mixer layer
(``ssm_forward``, reduced mamba2-1.3b, float32) against ``jax.grad`` of
the reference's, with respect to the input and every weight.

Tolerances: ``d_states`` and ``d_initial`` 1e-6 (the same float32
multiply and add per chunk; XLA may contract them into one FMA, a last-bit
difference); ``d_decay`` 1e-5 relative (a float32 sum over P x N products
in another order); the SSD core and the mixer 1e-4, the forward's
(einsums and chunked exponentials summed in another order), relative to
the largest entry of each gradient, whose scale grows with the sequence.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_ssd_scan_ref
from repro.models import ssm as j_ssm
from repro.models.registry import get_arch as j_get_arch
from repro_torch.kernels import registry
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref
from repro_torch.models import ssm as t_ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_arch

EXACT = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scan_case(shape, seed: int):
    """states, decay in (0, 1), initial state, and the cotangents of prev
    and final, drawn with numpy."""
    rng = np.random.default_rng(seed)
    b, c, h, p, n = shape
    f32 = np.float32
    return dict(states=rng.standard_normal(shape, dtype=f32),
                decay=(1 / (1 + np.exp(-rng.standard_normal((b, c, h))))).astype(f32),
                initial=rng.standard_normal((b, h, p, n), dtype=f32),
                g_prev=rng.standard_normal(shape, dtype=f32),
                g_final=rng.standard_normal((b, h, p, n), dtype=f32))


def _close_scaled(got, want, rtol):
    """Within ``rtol`` of the largest entry of ``want``."""
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("with_initial", [False, True])
@pytest.mark.parametrize("with_g_final", [False, True])
@pytest.mark.parametrize("shape", [(2, 5, 3, 4, 8), (1, 1, 2, 3, 5), (2, 8, 4, 16, 32)])
def test_scan_adjoint_matches_jax_vjp_and_autograd(shape, with_g_final, with_initial):
    """The plain adjoint from (g_prev, g_final, prev, decay) against the
    reference scan's ``jax.vjp`` and against autograd of ``ssd_scan_ref``;
    a missing ``g_final`` is zeros."""
    d = _scan_case(shape, seed=sum(shape) + 2 * with_g_final + with_initial)
    g_final = d["g_final"] if with_g_final else np.zeros_like(d["g_final"])
    init = d["initial"] if with_initial else None
    prev, _final = ssd_scan_ref(_t(d["states"]), _t(d["decay"]),
                                None if init is None else _t(init))
    d_states, d_decay, d_initial = ssd_scan_bwd_ref(
        _t(d["g_prev"]), _t(g_final) if with_g_final else None, prev, _t(d["decay"]))
    assert d_states.dtype == d_decay.dtype == d_initial.dtype == torch.float32

    jinit = jnp.zeros(g_final.shape, jnp.float32) if init is None else jnp.asarray(init)
    _out, vjp = jax.vjp(j_ssd_scan_ref, jnp.asarray(d["states"]), jnp.asarray(d["decay"]),
                        jinit)
    js, jd, ji = vjp((jnp.asarray(d["g_prev"]), jnp.asarray(g_final)))
    np.testing.assert_allclose(d_states.numpy(), np.asarray(js), **EXACT)
    np.testing.assert_allclose(d_initial.numpy(), np.asarray(ji), **EXACT)
    _close_scaled(d_decay.numpy(), jd, 1e-5)

    leaves = [_t(d["states"]).requires_grad_(), _t(d["decay"]).requires_grad_(),
              _t(init if init is not None else np.zeros_like(g_final)).requires_grad_()]
    aprev, afinal = ssd_scan_ref(*leaves)
    ag = torch.autograd.grad((aprev, afinal), leaves, (_t(d["g_prev"]), _t(g_final)))
    torch.testing.assert_close(d_states, ag[0], **EXACT)
    torch.testing.assert_close(d_initial, ag[2], **EXACT)
    _close_scaled(d_decay.numpy(), ag[1].numpy(), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_initial", [False, True])
def test_scan_op_backward_is_the_plain_adjoint(with_initial, dtype):
    """The ``ssd_scan`` custom op's gradient on the CPU is exactly
    ``ssd_scan_bwd_ref`` of the op's cotangents (bf16 states: the
    gradient comes back in bf16), its final state read or not, and it
    counts no launch."""
    d = _scan_case((2, 6, 3, 4, 8), seed=3)
    for read_final in (False, True):
        states = _t(d["states"]).to(dtype).requires_grad_()
        decay = _t(d["decay"]).requires_grad_()
        init = _t(d["initial"]).requires_grad_() if with_initial else None
        registry.reset_launches()
        prev, final = ssd_scan_op(states, decay, init)
        outs, cots = [prev], [_t(d["g_prev"])]
        if read_final:
            outs.append(final)
            cots.append(_t(d["g_final"]))
        inputs = [states, decay] + ([init] if with_initial else [])
        got = torch.autograd.grad(outs, inputs, cots)
        want = ssd_scan_bwd_ref(cots[0], cots[1] if read_final else None, prev.detach(),
                                decay.detach())
        assert got[0].dtype == dtype
        torch.testing.assert_close(got[0], want[0].to(dtype), rtol=0, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
        if with_initial:
            torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
        assert registry.launch_counts() == {n: 0 for n in registry.names()}


def _ssd_inputs(b, l, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, p), dtype=np.float32),
            np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32),
            -np.linspace(1.0, 16.0, h).astype(np.float32),
            rng.standard_normal((b, l, n), dtype=np.float32),
            rng.standard_normal((b, l, n), dtype=np.float32))


@pytest.mark.parametrize("l", [5, 16, 21])
def test_ssd_chunked_gradient_matches_jax_grad(l):
    """chunk 8: one chunk, two, and a ragged three; the cotangent of y
    drawn with numpy, the final state read too."""
    args = _ssd_inputs(2, l, 4, 8, 8, seed=l)
    rng = np.random.default_rng(100 + l)
    up = rng.standard_normal((2, l, 4, 8), dtype=np.float32)
    up_f = rng.standard_normal((2, 4, 8, 8), dtype=np.float32)

    def jloss(*a):
        y, f = j_ssm.ssd_chunked(*a, chunk=8)
        return jnp.sum(y * up) + jnp.sum(f * up_f)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    leaves = [_t(a).requires_grad_() for a in args]
    y, f = t_ssm.ssd_chunked(*leaves, chunk=8)
    got = torch.autograd.grad((y * _t(up)).sum() + (f * _t(up_f)).sum(), leaves)
    for g, w in zip(got, want):
        _close_scaled(g.numpy(), w, 1e-4)


@pytest.fixture(scope="module")
def mixer():
    jarch = j_get_arch("mamba2-1.3b")
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.reduced())
    jparams = jarch.init(jax.random.PRNGKey(0))
    arch = get_arch("mamba2-1.3b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"]["ssm"])
    tp = params_from_numpy(tree, arch.cfg, device="cpu")["layers"]["ssm"]
    return jarch.cfg, jp, arch.cfg, {k: v[1] for k, v in tp.items()}


@pytest.mark.parametrize("S", [3, 16, 21])
def test_ssm_forward_gradient_matches_jax_grad(mixer, S):
    """One mixer layer's gradient with respect to its input and each of
    its eight weights (``in_proj``, ``conv_w``/``conv_b``, ``A_log``,
    ``D``, ``dt_bias``, ``norm_w``, ``out_proj``)."""
    jcfg, jp, cfg, tp = mixer
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    up = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    names = sorted(jp)

    def jloss(w, xx):
        return jnp.sum(j_ssm.ssm_forward(w, jcfg, xx) * up)

    jw, jx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tw = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    tx = _t(x).requires_grad_()
    out = t_ssm.ssm_forward(tw, cfg, tx)
    got = torch.autograd.grad((out * _t(up)).sum(), [tw[k] for k in names] + [tx])
    for k, g in zip(names + ["x"], got):
        want = jx if k == "x" else jw[k]
        assert tuple(g.shape) == tuple(want.shape), k
        _close_scaled(g.numpy(), want, 1e-4)


def test_traced_train_body_keeps_the_scan_and_its_adjoint_as_nodes():
    """Traced for fission (``make_fx``, fake tensors), a reduced mamba2
    microbatch's forward and backward hold the ``ssd_scan`` op and its
    adjoint as one node each a layer, so a fissioned step launches both
    kernels instead of freezing their outputs; the fissioned step's loss
    equals the unfissioned one's."""
    from repro_torch.core import fission as fission_mod
    from repro_torch.train import step as step_mod
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    arch = get_arch("mamba2-1.3b")
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg.reduced(),
                                                             query_embedding=True))
    params = arch.init(seed=0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, 256, (4, 16)).astype(np.int32)
    loss_fn = step_mod.make_loss_fn(arch)
    mb = {k: _t(tokens).reshape(2, 2, 16) for k in ("tokens", "labels")}

    def body(c, x):
        (loss, _m), _g = step_mod._value_and_grad(loss_fn, params, x)
        return c + loss, None

    gm = fission_mod.trace_body(body, torch.zeros(()), mb).gm
    targets = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    n = arch.cfg.n_layers
    assert targets.count("repro_torch.ssd_scan.default") == n
    assert targets.count("repro_torch.ssd_scan_bwd.default") == n
    losses = []
    for fission in (False, True):
        init, step = make_train_step(arch, AdamWConfig(lr=1e-3),
                                     TrainStepConfig(microbatches=2, fission=fission,
                                                     donate=False))
        losses.append(float(step(params, init(params), {"tokens": tokens,
                                                        "labels": tokens})[2]["loss"]))
    assert losses[0] == losses[1]
