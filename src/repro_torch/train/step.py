"""Train-step builder: loss, microbatched gradient accumulation, gradient
compression.

Port of :mod:`repro.train.step`.  The microbatch loop is a
:func:`~repro_torch.core.fission.scan`, and when ``cfg.query_embedding``
is on, each microbatch's embedding gather inside it is a *query*:
:func:`~repro_torch.core.fission.fission_scan` pulls them out into one
batched gather, the paper's Rule A on device code, so a step launches the
``batched_gather`` kernel once instead of once per microbatch.
``TrainStepConfig.fission`` switches between the per-iteration form and
the fissioned one.

The loss and gradients are taken with ``torch.autograd.grad`` under
``torch.enable_grad()`` inside the scanned body (the reference's
``jax.value_and_grad``), so the fission pass traces the forward and the
backward of a microbatch as one graph.

Gradient compression: optional int8 quantization with error feedback
before the optimizer (EF-SGD lineage, 1-bit Adam [arXiv:2102.02888]); the
residual is carried in the step state.  Distribution (``mesh=``) is not
ported yet.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.fission import scan_with_queries
from repro_torch.models.registry import Arch
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["cross_entropy", "make_loss_fn", "make_train_step", "TrainStepConfig"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE in float32.  logits (B, S, V), labels (B, S) integer."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def make_loss_fn(arch: Arch):
    def loss_fn(params, batch):
        logits, aux = arch.forward(params, batch)
        labels = arch.labels_of(batch)
        # next-token prediction: shift by one
        ce = cross_entropy(logits[:, :-1], labels[:, 1:])
        return ce + aux, {"ce": ce, "aux": aux}

    return loss_fn


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    grad_compression: str = "none"  # none | int8_ef
    fission: bool = True  # apply device Rule A to the microbatch scan
    donate: bool = True  # the step may write into the params and state passed in


def _quant_int8_ef(g: torch.Tensor, residual: torch.Tensor):
    """int8 quantize with error feedback.  Returns (deq, new_residual)."""
    gf = g.float() + residual
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.to(g.dtype), gf - deq


def _value_and_grad(loss_fn, params: dict, batch: dict):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: → ((loss, metrics),
    grads with the structure of ``params``), all detached."""
    leaves, tdef = pytree.tree_flatten(params)
    with torch.enable_grad():
        ps = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = loss_fn(pytree.tree_unflatten(ps, tdef), batch)
        grads = torch.autograd.grad(loss, ps)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), pytree.tree_unflatten(list(grads), tdef)


def make_train_step(arch: Arch, opt_cfg: AdamWConfig,
                    ts_cfg: TrainStepConfig = TrainStepConfig(), mesh=None):
    """Returns ``(init_state_fn, train_step_fn)``.

    ``train_step(params, state, batch) -> (new_params, new_state,
    metrics)``; ``batch`` holds numpy arrays or tensors, moved to the
    parameters' device.  With ``ts_cfg.donate`` the new parameters and
    moments are written into the tensors passed in (returned as well);
    without it nothing passed in is written.
    """
    if mesh is not None:
        raise NotImplementedError("the sharded train step (mesh=) is not ported yet")
    loss_fn = make_loss_fn(arch)
    n = ts_cfg.microbatches

    def init_state(params):
        state = {"opt": adamw_init(opt_cfg, params)}
        if ts_cfg.grad_compression == "int8_ef":
            state["ef"] = pytree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        return state

    def compute_grads(params, batch):
        if n <= 1:
            (loss, metrics), grads = _value_and_grad(loss_fn, params, batch)
            return loss, metrics, grads

        def split(x):
            b = x.shape[0]
            if x.dim() >= 1 and b % n == 0:
                return x.reshape((n, b // n) + tuple(x.shape[1:]))
            return x.expand((n,) + tuple(x.shape))

        mbatch = {k: split(v) for k, v in batch.items()}
        zero_g = pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)

        def body(carry, mb):
            acc, loss_acc = carry
            (loss, metrics), grads = _value_and_grad(loss_fn, params, mb)
            acc = pytree.tree_map(lambda a, g: a + g.float() / n, acc, grads)
            return (acc, loss_acc + loss / n), metrics

        loss0 = torch.zeros((), dtype=torch.float32, device=_device_of(zero_g))
        (grads, loss), metricss = scan_with_queries(
            body, (zero_g, loss0), mbatch, fission=ts_cfg.fission)
        metrics = {k: m[-1] for k, m in metricss.items()}
        return loss, metrics, grads

    def train_step(params, state, batch):
        device = _device_of(params)
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        loss, metrics, grads = compute_grads(params, batch)
        new_ef = None
        if ts_cfg.grad_compression == "int8_ef":
            flat_g, tdef = pytree.tree_flatten(grads)
            flat_e = pytree.tree_leaves(state["ef"])
            out = [_quant_int8_ef(g, e) for g, e in zip(flat_g, flat_e)]
            grads = pytree.tree_unflatten([o[0] for o in out], tdef)
            new_ef = pytree.tree_unflatten([o[1] for o in out], tdef)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, grads, state["opt"], params, inplace=ts_cfg.donate)
        new_state = {"opt": new_opt}
        if new_ef is not None:
            new_state["ef"] = new_ef
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return new_params, new_state, metrics

    return init_state, train_step


def _device_of(tree) -> torch.device:
    """The device of a tree's first leaf."""
    return pytree.tree_leaves(tree)[0].device
