"""Train-step builder: loss, microbatched gradient accumulation, gradient
compression, and the whole step compiled once per batch signature.

Port of :mod:`repro.train.step`.  The microbatch loop is a
:func:`~repro_torch.core.fission.scan`, and when ``cfg.query_embedding``
is on, each microbatch's embedding gather inside it is a *query*:
:func:`~repro_torch.core.fission.fission_scan` pulls them out into one
batched gather, the paper's Rule A on device code, so a step launches the
``batched_gather`` kernel once instead of once per microbatch.
``TrainStepConfig.fission`` switches between the per-iteration form and
the fissioned one.  The loop body takes the parameters as its third
argument (``consts``), so they enter the traced graph as inputs and not as
constants, and the step keeps its fission plans (``train_step.plans``, a
dict; :mod:`repro_torch.core.fission`): the body is traced once per batch
shape, as the reference's ``jax.jit`` traces it once per compile, on one
device and on a mesh alike.

The loss and gradients are taken with ``torch.autograd.grad`` under
``torch.enable_grad()`` inside the scanned body (the reference's
``jax.value_and_grad``), so the fission pass traces the forward and the
backward of a microbatch as one graph.

Gradient compression: optional int8 quantization with error feedback
before the optimizer (EF-SGD lineage, 1-bit Adam [arXiv:2102.02888]); the
residual is carried in the step state.

**The compiled step** (``mesh=None``; the reference's
``jax.jit(train_step, donate_argnums=(0, 1))``).  The step keeps a
:class:`~repro_torch.serving.graphs.StepCache` keyed by the batch's
signature (its leaves' names, shapes and dtypes, and ``microbatches``):
one :class:`~repro_torch.serving.graphs.CompiledStep` per signature over
static batch buffers (int32, float32 or int64 leaves), which the host
fills before each call (a host-to-device copy cannot be recorded), and
over parameters and moments at fixed addresses.  The step's function is
the whole step: the split into microbatches, the fissioned producer (one
``batched_gather``) and consumer loop or the per-iteration scan, each
microbatch's forward and ``torch.autograd.grad``, the float32
accumulation, ``int8_ef``, clipping and AdamW (the schedule and the step
count on the device), with the metrics as its outputs.  On the card its
first call runs it (and traces the fission plan) and records it as one
CUDA graph; every later call is one replay.  ``graphs.eager()`` runs the
same step op by op; on the CPU it always runs so.  The recording empties
the allocator's cache first, so the first call's freed temporaries do
not stay reserved beside the graph's pool.

* ``donate=True``: the step writes the new parameters and moments into
  the tensors of its first call, and returns them.  A later call with
  other tensors (a restore, a caller's copy) copies them into those
  first; ``train_step.copies_in`` counts such calls.  A call with the
  tensors the step returned copies nothing.
* ``donate=False`` (the launcher's, as the reference's): no tensor passed
  in is written, and what a call returns is the caller's for good.  The
  step owns one set of parameters and moments: each call copies the
  tensors passed in into it (a copy in), replays in place on it, and
  returns a copy of it, two device-to-device copies of the parameters
  and moments a step.

The metrics a call returns are its own tensors.

With ``mesh=`` (a :class:`DeviceMesh` with the reference's axes) the step
is the reference's sharded one: it takes parameters placed by
:func:`~repro_torch.distributed.sharding.param_shardings` (DTensors), its
moments follow their parameter's placements, and the batch (numpy or
plain tensors, the same on every rank) is split over the data-parallel
axes where they divide it; every rank runs the same Python, DTensor adds
the collectives (FSDP gathers and reduce-scatters over ``data``, tensor-
and expert-parallel all-reduces over ``model``), and the metrics come
back as plain tensors.  The microbatch loop is fissioned on a mesh too, as
the reference's is under pjit: the pass traces each rank's program on the
local shards (:mod:`repro_torch.core.fission`) once per local signature
and placements, so each rank launches the gather once a step.  A step on
a mesh runs op by op: its collectives go over gloo between processes
that share a card, and those cannot sit in a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.utils import _pytree as pytree

from repro_torch.core.fission import scan_with_queries
from repro_torch.distributed.sharding import batch_placements, full, mesh_context
from repro_torch.models.registry import Arch
from repro_torch.serving import graphs
from repro_torch.train.optimizer import (AdamWConfig, QuantizedTensor, adamw_init,
                                         adamw_update)

__all__ = ["cross_entropy", "make_loss_fn", "make_train_step", "TrainStepConfig"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE in float32.  logits (B, S, V), labels (B, S) integer."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])
    # (B, S, 1) kept: a vocabulary-sharded DTensor's gathered logit is a
    # masked partial sum, which DTensor reduces here and not after a slice.
    return torch.mean(logz[..., None] - gold)


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
    parameters' device.  Without a mesh the step is compiled (module
    docstring: what ``donate`` writes, how long a returned tensor stays
    valid, ``copies_in``, ``cache``).  On a mesh, with ``ts_cfg.donate``
    the new parameters and moments are written into the tensors passed in
    (returned as well); without it nothing passed in is written.
    ``train_step.plans`` holds the fission plans (module docstring);
    clearing it makes the next step that runs op by op trace again.
    """
    loss_fn = make_loss_fn(arch)
    n = ts_cfg.microbatches
    plans: dict = {}

    def init_state(params):
        state = {"opt": adamw_init(opt_cfg, params)}
        if ts_cfg.grad_compression == "int8_ef":
            state["ef"] = pytree.tree_map(_zeros_f32, params)
        return state

    def body(carry, mb, params):
        acc, loss_acc = carry
        (loss, metrics), grads = _value_and_grad(loss_fn, params, mb)
        acc = pytree.tree_map(lambda a, g: a + g.float() / n, acc, grads)
        return (acc, loss_acc + loss / n), metrics

    def compute_grads(params, batch):
        """``batch``: the step's batch, or with ``n > 1`` its microbatches."""
        if n <= 1:
            (loss, metrics), grads = _value_and_grad(loss_fn, params, batch)
            return loss, metrics, grads

        zero_g = pytree.tree_map(_zeros_f32, params)
        loss0 = torch.zeros((), dtype=torch.float32, device=_device_of(zero_g))
        (grads, loss), metricss = scan_with_queries(
            body, (zero_g, loss0), batch, fission=ts_cfg.fission, consts=params,
            plans=plans)
        metrics = {k: m[-1] for k, m in metricss.items()}
        return loss, metrics, grads

    def update(params, state, batch, inplace: bool):
        """One step on a placed (and split) batch → (new params, new state,
        metrics), written into ``params`` and ``state`` with ``inplace``
        and new tensors otherwise."""
        loss, metrics, grads = compute_grads(params, batch)
        if mesh is not None:  # each gradient laid out as its parameter
            grads = pytree.tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements),
                                    grads, params)
        new_ef = None
        if ts_cfg.grad_compression == "int8_ef":
            flat_g, tdef = pytree.tree_flatten(grads)
            flat_e = pytree.tree_leaves(state["ef"])
            res = [_quant_int8_ef(g, e) for g, e in zip(flat_g, flat_e)]
            grads = pytree.tree_unflatten([r[0] for r in res], tdef)
            new_ef = pytree.tree_unflatten([r[1] for r in res], tdef)
            if inplace:
                for e, r in zip(flat_e, res):
                    e.copy_(r[1])
                new_ef = state["ef"]
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, grads, state["opt"], params, inplace=inplace)
        new_state = {"opt": new_opt}
        if new_ef is not None:
            new_state["ef"] = new_ef
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return new_params, new_state, metrics

    if mesh is None:
        return init_state, CompiledTrainStep(update, ts_cfg, plans)

    def train_step(params, state, batch):
        device = _device_of(params)
        with mesh_context(mesh):
            batch = {k: _placed_batch(mesh, k, v, n, device) for k, v in batch.items()}
            new_params, new_state, metrics = update(params, state, batch, ts_cfg.donate)
        return new_params, new_state, {k: full(v) for k, v in metrics.items()}

    train_step.plans = plans
    return init_state, train_step


class CompiledTrainStep:
    """``make_train_step``'s step without a mesh: the whole step as one
    compiled step per batch signature (module docstring).  ``plans`` are
    the fission plans, ``cache`` the steps (a
    :class:`~repro_torch.serving.graphs.StepCache`, made at the first
    call), ``copies_in`` the calls that copied tensors in."""

    def __init__(self, update, cfg: TrainStepConfig, plans: dict):
        self._update = update
        self.donate = cfg.donate
        self.microbatches = cfg.microbatches
        self.plans = plans
        self.copies_in = 0
        self.cache: Optional[graphs.StepCache] = None
        self._own = None  # the (params, state) every graph reads and writes

    @property
    def calls(self) -> int:
        return 0 if self.cache is None else self.cache.calls

    @property
    def replays(self) -> int:
        return 0 if self.cache is None else self.cache.replays

    def __call__(self, params, state, batch):
        self._take(params, state)
        batch = {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
                 for k, v in batch.items()}
        sig = (tuple((k, tuple(v.shape), _torch_dtype(v)) for k, v in batch.items()),
               self.microbatches)
        with self.cache.exclusive(sig) as step:
            on_device = {}
            for k, v in batch.items():
                if isinstance(v, torch.Tensor) and v.device.type != "cpu":
                    on_device[k] = v
                else:
                    step.inputs.put(k, v.numpy() if isinstance(v, torch.Tensor) else v)
            step.inputs.upload()
            for k, v in on_device.items():
                step.inputs[k].copy_(v)
            outs = step()
            metrics = {k: o.clone() for k, o in zip(step.fn.names, outs)}
            params, state = self._own if self.donate else _cloned(self._own)
        return params, state, metrics

    def _take(self, params, state) -> None:
        """Bring the caller's tensors into the step's own: with ``donate``
        the first call's tensors are its own and later ones are copied in
        unless they are those; without it the own tensors are new and every
        call copies in."""
        given = _tensors_by_path((params, state))
        if self._own is None:
            self._own = (params, state) if self.donate else _cloned((params, state),
                                                                     torch.empty_like)
            # no reference back to the step: dropping it frees its graphs at once
            self.cache = graphs.StepCache(functools.partial(_build, self._own, self._update),
                                          next(iter(given.values())).device)
            if self.donate:
                return
        own = _tensors_by_path(self._own)
        if own.keys() != given.keys() or any(a.shape != given[k].shape
                                             or a.dtype != given[k].dtype
                                             for k, a in own.items()):
            raise ValueError("a compiled train step takes parameters and state of the "
                             "layout of its first call")
        if all(_same(a, given[k]) for k, a in own.items()):
            return
        with torch.no_grad():
            for k, a in own.items():
                if not _same(a, given[k]):
                    a.copy_(given[k])
        self.copies_in += 1


def _build(own, update, key, pool, hold) -> graphs.CompiledStep:
    """The compiled train step of one batch signature: the batch's static
    buffers, and the whole step in place on ``own``, the step's
    (parameters, state)."""
    leaves, n = key
    own_params, own_state = own
    device = next(iter(_tensors_by_path(own).values())).device
    inputs = graphs.StaticInputs({k: (shape, dtype) for k, shape, dtype in leaves}, device)
    names = [k for k, _s, _d in leaves]

    def fn():
        batch = {k: inputs[k] for k in names}
        if n > 1:
            batch = {k: _split(v, n) for k, v in batch.items()}
        _p, _s, metrics = update(own_params, own_state, batch, True)
        fn.names = tuple(metrics)
        return tuple(metrics.values())

    return graphs.CompiledStep(fn, inputs, _tensors_by_path(own).values(), device, pool, hold,
                               grad=True, release=True)


def _torch_dtype(v) -> torch.dtype:
    if isinstance(v, torch.Tensor):
        return v.dtype
    return torch.from_numpy(np.empty(0, v.dtype)).dtype


def _tensors_by_path(tree) -> dict:
    """A tree's tensors, an int8 moment's blocks and scales included, by
    their path of keys (a restored tree may hold its keys in another
    order)."""
    out = {}
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        key = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if isinstance(leaf, QuantizedTensor):
            out[key + ("q",)], out[key + ("scale",)] = leaf.q, leaf.scale
        else:
            out[key] = leaf
    return out


def _cloned(tree, like=torch.clone):
    """``tree`` with every tensor (an int8 moment's too) made anew by
    ``like``."""
    def one(x):
        if isinstance(x, QuantizedTensor):
            return QuantizedTensor(like(x.q), like(x.scale), shape=x.shape, pad=x.pad,
                                   sqrt_domain=x.sqrt_domain)
        return like(x)

    return pytree.tree_map(one, tree)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors are the same memory under the same layout."""
    return a is b or (a.device == b.device and a.dtype == b.dtype and a.shape == b.shape
                      and a.stride() == b.stride() and a.data_ptr() == b.data_ptr())


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """float32 zeros shaped (and, for a DTensor, placed) like ``p``."""
    return torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)


def _split(x: torch.Tensor, n: int) -> torch.Tensor:
    """A batch leaf as ``n`` microbatches on a new leading axis (a leaf
    whose batch ``n`` does not divide is repeated, as in the reference).  A
    DTensor splits its own rows: microbatch i of a rank is the i-th slice
    of that rank's batch shard (each row still in one microbatch, but
    grouped with other rows than on one device: a MoE layer's capacity and
    aux loss per microbatch see other tokens)."""
    b = x.shape[0]
    if not (x.dim() >= 1 and b % n == 0):
        return x.expand((n,) + tuple(x.shape))
    if not isinstance(x, DTensor):
        return x.reshape((n, b // n) + tuple(x.shape[1:]))
    loc = x.to_local()
    if loc.shape[0] % n:
        raise ValueError(f"a batch shard of {loc.shape[0]} rows does not split into {n} "
                         "microbatches")
    loc = loc.reshape((n, loc.shape[0] // n) + tuple(loc.shape[1:]))
    placements = [Shard(p.dim + 1) if isinstance(p, Shard) else p for p in x.placements]
    return DTensor.from_local(loc, x.device_mesh, placements, run_check=False)


def _placed_batch(mesh, key: str, v, n: int, device):
    """A batch leaf on the mesh, split into ``n`` microbatches when ``n > 1``.
    The same full batch on every rank (numpy or a plain tensor) is split as
    on one device, microbatch i the rows [i·b/n, (i+1)·b/n) as in the
    reference, and each microbatch's rows are placed over the data-parallel
    axes: no rank communicates.  A leaf placed already splits its own rows
    (:func:`_split`)."""
    if isinstance(v, DTensor):
        return _split(v, n) if n > 1 else v
    t = torch.as_tensor(v, device=device)
    axis = 1 if key == "positions" and t.dim() == 3 else 0
    if n > 1:
        t, axis = _split(t, n), axis + 1
    return distribute_tensor(t, mesh, batch_placements(mesh, t.shape, axis),
                             src_data_rank=None)


def _device_of(tree) -> torch.device:
    """The device of a tree's first leaf."""
    return pytree.tree_leaves(tree)[0].device
