"""Sharding rules: how every parameter and activation maps onto the mesh.

Port of :mod:`repro.distributed.sharding` onto :class:`DeviceMesh` and
DTensor.  Mesh axes (see :mod:`repro_torch.launch.mesh`):

  * ``pod``   — outermost data parallelism (multi-pod mesh only)
  * ``data``  — data parallelism + FSDP parameter sharding
  * ``model`` — tensor parallelism (heads / FFN hidden) and expert
                parallelism for MoE

Parameters follow the reference's **path-based rule table**
(``PARAM_RULES``, verbatim): each rule maps a parameter path to one
logical axis per tensor dim, resolved per mesh.  A resolved spec is the
reference's ``PartitionSpec`` as a tuple (an entry is ``None``, a mesh
axis name, or a tuple of names: ``dp`` is ``("data",)`` or ``("pod",
"data")``); :func:`placements_of` turns it into one DTensor placement per
mesh dim, a tensor dim mapped to ``("pod", "data")`` being ``Shard(d)`` on
both mesh dims, pod outer (DTensor shards in mesh-dim order, as JAX does
in tuple order).  An assignment that does not divide its dimension is
replicated (:func:`divisible_spec`), as in the reference.

Activations use :func:`shard_activation`, the counterpart of
``with_sharding_constraint``: a no-op outside :func:`mesh_context` or on a
plain tensor, a ``redistribute`` of a DTensor otherwise.  Weights are used
through :func:`gather_dp` (FSDP): the data-parallel shards of a weight are
all-gathered where it is used, its tensor-parallel shard kept, so a
matrix product of a batch-sharded activation needs no other collective;
the gradient of that gather is DTensor's reduce-scatter.  Inside
:func:`mesh_context` plain tensors meet DTensors as replicated
(``implicit_replication``): positions, masks and scalars the model makes
itself.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

__all__ = [
    "mesh_context",
    "current_mesh",
    "shard_activation",
    "gather_dp",
    "logical_to_spec",
    "spec_for_path",
    "divisible_spec",
    "placements_of",
    "spec_of_placements",
    "param_shardings",
    "distribute_params",
    "input_shardings",
    "batch_placements",
    "dp_size",
    "full",
    "PARAM_RULES",
]

_DP_AXES = ("pod", "data")
_state = threading.local()


@contextlib.contextmanager
def mesh_context(mesh: Optional[DeviceMesh]):
    """Make ``mesh`` the ambient mesh of this thread; inside it, plain
    tensors mixed with DTensors count as replicated."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        if mesh is None:
            yield mesh
        else:
            with implicit_replication():
                yield mesh
    finally:
        _state.mesh = prev


def current_mesh() -> Optional[DeviceMesh]:
    return getattr(_state, "mesh", None)


def _names(mesh: DeviceMesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def _axes_in_mesh(mesh: DeviceMesh, axes):
    """Drop logical axes the mesh does not have; turn 'dp' into the full
    data-parallel axis group (('pod','data') on the multi-pod mesh)."""
    names = _names(mesh)
    out = []
    for a in axes:
        if a is None:
            out.append(None)
        elif a == "dp":
            grp = tuple(x for x in _DP_AXES if x in names)
            out.append(grp if grp else None)
        elif a in names:
            out.append(a)
        else:
            out.append(None)
    return out


def logical_to_spec(mesh: DeviceMesh, axes) -> tuple:
    return tuple(_axes_in_mesh(mesh, axes))


# ---------------------------------------------------------------------------
# Parameter rules (the reference's, verbatim).  Paths are '/'-joined key
# paths into the params dict, e.g. "layers/attn/wq", "embed/table".
#
#   embed table          (vocab, d_model)         → (model, dp)   [TP vocab]
#   attn wq              (d_model, n_heads, hd)   → (dp, model, None)
#   attn wk/wv           (d_model, n_kv, hd)      → (dp, None, None)
#   attn wo              (n_heads, hd, d_model)   → (model, None, dp)
#   mlp w_in/w_gate      (d_model, d_ff)          → (dp, model)
#   mlp w_out            (d_ff, d_model)          → (model, dp)
#   moe router           (d_model, E)             → (dp, None)
#   moe experts w_*      (E, d_model, ff)         → (model, dp, None)  [EP]
#   moe experts w_out    (E, ff, d_model)         → (model, None, dp)
#   ssm in/out proj      (d_model, d_inner)       → (dp, model)
#   norms / biases / scalars                      → replicated
#
# All stacked-over-layers params have a leading layer axis (None).
# ---------------------------------------------------------------------------

PARAM_RULES: list[tuple[str, tuple]] = [
    (r".*embed/table$", ("model", "dp")),
    (r".*lm_head/w$", ("dp", "model")),
    (r".*(attn|cross_attn)/wq$", ("dp", "model", None)),
    # GQA: kv heads (2..20) rarely divide the 16-way model axis — replicate
    # heads, FSDP-shard d_model (Megatron GQA convention).
    (r".*(attn|cross_attn)/w[kv]$", ("dp", None, None)),
    (r".*(attn|cross_attn)/wo$", ("model", None, "dp")),
    (r".*(attn|cross_attn)/bq$", ("model", None)),
    (r".*(attn|cross_attn)/b[kv]$", (None, None)),
    (r".*mlp/w_(gate|in)$", ("dp", "model")),
    (r".*mlp/w_out$", ("model", "dp")),
    (r".*moe/router/w$", ("dp", None)),
    (r".*moe/(experts|shared)/w_(gate|in)$", ("model", "dp", None)),
    (r".*moe/(experts|shared)/w_out$", ("model", None, "dp")),
    (r".*ssm/in_proj$", ("dp", "model")),
    (r".*ssm/out_proj$", ("model", "dp")),
    (r".*ssm/conv_w$", (None, "model")),
    # everything else (norms, biases, A_log, D, dt_bias): replicated
]


def spec_for_path(path_str: str, ndim: int, stacked: bool) -> tuple:
    """Resolve a param path to logical axes, prepending the layer-stack axis."""
    for pat, axes in PARAM_RULES:
        if re.match(pat, path_str):
            axes = tuple(axes)
            if stacked:
                axes = (None,) + axes
            if len(axes) < ndim:
                axes = axes + (None,) * (ndim - len(axes))
            return axes[:ndim]
    return (None,) * ndim


def _axis_size(mesh: DeviceMesh, axis) -> int:
    if axis is None:
        return 1
    names = _names(mesh)
    n = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        n *= mesh.size(names.index(a))
    return n


def divisible_spec(mesh: DeviceMesh, axes, shape) -> tuple:
    """Resolve logical axes and DROP any assignment that does not divide the
    dimension (replication is the fallback, as in the reference: e.g. 20
    query heads on a 16-way model axis, or a 50280-row vocab)."""
    resolved = _axes_in_mesh(mesh, axes)
    out = []
    for dim, ax in zip(shape, resolved):
        out.append(ax if ax is not None and dim % _axis_size(mesh, ax) == 0 else None)
    return tuple(out)


def placements_of(mesh: DeviceMesh, spec) -> tuple:
    """One placement per mesh dim for a resolved spec: ``Shard(d)`` on every
    mesh axis that tensor dim ``d`` names, ``Replicate()`` elsewhere."""
    names = _names(mesh)
    pl = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            pl[names.index(a)] = Shard(d)
    return tuple(pl)


def spec_of_placements(mesh: DeviceMesh, placements, ndim: int) -> tuple:
    """The inverse of :func:`placements_of`, spelt as JAX normalises a
    ``PartitionSpec``: a dim sharded over one mesh axis is its name, over
    several (``("pod", "data")``) the tuple of their names in mesh order."""
    names = _names(mesh)
    out = []
    for d in range(ndim):
        axes = tuple(names[i] for i, p in enumerate(placements)
                     if isinstance(p, Shard) and p.dim == d)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def param_shardings(
    mesh: DeviceMesh,
    params: dict,
    stacked_prefixes=("layers", "enc_layers", "dense_layers"),
) -> dict:
    """Placements (a tuple per mesh dim) for every leaf of a params dict
    (tensors, meta tensors or DTensors), with the dict's structure."""

    def one(ps: str, leaf) -> tuple:
        stacked = any(ps.startswith(pfx) or f"/{pfx}/" in ps for pfx in stacked_prefixes)
        spec = spec_for_path(ps, leaf.dim(), stacked)
        return placements_of(mesh, divisible_spec(mesh, spec, leaf.shape))

    def walk(node, path: str):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        return one(path, node)

    return walk(params, "")


def distribute_params(mesh: DeviceMesh, params: dict, shardings: Optional[dict] = None) -> dict:
    """Place every leaf of ``params`` (full tensors, the same on every rank:
    drawn from one seed, or read from one checkpoint) on ``mesh`` by
    :func:`param_shardings`.  Each rank keeps its own shard of its own copy
    (``src_data_rank=None``), so placing communicates nothing."""
    shardings = param_shardings(mesh, params) if shardings is None else shardings

    def walk(node, sh):
        if isinstance(node, dict):
            return {k: walk(v, sh[k]) for k, v in node.items()}
        return distribute_tensor(node, mesh, sh, src_data_rank=None)

    return walk(params, shardings)


def input_shardings(mesh: DeviceMesh, batch_axes=("dp",)) -> tuple:
    """Placements for (batch, seq[, ...]) token inputs: batch over dp."""
    return placements_of(mesh, logical_to_spec(mesh, tuple(batch_axes) + (None,)))


def batch_placements(mesh: DeviceMesh, shape, batch_axis: int = 0) -> tuple:
    """Placements of an input: its batch dim over dp where dp divides it,
    replicated otherwise (the reference dry run's ``_batch_sharding``)."""
    axes = [None] * len(shape)
    if len(shape) and shape[batch_axis] % dp_size(mesh) == 0:
        axes[batch_axis] = "dp"
    return placements_of(mesh, logical_to_spec(mesh, axes))


def dp_size(mesh: DeviceMesh) -> int:
    """Ranks along the data-parallel axes (pod x data)."""
    return _axis_size(mesh, tuple(a for a in _DP_AXES if a in _names(mesh)) or None)


class _GradTo(torch.autograd.Function):
    """Identity whose gradient is redistributed to ``placements``: the
    cotangent half of a sharding constraint (DTensor's own redistribute
    passes a partial-sum gradient through unreduced)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def shard_activation(x, *axes):
    """``with_sharding_constraint`` against the ambient mesh: a no-op
    without one or on a plain tensor; non-dividing assignments fall back
    to replication per dim.  As in JAX, the constraint holds for the value
    and for its gradient."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    placements = placements_of(mesh, divisible_spec(mesh, axes, x.shape))
    if tuple(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    if torch.is_grad_enabled() and x.requires_grad:
        x = _GradTo.apply(x, placements)
    return x


def gather_dp(w):
    """A weight as it is used (FSDP): its shards over the data-parallel
    axes all-gathered, its ``model`` shard kept.  A no-op on a plain
    tensor."""
    if not isinstance(w, DTensor):
        return w
    names = _names(w.device_mesh)
    placements = tuple(Replicate() if names[i] in _DP_AXES else p
                       for i, p in enumerate(w.placements))
    if placements == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, placements)


def full(x) -> torch.Tensor:
    """A DTensor's global value as a plain tensor; a plain tensor as is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


# The kernels' custom ops get their DTensor sharding rules with this module.
from repro_torch.distributed import op_rules  # noqa: E402,F401
