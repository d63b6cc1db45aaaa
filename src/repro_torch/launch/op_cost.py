"""Per-device cost of a traced step, counted op by op on local tensors.

The port's counterpart of :mod:`repro.launch.hlo_cost`.  The reference
reads compiled HLO; the port runs eagerly and has none, so it counts the
ops a step dispatches: :class:`OpCost` is a ``TorchDispatchMode`` that
sees every op **below DTensor** (it lets DTensor desugar an op into its
local op and collectives first), so every count is one rank's, on its
local shards, as the reference's partitioned HLO is:

  * flops — ``torch.utils.flop_counter``'s formulas (matrix products,
    convolutions, attention), plus one registered here for each of the
    port's custom ops (:data:`CUSTOM_OP_FLOPS`); an op without a formula
    counts 0;
  * bytes — each op's tensor inputs plus its outputs, views excluded.
    There is no fusion model: an intermediate that XLA keeps inside one
    fused kernel is counted here where it is written and again where it
    is read, so this counts more than the reference's fusion-level bytes;
  * collectives — the ``c10d_functional`` ops DTensor issues (and c10d's
    own, which ``torch.distributed``'s collectives dispatch), by kind
    (the reference's names: ``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``) with their output bytes, and, given
    a mesh, by the mesh axes of their group;
  * live bytes — every tensor an op creates (not a view, not written in
    place) counts from its creation until it is freed, on top of what the
    caller declares live (:meth:`OpCost.hold`: parameters, optimizer
    state, inputs); :attr:`OpCost.peak_bytes` is the peak.

Run it under ``FakeTensorMode`` (the dry run) or on real tensors (the
card): it only reads shapes.  Ops that DTensor runs on fake global-shape
tensors to infer an output's metadata are not counted (they are no work
of the rank).  :meth:`OpCost.cost` returns the reference's
:class:`HloCost` fields.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

import repro_torch.distributed.op_rules  # noqa: F401  (the custom ops exist)

__all__ = ["OpCost", "HloCost", "attention_pairs", "CUSTOM_OP_FLOPS"]


@dataclasses.dataclass
class HloCost:
    """The reference's cost record (per device)."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)


def attention_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head attends: all ``s * t`` without a mask;
    with the causal mask (top-left aligned, key ``j <= i``) the pairs with
    ``j < t``; with a window ``W`` also ``j > i - W``."""
    if not causal:
        return s * t
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    return int(np.clip(hi - lo + 1, 0, None).sum())


_ops = torch.ops.repro_torch


def _flash_flops(q_shape, k_shape, v_shape, causal, window, positions_shape=None,
                 out_val=None, **kw) -> int:
    # two products (scores, then P V) of 2 flops a multiply-add per pair and D
    b, hq, s, d = q_shape
    return 4 * b * hq * d * attention_pairs(s, k_shape[2], causal, window)


def _gather_flops(*args, **kw) -> int:
    return 0  # a copy of rows


def _scan_flops(states_shape, decay_shape, initial_shape=None, out_val=None, **kw) -> int:
    # s_{c+1} = s_c * decay_c + states_c: a multiply and an add per element
    return 2 * int(np.prod(states_shape))


def _scan_bwd_flops(g_prev_shape, g_final_shape, prev_shape, decay_shape,
                    out_val=None, **kw) -> int:
    # the adjoint's multiply-add, and d_decay's product with prev and sum
    return 4 * int(np.prod(prev_shape))


def _decode_flops(q_shape, k_shape, v_shape, lengths_shape, k_new_shape=None,
                  v_new_shape=None, slot_shape=None, out_val=None, **kw) -> int:
    # every cache row counted: the lengths are data, not shapes
    b, hq, d = q_shape
    return 4 * b * hq * d * k_shape[1]


CUSTOM_OP_FLOPS = {
    _ops.flash_attention: _flash_flops,
    _ops.batched_gather: _gather_flops,
    _ops.ssd_scan: _scan_flops,
    _ops.ssd_scan_bwd: _scan_bwd_flops,
    _ops.decode_attention: _decode_flops,
    _ops.decode_attention_lse: _decode_flops,  # the same work, no cache write
}
for _op, _fn in CUSTOM_OP_FLOPS.items():
    if _op not in flop_registry:
        register_flop_formula(_op)(_fn)

_PROPAGATING = threading.local()


def _skip_metadata_propagation() -> None:
    """Mark the ops DTensor runs to infer output metadata (its sharding
    propagator's fake run over the global shapes), so :class:`OpCost`
    leaves them out."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(orig, "_op_cost_marks", False):
        return

    def marked(self, *args, **kwargs):
        _PROPAGATING.depth = getattr(_PROPAGATING, "depth", 0) + 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1

    marked._op_cost_marks = True
    ShardingPropagator._propagate_tensor_meta_non_cached = marked


_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    # c10d's in-place ops (``torch.distributed``'s collectives called directly)
    "_allgather_base_": "all-gather",
    "allreduce_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _group_name(args):
    """The process group a collective runs over: functional collectives
    name it, c10d's ops pass the group itself."""
    for a in reversed(args):
        if isinstance(a, str):
            return a
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).group_name
            except (AttributeError, RuntimeError):
                return None
    return None


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree) -> list:
    return [x for x in torch.utils._pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


class OpCost(TorchDispatchMode):
    """Counts one rank's flops, bytes and collectives (module docstring).

    ``mesh`` (optional) names each collective's group by the mesh axes it
    spans, in :attr:`by_axis` (``{(kind, axes): count}``)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: {"count": 0, "bytes": 0}
                            for k in ("all-gather", "all-reduce", "reduce-scatter",
                                      "all-to-all", "broadcast")}
        self.by_axis: Dict[tuple, int] = {}
        self.flops_by_op: Dict[str, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._groups = {}
        _skip_metadata_propagation()
        if mesh is not None:
            names = mesh.mesh_dim_names
            for i, name in enumerate(names):
                self._groups[mesh.get_group(i).group_name] = (name,)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor desugars into local ops first
        out = func(*args, **kwargs)
        if getattr(_PROPAGATING, "depth", 0):
            return out
        packet = func._overloadpacket
        ns = getattr(packet, "_qualified_op_name", "").split("::")[0]
        name = func.__name__.split(".")[0]
        if ns in _COLL_NAMESPACES:
            kind = _KINDS.get(name)
            if kind is not None:
                b = sum(_nbytes(t) for t in _tensors(out))
                self.collectives[kind]["count"] += 1
                self.collectives[kind]["bytes"] += b
                group = _group_name(args)
                key = (kind, self._groups.get(group, (group,)))
                self.by_axis[key] = self.by_axis.get(key, 0) + 1
            return out
        if packet in flop_registry:
            # the ``.dtype`` overloads (mm/bmm with ``out_dtype``) add a
            # positional dtype the formulas do not take
            fargs = args[:2] if func._overloadname == "dtype" else args
            f = int(flop_registry[packet](*fargs, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + f
        if not func.is_view:
            ins = _tensors((args, kwargs))
            outs = _tensors(out)
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            seen = {id(t) for t in ins}
            for t in outs:
                if id(t) not in seen:  # a new tensor, not one written in place
                    self._create(t)
        return out

    def hold(self, nbytes: int) -> None:
        """Count ``nbytes`` more as live for the rest of the run."""
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _create(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.hold(n)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def count(self, kind: str, axis: Optional[str] = None) -> int:
        """Collectives of ``kind``, over group ``(axis,)`` when given."""
        if axis is None:
            return self.collectives[kind]["count"]
        return self.by_axis.get((kind, (axis,)), 0)

    def cost(self) -> HloCost:
        counts = {k: v["count"] for k, v in self.collectives.items() if v["count"]}
        return HloCost(float(self.flops), float(self.bytes),
                       float(sum(v["bytes"] for v in self.collectives.values())), counts)

    def collectives_row(self) -> dict:
        """The reference's ``collectives`` entry: per kind, and totals."""
        out = {k: dict(v) for k, v in self.collectives.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        out["total_count"] = sum(v["count"] for v in self.collectives.values())
        return out

    def by_axis_row(self) -> dict:
        """``{"<kind>@<axes>": count}``: the collectives by the mesh axes
        of their group (``+``-joined)."""
        return {f"{kind}@{'+'.join(map(str, axes))}": n
                for (kind, axes), n in sorted(self.by_axis.items())}
