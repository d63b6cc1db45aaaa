"""``async_query``: the query tag, its custom ops, and the QuerySpec registry.

Port of :mod:`repro.core.query`.  A *query* is a parameterized,
per-iteration data access (an embedding gather, a parameter fetch) that
the loop fission of :mod:`repro_torch.core.fission` (Rule A) can pull out
of a scanned loop and execute once, in batched (set-oriented) form.

The reference binds one JAX primitive, ``async_query_p``, for every spec.
Here each built-in spec has its own ``torch.library.custom_op``, so a
traced loop body holds the query as one recognizable node:

* ``repro_torch::table_gather(Tensor table, Tensor ids) -> Tensor``;
* ``repro_torch::sharded_param_fetch(Tensor param_shard, Tensor token) ->
  Tensor`` (returns a copy: a custom op's output may not alias its input).

Each op has the reference primitive's other rules: ``register_fake``
(abstract evaluation: it traces), ``register_autograd`` (``_jvp_rule``:
the gather's backward is a float32 scatter-add into a zero table, cast to
the table's dtype, which is what XLA's transpose of ``take`` computes)
and ``register_vmap`` (``_batch_rule``: the spec's batched form).
Untransformed programs run ``spec.execute`` at the op, so tagging changes
nothing, as in the reference.

``table_gather``'s ``execute`` and ``execute_batch`` both go through the
``batched_gather`` op (:func:`repro_torch.kernels.batched_gather.ops.gather_op`):
the CUDA kernel on the card, the plain version on the CPU.  An unfissioned
loop launches it once per iteration, a fissioned loop once.  A spec
registered without an op of its own cannot be tagged (``async_query``
raises ``NotImplementedError``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import torch

from repro_torch.kernels.batched_gather.ops import gather_grad, gather_op, setup_gather_grad

__all__ = [
    "QuerySpec",
    "register_query",
    "get_query_spec",
    "async_query",
    "query_spec_of",
    "table_gather_spec",
    "sharded_param_fetch_spec",
]


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """Describes one batchable query type.

    Attributes:
      name: unique registry key.
      execute: the single-request (blocking) form, ``execute(*args)``.
      execute_batch: the set-oriented form, ``execute_batch(*args,
        batched=mask)``: an argument whose mask entry is true arrives with
        a leading batch (loop-iteration) axis, the others unstacked; the
        result has the leading axis.  ``None`` falls back to
        ``torch.vmap(execute)``, correct but without set-oriented savings.
      batch_axis_size_hint: optional static hint used by cost models.
    """

    name: str
    execute: Callable
    execute_batch: Optional[Callable] = None
    batch_axis_size_hint: Optional[int] = None

    def batched(self, mask=None) -> Callable:
        """The batched form for the per-argument ``mask`` (``None``: the
        reference's convention for ``execute_batch``)."""
        if self.execute_batch is not None:
            return partial(self.execute_batch, batched=mask)
        in_dims = 0 if mask is None else tuple(0 if b else None for b in mask)
        return torch.vmap(self.execute, in_dims=in_dims)


_REGISTRY: dict[str, QuerySpec] = {}
_OPS: dict[str, object] = {}  # spec name -> its custom op
_SPEC_OF_OP: dict[object, str] = {}  # the op's OpOverload -> spec name


def register_query(spec: QuerySpec) -> QuerySpec:
    """Idempotently register ``spec`` under ``spec.name`` (re-registration
    replaces, as in the reference)."""
    _REGISTRY[spec.name] = spec
    return spec


def get_query_spec(name: str) -> QuerySpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"No QuerySpec registered under {name!r}; call register_query first."
        ) from None


def query_spec_of(target) -> Optional[QuerySpec]:
    """The spec whose op a traced node's ``target`` is, else ``None``."""
    name = _SPEC_OF_OP.get(target)
    return None if name is None else get_query_spec(name)


def async_query(spec, *args):
    """Tag a query execution point (paper: ``v = executeQuery(q)``).

    Semantically identical to ``spec.execute(*args)``.  Inside a loop that
    is fissioned (Rule A) the execution is replaced by one set-oriented
    ``spec.execute_batch`` call.  ``args`` are tensors.
    """
    if isinstance(spec, QuerySpec):
        register_query(spec)
        name = spec.name
    else:
        name = spec
        get_query_spec(name)
    op = _OPS.get(name)
    if op is None:
        raise NotImplementedError(f"query {name!r} has no custom op in the port")
    return op(*args)


def _bind(spec: QuerySpec, op, setup_context, backward) -> QuerySpec:
    """Give ``spec`` its custom op ``op``: autograd and vmap rules."""
    op.register_autograd(backward, setup_context=setup_context)

    @op.register_vmap
    def _batch_rule(info, in_dims, *args):
        mask = [d is not None for d in in_dims]
        moved = [a if d is None else a.movedim(d, 0) for a, d in zip(args, in_dims)]
        return spec.batched(mask)(*moved), 0

    _OPS[spec.name] = op
    _SPEC_OF_OP[getattr(torch.ops.repro_torch, spec.name).default] = spec.name
    return register_query(spec)


# ---------------------------------------------------------------------------
# Built-in query specs
# ---------------------------------------------------------------------------


def _table_gather(table, ids):
    """Single query: select rows of ``table`` by integer key(s)."""
    return gather_op(table, ids)


def _table_gather_batch(table, ids, *, batched=None):
    """Set-oriented form: ONE gather over all iterations' keys.

    Fission's calling convention: loop-invariant arguments (the table)
    arrive unstacked, varying ones (the ids) with a leading loop axis;
    ``batched`` is the per-argument mask.  The whole batch is one
    ``batched_gather`` call, one kernel launch on the card.
    """
    if batched is not None and batched[0]:
        # Degenerate case: a varying table (one per iteration).
        if not batched[1]:
            ids = ids.expand((table.shape[0],) + ids.shape)
        return torch.stack([gather_op(t, i) for t, i in zip(table, ids)])
    return gather_op(table, ids)


table_gather_spec = QuerySpec(
    name="table_gather", execute=_table_gather, execute_batch=_table_gather_batch)


@torch.library.custom_op("repro_torch::table_gather", mutates_args=())
def _table_gather_op(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table_gather_spec.execute(table, ids)


@_table_gather_op.register_fake
def _(table, ids):
    return table.new_empty(ids.shape + table.shape[1:])


_bind(table_gather_spec, _table_gather_op, setup_gather_grad, gather_grad)


def _sharded_param_fetch(param_shard, _token):
    """Single query: fetch one (sharded) parameter; stands for the remote
    parameter or KV fetch.  A copy, since a custom op may not alias."""
    return param_shard.clone()


def _sharded_param_fetch_batch(param_shard, tokens, *, batched=None):
    """N fetches coalesced: the parameter once per iteration, stacked on the
    loop axis (an unstacked result, as the reference returns, would be
    sliced along its first axis by the consumer loop)."""
    if batched is not None and batched[0]:
        return param_shard.clone()
    return param_shard.expand((tokens.shape[0],) + param_shard.shape).clone()


sharded_param_fetch_spec = QuerySpec(
    name="sharded_param_fetch",
    execute=_sharded_param_fetch,
    execute_batch=_sharded_param_fetch_batch,
)


@torch.library.custom_op("repro_torch::sharded_param_fetch", mutates_args=())
def _sharded_param_fetch_op(param_shard: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    return sharded_param_fetch_spec.execute(param_shard, token)


@_sharded_param_fetch_op.register_fake
def _(param_shard, token):
    return torch.empty_like(param_shard)


def _setup_fetch(ctx, inputs, output) -> None:
    pass


def _fetch_grad(ctx, grad):
    return grad, None


_bind(sharded_param_fetch_spec, _sharded_param_fetch_op, _setup_fetch, _fetch_grad)
