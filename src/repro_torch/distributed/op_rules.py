"""DTensor placements for the kernels' custom ops.

``repro_torch::flash_attention`` has a sharding rule (``register_sharding``):
DTensor moves the operands to one of the placements listed here, then
calls the op on the local tensors, where the CUDA kernel launches as it
does on one card.  The rule lists, per mesh dim, the placements under
which every local shard is a whole problem of the op's own kind: batch
(dim 0 of q, k, v, the output and ``positions``), or heads (dim 1 of q, k
and v together), or nothing.  The kernel pairs local q head ``i`` with kv
head ``i // G``, so q's heads split only where k's and v's split with
them: a replicated GQA k/v (``wk/wv → ("dp", None, None)``) is sliced to
match, which communicates nothing.  A mesh dim that divides Hq or Hkv
unevenly leaves heads replicated (chatglm3-6b's 2 kv heads on 16).

``repro_torch::decode_attention`` writes the caches in place, so it has
no rule: a rule's strategies are chosen by their cost, and moving a cache
that is replicated costs nothing by DTensor's measure (a kv-head shard of
it is a free local slice), so the op would write the new token into a
temporary.  :func:`decode_placements` instead takes the cache's own
placements and makes the small operands follow them, and
:func:`~repro_torch.kernels.decode_attention.ops.decode_op` runs the op on
the local shards under exactly those placements (``local_map``, which
refuses a mismatch).  Per mesh dim: a cache replicated there → q and the
new K/V replicated too (q is gathered over ``model`` when its heads were
split there); lanes (dim 0) → every operand's lanes; kv heads (dim 2) →
q's heads and the new K/V's heads with them.  Any other placement (the
head dim, a partial sum, the rows, which only the split-KV decode of
:mod:`repro_torch.distributed.split_kv` combines) raises ``ValueError``.

The other kernels never see a DTensor: the model calls them on local
shards inside ``local_map`` (``transformer.embed_lookup``'s masked
vocabulary-parallel gather for ``batched_gather``, ``ssm._ssd_sharded``
for ``ssd_scan`` and its backward, :mod:`~repro_torch.distributed.split_kv`
for the decode over a rank's rows), so they need no rule.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

import repro_torch.kernels.decode_attention.ops  # noqa: F401  (registers the ops)
import repro_torch.kernels.flash_attention.ops  # noqa: F401

__all__ = ["heads_divide", "decode_placements", "placed"]

_ops = torch.ops.repro_torch
R = Replicate()


def heads_divide(mesh_shape, *heads: int) -> bool:
    """Whether no mesh dim would split any of ``heads`` unevenly (a dim
    larger than a head count is refused by DTensor itself)."""
    return all(h % n == 0 or n > h for n in mesh_shape for h in heads)


def _opt(x, placement):
    return None if x is None else placement


@register_sharding(_ops.flash_attention.default)
def _flash_rule(q, k, v, causal, window, positions):
    rules = [
        ([R], [R, R, R, None, None, _opt(positions, R)]),
        ([Shard(0)], [Shard(0), Shard(0), Shard(0), None, None, _opt(positions, Shard(0))]),
    ]
    if heads_divide(q.mesh.shape, q.shape[1], k.shape[1]):
        rules.append(([Shard(1)], [Shard(1), Shard(1), Shard(1), None, None,
                                   _opt(positions, R)]))
    return rules


def decode_placements(mesh, cache_placements, q_heads: int, kv_heads: int) -> tuple:
    """``(q's, lengths')`` placements for a decode over a cache placed
    ``cache_placements`` (module docstring): the new K/V take q's, the
    slot the lengths'.  Raises ``ValueError`` for a cache the decode
    would have to move."""
    names = mesh.mesh_dim_names
    q_pl, len_pl = [], []
    for i, p in enumerate(cache_placements):
        if isinstance(p, Replicate):
            q_pl.append(R)
            len_pl.append(R)
        elif p == Shard(0):
            q_pl.append(p)
            len_pl.append(p)
        elif p == Shard(2) and heads_divide((mesh.size(i),), q_heads, kv_heads):
            q_pl.append(Shard(1))
            len_pl.append(R)
        else:
            raise ValueError(
                f"decode: a KV cache placed {p} over mesh dim {names[i]!r} is not "
                f"written where it lives by a decode on local shards (lanes, kv heads or "
                f"replicated; its rows go through split_kv)")
    return tuple(q_pl), tuple(len_pl)


def placed(x, mesh, placements):
    """``x`` as a DTensor placed ``placements`` (a plain tensor counts as
    replicated, as in ``mesh_context``); ``None`` stays ``None``."""
    if x is None:
        return None
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [R] * mesh.ndim, run_check=False)
    return x if tuple(x.placements) == tuple(placements) else x.redistribute(mesh, placements)
