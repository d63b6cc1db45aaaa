"""DTensor sharding rules for the kernels' custom ops.

With these rules a custom op called on DTensors runs its kernel on each
rank's local shard (``register_sharding``): DTensor moves the operands to
one of the placements listed here, then calls the op on the local
tensors, where the CUDA kernel launches as it does on one card.  Each
rule lists, per mesh dim, the placements under which every local shard is
a whole problem of the op's own kind:

* ``repro_torch::flash_attention`` — batch (dim 0 of q, k, v, the output
  and ``positions``), or heads (dim 1 of q, k and v together), or
  nothing.  The kernel pairs local q head ``i`` with kv head ``i // G``,
  so q's heads split only where k's and v's split with them: a
  replicated GQA k/v (``wk/wv → ("dp", None, None)``) is sliced to match,
  which communicates nothing.  A mesh dim that divides Hq or Hkv
  unevenly leaves heads replicated (chatglm3-6b's 2 kv heads on 16).
* ``repro_torch::decode_attention`` (writes the caches in place) —
  lanes, or kv heads with their query heads; the caches keep their
  placement.

The other kernels never see a DTensor: the model calls them on local
shards inside ``local_map`` (``transformer.embed_lookup``'s masked
vocabulary-parallel gather for ``batched_gather``, ``ssm._ssd_sharded``
for ``ssd_scan`` and its backward), so they need no rule.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

import repro_torch.kernels.decode_attention.ops  # noqa: F401  (registers the ops)
import repro_torch.kernels.flash_attention.ops  # noqa: F401

__all__ = ["heads_divide"]

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


@register_sharding(_ops.decode_attention.default)
def _decode_rule(q, k_cache, v_cache, lengths, k_new, v_new, slot):
    rules = [
        ([R], [R, R, R, R, _opt(k_new, R), _opt(v_new, R), _opt(slot, R)]),
        ([Shard(0)], [Shard(0), Shard(0), Shard(0), Shard(0), _opt(k_new, Shard(0)),
                      _opt(v_new, Shard(0)), _opt(slot, Shard(0))]),
    ]
    if heads_divide(q.mesh.shape, q.shape[1], k_cache.shape[2]):
        rules.append(([Shard(1)], [Shard(1), Shard(2), Shard(2), R, _opt(k_new, Shard(1)),
                                   _opt(v_new, Shard(1)), _opt(slot, R)]))
    return rules
