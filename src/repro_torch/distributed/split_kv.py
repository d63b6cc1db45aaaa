"""The split-KV decode: one token's attention over a cache whose rows are
sharded over a mesh dim (the dry run's ``kv_seq_shard``).

Port of what GSPMD makes of the reference's decode under that layout
(``repro/launch/dryrun.py``: the softmax over a sequence-sharded cache
becomes "tiny all-reduces (max + sum + out)").  No cache is gathered:
rank ``r`` of the row dim holds rows ``[r·T_loc, (r+1)·T_loc)`` of every
lane and

* writes a lane's new K/V only where it holds the lane's slot
  (``min(length, S_max - 1)``, or ``length % S_max`` in a ring buffer);
  the other ranks write their row back unchanged;
* runs the ``decode_attention`` kernel on its own rows, with each lane's
  local length ``clamp(att_len - r·T_loc, 0, T_loc)``, and gets each head's
  output ``out_r`` and the log-sum-exp ``lse_r`` of its scores (``-inf``
  where it holds no valid row);
* combines with three all-reduces over the row dim:
  ``m = max_r lse_r``, ``w_r = exp(lse_r - m)`` (0 where ``lse_r`` is
  ``-inf``), ``out = Σ w_r·out_r / Σ w_r``; a lane with no valid row
  anywhere gives zeros, as on one card.

The other mesh dims keep the cache's placement as the local decode does
(:func:`repro_torch.distributed.op_rules.decode_placements`), and the rank
runs on its local shards inside ``local_map``, as ``embed_lookup`` does
for the vocabulary-parallel gather.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.op_rules import decode_placements, placed
from repro_torch.kernels.decode_attention.ops import decode_lse_op

__all__ = ["rows_split", "split_kv_decode"]


def rows_split(cache) -> bool:
    """Whether ``cache`` (B, T, Hkv, D) is a DTensor with its rows sharded."""
    return isinstance(cache, DTensor) and Shard(1) in cache.placements


def split_kv_decode(q, k, v, lengths, *, k_new=None, v_new=None, slot=None):
    """:func:`~repro_torch.kernels.decode_attention.ops.decode_op` over DTensor
    caches k/v (B, T, Hkv, D) whose rows (dim 1) are sharded over one mesh
    dim (module docstring) → (B, Hq, D), replicated over that dim."""
    mesh, kv_pl = k.device_mesh, tuple(k.placements)
    dims = [i for i, p in enumerate(kv_pl) if p == Shard(1)]
    if len(dims) != 1 or not isinstance(v, DTensor) or tuple(v.placements) != kv_pl:
        raise ValueError(f"split-KV decode: K and V caches placed alike with their rows "
                         f"over one mesh dim, not {kv_pl}")
    m = dims[0]
    rest = tuple(Replicate() if i == m else p for i, p in enumerate(kv_pl))
    q_pl, len_pl = decode_placements(mesh, rest, q.shape[1], k.shape[2])
    t_chunk = -(-k.shape[1] // mesh.size(m))  # DTensor's chunk: the first ranks' rows
    start = mesh.get_local_rank(m) * t_chunk
    group = mesh.get_group(m)

    def local(q, k, v, lengths, k_new, v_new, slot):
        t_loc = k.shape[1]
        if k_new is not None:
            _write_held(k, v, k_new, v_new, slot - start)
        out, lse = decode_lse_op(q, k, v, torch.clamp(lengths - start, 0, t_loc))
        mx = funcol.all_reduce(lse, "max", group)
        w = torch.where(lse == -math.inf, torch.zeros_like(lse), torch.exp(lse - mx))
        num = funcol.all_reduce(out.float() * w[..., None], "sum", group)
        den = funcol.all_reduce(w, "sum", group)[..., None]
        out = torch.where(den > 0, num / torch.clamp(den, min=1e-30), torch.zeros_like(num))
        return out.to(q.dtype)

    new_pl = None if k_new is None else q_pl
    slot_pl = None if slot is None else len_pl
    run = local_map(local, out_placements=list(q_pl),
                    in_placements=(q_pl, kv_pl, kv_pl, len_pl, new_pl, new_pl, slot_pl),
                    device_mesh=mesh)  # redistributes nothing: a mismatch raises
    return run(placed(q, mesh, q_pl), k, v, placed(lengths, mesh, len_pl),
               placed(k_new, mesh, q_pl), placed(v_new, mesh, q_pl), placed(slot, mesh, len_pl))


def _write_held(k, v, k_new, v_new, rel) -> None:
    """Row ``rel`` (B,) of each lane's local cache, where this rank holds it
    (``0 <= rel < T_loc``), gets the new K/V; the other lanes' row at the
    clamped index is written back as it was (no shape depends on data)."""
    t_loc = k.shape[1]
    lanes = torch.arange(k.shape[0], device=k.device)
    row = torch.clamp(rel, 0, t_loc - 1).long()
    held = ((rel >= 0) & (rel < t_loc))[:, None, None]
    for cache, new in ((k, k_new), (v, v_new)):
        cache.index_put_((lanes, row), torch.where(held, new.to(cache.dtype),
                                                   cache[lanes, row]))
