"""Mixture-of-Experts layer: DeepSeekMoE-style fine-grained routed experts
with shared experts [arXiv:2401.06066], as deepseek-moe-16b (64 experts
top-6, 2 shared) and kimi-k2 (384 top-8, 1 shared) use it.

Port of :mod:`repro.models.moe` (``moe_params``, ``_capacity``, ``_route``,
``_experts_local``, ``moe``), both branches.  On one device ``_experts``
runs all ``E`` experts (``e_offset = 0``).  Under a mesh with a ``model``
axis that divides ``E`` and data-parallel axes that divide the batch (the
reference's condition), and with DTensor operands, it is the expert-
parallel branch: routing runs on the batch shard of each rank, then
``local_map`` (the counterpart of ``shard_map``) runs each rank's
``E / model`` experts, their stacks ``Shard(0)`` on ``model`` and gathered
over the data-parallel axes (FSDP), on that rank's tokens; routes to
another rank's experts drop out there.  The result is a partial sum over
``model``, and one all-reduce (the reference's ``psum``, DTensor's
redistribute to ``Replicate``, which also carries the gradient) adds the
ranks' shares; shared experts sharded over ``model`` add their own
partial sum before it, so a call holds one all-reduce over ``model``.
The sum over ranks is in another order than one device's over k.

The capacity model is the reference's (GShard/Switch, scatter form):

* routing runs in float32 (the router's weight is float32 at every
  ``param_dtype``): softmax over the experts, top-k, gates renormalised
  over the k, then each route's position in its expert is an exclusive
  running count over the row's (S x K) stream;
* each expert holds ``C = _capacity(cfg, S)`` slots per batch row, where S
  is the dispatch's (padded) length, so 1 in a decode step (C = 4).  A
  route at position ``>= C`` is **dropped**: its gate is zeroed and the
  others are not renormalised; the shared experts still see the token;
* every expert runs over all its C slots (empty ones hold zeros).

Dispatch and combine are written so that a result does not depend on the
order in which the device adds: each kept route owns one distinct
(expert, row, slot) and is written there by a plain indexed assignment,
and the combine gathers each token's K expert outputs and sums them over
k (the reference scatter-adds them, which on the card would add with
atomics in a varying order).  A dropped route is written to one spare row
past the (E, B, C) slots, which no expert reads, and adds nothing in the
combine (its gate is 0), so no mask leaves the device.

Rounding points in bf16 are the reference's: the dispatch buffer and the
gate/input products in the compute dtype (float32 accumulation), SiLU in
float32, the expert outputs and the gate product in float32, the result in
the compute dtype, and the shared experts added in the compute dtype.

Shapes: x (B, S, d); experts ``w_gate``/``w_in`` (E, d, f), ``w_out``
(E, f, d), stacked on a leading layer axis in the params tree.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import (
    current_mesh,
    dp_size,
    gather_dp,
    logical_to_spec,
    placements_of,
    shard_activation,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

__all__ = ["moe_params", "moe"]


def _normal(gen: torch.Generator, shape: tuple, scale: float, dtype,
            device) -> torch.Tensor:
    """Normal weights times ``scale`` in ``dtype``, drawn one slice of the
    leading axis at a time, so a large stack never exists in float32."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        w = torch.randn(shape[1:], generator=gen, device=device)
        out[i] = w.mul_(scale).to(dtype)
    return out


def moe_params(gen: torch.Generator, cfg: ModelConfig, device,
               lead: tuple = ()) -> dict:
    """Router (d, E) in float32, routed experts and, with
    ``cfg.n_shared_experts``, the shared experts, stacked on ``lead``."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    pd = cfg.pdtype

    def expert_stack(n):
        def w(i, o):
            return _normal(gen, lead + (n, i, o), 1.0 / math.sqrt(i), pd, device)
        return {"w_gate": w(d, ff), "w_in": w(d, ff), "w_out": w(ff, d)}

    p = {"router": {"w": dense_init(gen, d, E, torch.float32, device, lead=lead)},
         "experts": expert_stack(E)}
    if cfg.n_shared_experts > 0:
        p["shared"] = expert_stack(cfg.n_shared_experts)
    return p


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4, floor 4


def _route(router_w: torch.Tensor, cfg: ModelConfig, x: torch.Tensor, C: int):
    """float32 routing → (probs (B, S, E), expert_idx (B, S, K), gate_vals
    (B, S, K) with dropped routes zeroed, pos (B, S, K))."""
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(torch.matmul(x.float(), router_w.float()), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    pos = _positions(expert_idx, E)
    gate_vals = gate_vals * (pos < C).float()
    return probs, expert_idx, gate_vals, pos


def _positions(expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each route's position in its expert (B, S, K): an exclusive running
    count over the row's (S·K) stream of expert ids."""
    B, S, K = expert_idx.shape
    flat = expert_idx.reshape(B, S * K)
    onehot = F.one_hot(flat, n_experts).to(torch.int32)
    pos_all = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    return pos_all.gather(-1, flat[..., None])[..., 0].reshape(B, S, K)


class _BmmF32(torch.autograd.Function):
    """``torch.bmm(a, b, out_dtype=float32)`` of bf16 operands on the card,
    with the gradient that overload lacks: float32 products of the float32
    cotangent with the operands widened (exact), each rounded once to its
    operand's dtype, as ``transformer._MatmulF32`` does for the head."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
              if ctx.needs_input_grad[0] else None)
        gb = (torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
              if ctx.needs_input_grad[1] else None)
        return ga, gb


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with float32 accumulators and a float32 result
    (the reference's ``preferred_element_type=float32`` without a cast).
    On the card bf16 operands stay bf16 (``out_dtype``, through
    :class:`_BmmF32` for its gradient); on the CPU they are widened first,
    which is exact."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def _experts(weights: dict, cfg: ModelConfig, x: torch.Tensor,
             expert_idx: torch.Tensor, gate_vals: torch.Tensor,
             pos: torch.Tensor, C: int, e_offset: int = 0,
             E_loc: Optional[int] = None) -> torch.Tensor:
    """Dispatch → expert FFNs → combine for experts ``[e_offset, e_offset +
    E_loc)`` (all E by default; ``weights`` hold just those); returns the
    float32 (B, S, d) sum of each token's gated outputs of those experts:
    summed over the ranks that hold the others, the full MoE."""
    cd = cfg.cdtype
    B, S, d = x.shape
    K = cfg.top_k
    E = cfg.n_experts if E_loc is None else E_loc
    n_slots = E * B * C
    # Flat (expert, row, slot) index of each route, so that the buffer is
    # already (E, B·C, d), one batched product per expert; a dropped route
    # (or one to another rank's expert) is written to the spare row n_slots.
    e_loc = expert_idx - e_offset
    keep = pos < C
    if E != cfg.n_experts:
        keep = keep & (e_loc >= 0) & (e_loc < E)
        gate_vals = torch.where(keep, gate_vals, torch.zeros_like(gate_vals))
    b_ix = torch.arange(B, device=x.device)[:, None, None]
    slot = ((e_loc * B + b_ix) * C + pos).reshape(-1)
    keep = keep.reshape(-1)
    xk = x.to(cd)[:, :, None, :].expand(B, S, K, d).reshape(-1, d)
    buf = torch.zeros((n_slots + 1, d), dtype=cd, device=x.device)
    buf[torch.where(keep, slot, n_slots)] = xk  # only the spare row repeats
    hb = buf[:n_slots].view(E, B * C, d)
    w_gate, w_in, w_out = (weights[k].to(cd) for k in ("w_gate", "w_in", "w_out"))
    g = torch.bmm(hb, w_gate)
    h = torch.bmm(hb, w_in)
    h = F.silu(g.float()).to(cd) * h
    eo = _bmm_f32(h, w_out).view(n_slots, d)                   # float32
    # Combine: each token's K outputs, gated, summed over k in order.  A
    # dropped route reads slot 0 under a zero gate, which adds nothing.
    picked = eo[torch.where(keep, slot, 0)].view(B, S, K, d)
    return (picked * gate_vals[..., None]).sum(dim=2)


def _shared(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The shared experts over every token, in the compute dtype; on a
    mesh a partial sum over ``model`` when their stack is split there."""
    cd = cfg.cdtype
    sw_g, sw_i, sw_o = (gather_dp(p["shared"][k]).to(cd) for k in ("w_gate", "w_in", "w_out"))
    n, d, f = sw_g.shape
    xs = x.to(cd)
    sg = torch.matmul(xs, sw_g.permute(1, 0, 2).reshape(d, n * f))
    sh = torch.matmul(xs, sw_i.permute(1, 0, 2).reshape(d, n * f))
    sh = F.silu(sg.float()).to(cd) * sh
    return torch.matmul(sh, sw_o.reshape(n * f, d))


def _use_expert_parallel(cfg: ModelConfig, x) -> bool:
    """The reference's condition for its ``shard_map`` branch: a mesh with
    ``model`` dividing E and data-parallel axes dividing the batch (here
    also: the operands are DTensors)."""
    mesh = current_mesh()
    return (mesh is not None and isinstance(x, DTensor)
            and "model" in mesh.mesh_dim_names
            and cfg.n_experts % mesh.size(mesh.mesh_dim_names.index("model")) == 0
            and x.shape[0] % dp_size(mesh) == 0)


def _experts_parallel(p: dict, cfg: ModelConfig, x, expert_idx, gate_vals, pos, C):
    """Each rank's ``E / model`` experts on its batch shard → float32
    (B, S, d), a partial sum over ``model``."""
    mesh = current_mesh()
    names = mesh.mesh_dim_names
    m = names.index("model")
    E_loc = cfg.n_experts // mesh.size(m)
    act = placements_of(mesh, logical_to_spec(mesh, ("dp", None, None)))
    w_pl = tuple(Shard(0) if i == m else Replicate() for i in range(mesh.ndim))
    out_pl = [Partial() if i == m else pl for i, pl in enumerate(act)]
    e_offset = mesh.get_local_rank("model") * E_loc

    def block(x_l, ei_l, gv_l, pos_l, wg, wi, wo):
        return _experts({"w_gate": wg, "w_in": wi, "w_out": wo}, cfg, x_l, ei_l,
                        gv_l, pos_l, C, e_offset, E_loc)

    # Gradients: a rank's tokens get their share from its experts only
    # (a partial sum over model), its experts theirs from its batch shard
    # only (a partial sum over the data-parallel axes).
    g_act = tuple(out_pl)
    g_w = tuple(Shard(0) if i == m else Partial() for i in range(mesh.ndim))
    ws = [p["experts"][k] for k in ("w_gate", "w_in", "w_out")]
    return local_map(block, out_placements=out_pl,
                     in_placements=(act, act, act, act, w_pl, w_pl, w_pl),
                     in_grad_placements=(g_act, act, g_act, act, g_w, g_w, g_w),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, expert_idx, gate_vals, pos, *ws)


def moe(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x (B, S, d) → (y (B, S, d) in the compute dtype, aux loss float32)."""
    cd = cfg.cdtype
    E = cfg.n_experts
    C = _capacity(cfg, x.shape[1])
    probs, expert_idx, gate_vals, pos = _route(gather_dp(p["router"]["w"]), cfg, x, C)
    # Switch load-balance loss on the full routing probabilities.
    frac = F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = cfg.router_aux_coef * E * torch.sum(frac * probs.mean(dim=(0, 1)))
    if not _use_expert_parallel(cfg, x):
        y = _experts(p["experts"], cfg, x, expert_idx, gate_vals, pos, C).to(cd)
        if "shared" in p:
            y = y + _shared(p, cfg, x)
        return shard_activation(y, "dp", None, None), aux
    y = _experts_parallel(p, cfg, x, expert_idx, gate_vals, pos, C)
    s = _shared(p, cfg, x) if "shared" in p else None
    if s is not None and any(pl.is_partial() for pl in s.placements):
        y = y + s.float()  # one partial sum, so one all-reduce below
        s = None
    y = shard_activation(y, "dp", None, None).to(cd)  # the psum
    if s is not None:  # constrained again for the gradient s gets
        y = shard_activation(y + s, "dp", None, None)
    return y, aux
