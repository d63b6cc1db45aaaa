"""AdamW with optional block-quantized 8-bit moments.

Port of :mod:`repro.train.optimizer`.  8-bit moments are block-wise absmax
int8 (block 64 along the last axis, the 8-bit-Adam recipe
[arXiv:2110.02861]): per tensor ``q`` int8 blocks and ``scale`` float32 per
block; ``m`` uses signed absmax, ``v`` is stored in the square-root domain.
Also here: global-norm clipping and the cosine schedule.

Parameters, gradients and moments are nested dicts of tensors (the
reference's pytrees).  :func:`adamw_update` is pure by default, as in the
reference; with ``inplace=True`` it writes each new parameter and moment
into the tensors it was given, one leaf at a time, so a full-width step
holds one leaf's temporaries instead of a second copy of everything (the
train step's ``donate``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

__all__ = [
    "AdamWConfig",
    "QuantizedTensor",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "clip_by_global_norm",
]

_BLOCK = 64


# ---------------------------------------------------------------------------
# block-wise int8 quantization
# ---------------------------------------------------------------------------


def _pad_to_block(x: torch.Tensor):
    """Block along the LAST axis, keeping the leading structure intact."""
    pad = (-x.shape[-1]) % _BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, _BLOCK), pad


class QuantizedTensor:
    """int8 blocks + float32 scales; ``shape``, ``pad`` and ``sqrt_domain``
    are plain attributes (the reference keeps them as static pytree aux
    data)."""

    def __init__(self, q, scale, *, shape, pad, sqrt_domain):
        self.q = q
        self.scale = scale
        self.shape = tuple(shape)
        self.pad = pad
        self.sqrt_domain = sqrt_domain


def _quantize(x: torch.Tensor, signed: bool = True) -> QuantizedTensor:
    """Blockwise absmax int8.  Unsigned tensors (the v moment, v >= 0) are
    stored in the SQRT domain: v spans many orders of magnitude within a
    block, and linear quantization would collapse small entries to 0."""
    if not signed:
        x = torch.sqrt(torch.clamp(x, min=0.0))
    blocks, pad = _pad_to_block(x)
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale[..., 0], shape=x.shape, pad=pad,
                           sqrt_domain=not signed)


def _dequantize(s: QuantizedTensor) -> torch.Tensor:
    x = s.q.float() * s.scale[..., None]
    x = x.reshape(*s.shape[:-1], -1)  # merge (nb, BLOCK) → padded last axis
    out = x[..., : s.shape[-1]]
    if s.sqrt_domain:
        out = out * out
    return out


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moments_dtype: str = "float32"  # float32 | int8
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def _leaves_like(ref, tree) -> list:
    """``tree``'s subtrees at the leaf positions of the dict tree ``ref``,
    in ``ref``'s leaf order (the reference's ``flatten_up_to``)."""
    if isinstance(ref, dict):
        return [x for k in ref for x in _leaves_like(ref[k], tree[k])]
    return [tree]


def adamw_init(cfg: AdamWConfig, params: dict) -> dict:
    """``{"step": int32 0, "mu": params' tree of {"m", "v"}}`` on the
    parameters' devices."""
    def one(p):
        # zeros_like: a DTensor parameter's moments take its placements
        z = torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
        if cfg.moments_dtype == "int8":
            return {"m": _quantize(z), "v": _quantize(z, signed=False)}
        return {"m": z, "v": torch.zeros_like(z)}

    device = pytree.tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": pytree.tree_map(one, params)}


def global_norm(tree) -> torch.Tensor:
    leaves = pytree.tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2) for leaf in leaves))


def clip_by_global_norm(tree, max_norm: float):
    g = global_norm(tree)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return pytree.tree_map(lambda leaf: (leaf * scale).to(leaf.dtype), tree), g


def adamw_update(cfg: AdamWConfig, grads: dict, state: dict, params: dict, *,
                 inplace: bool = False):
    """→ (new_params, new_state, metrics).  ``inplace=True`` writes the new
    values into ``params`` and ``state`` (and returns them)."""
    step = state["step"] + 1
    lr = cfg.schedule(step) if cfg.schedule is not None else cfg.lr
    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        grads, _ = clip_by_global_norm(grads, cfg.clip_norm)

    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()

    def one(g, mu, p):
        gf = g.float()
        if cfg.moments_dtype == "int8":
            m, v = _dequantize(mu["m"]), _dequantize(mu["v"])
        else:
            m, v = mu["m"], mu["v"]
        m = cfg.b1 * m + (1 - cfg.b1) * gf
        v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        del gf
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (upd + cfg.weight_decay * pf)
        if cfg.moments_dtype == "int8":
            new_mu = {"m": _quantize(m), "v": _quantize(v, signed=False)}
        else:
            new_mu = {"m": m, "v": v}
        if not inplace:
            return pf.to(p.dtype), new_mu
        p.copy_(pf)
        for k in ("m", "v"):
            if cfg.moments_dtype == "int8":
                mu[k].q.copy_(new_mu[k].q)
                mu[k].scale.copy_(new_mu[k].scale)
            else:
                mu[k].copy_(new_mu[k])
        return p, mu

    flat_g, tdef = pytree.tree_flatten(grads)
    flat_mu = _leaves_like(grads, state["mu"])
    flat_p = _leaves_like(grads, params)
    new_p, new_mu = [], []
    for g, mu, p in zip(flat_g, flat_mu, flat_p):
        np_, nmu = one(g, mu, p)
        new_p.append(np_)
        new_mu.append(nmu)
    # torch.full, not as_tensor: no host-to-device copy (a recorded step holds none)
    lr_t = (lr.to(torch.float32) if isinstance(lr, torch.Tensor)
            else torch.full((), lr, dtype=torch.float32, device=gnorm.device))
    metrics = {"grad_norm": gnorm, "lr": lr_t}
    if inplace:
        state["step"].copy_(step)
        return params, state, metrics
    new_state = {"step": step, "mu": pytree.tree_unflatten(new_mu, tdef)}
    return pytree.tree_unflatten(new_p, tdef), new_state, metrics


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = s / max(1.0, float(warmup))
        prog = torch.clamp((s - warmup) / max(1.0, float(total - warmup)), 0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(s < warmup, warm, cos)

    return fn
