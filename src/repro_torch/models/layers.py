"""Shared layers: norms, RoPE variants, initializers, ``linear``.

Port of :mod:`repro.models.layers` (``rmsnorm`` ``:64``, ``layernorm``
``:71``, ``nonparam_ln`` ``:80``, ``norm_params``, ``apply_norm``,
``apply_rope`` ``:125``, ``apply_rope_half`` ``:141``, ``apply_mrope``
``:155``).  Norms and RoPE run in float32 whatever the compute dtype, as
in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.distributed.sharding import gather_dp

__all__ = [
    "dense_init",
    "embed_init",
    "rmsnorm",
    "layernorm",
    "nonparam_ln",
    "norm_params",
    "apply_norm",
    "rope_freqs",
    "apply_rope",
    "apply_rope_half",
    "apply_mrope",
    "linear",
]


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device, scale: Optional[float] = None,
               lead: tuple = ()) -> torch.Tensor:
    """``lead + (in_dim, out_dim)`` normal weights scaled by 1/sqrt(in_dim)
    (``lead`` is the stacked layer axis)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn(lead + (in_dim, out_dim), generator=gen, device=device)
    return w.mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device) -> torch.Tensor:
    """(vocab, dim) normal embedding table with std 0.02."""
    w = torch.randn((vocab, dim), generator=gen, device=device)
    return w.mul_(0.02).to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """``x @ w`` over the last axis in ``compute_dtype`` (the matmul
    accumulates in float32 on the card for bf16 inputs); a sharded weight
    is used whole over the data-parallel axes (``gather_dp``)."""
    cd = compute_dtype or x.dtype
    return torch.matmul(x.to(cd), gather_dp(w).to(cd))


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    nrm = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (nrm * weight.float()).to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).pow(2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def nonparam_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no scale/bias) [arXiv:2402.00838]."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).pow(2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dt)


def norm_params(kind: str, dim: int, dtype, device, lead: tuple = ()) -> dict:
    """A norm's leaves, stacked along ``lead``: ``{"w"}`` of ones for
    RMSNorm, ``{"w", "b"}`` (ones, zeros) for LayerNorm, none for OLMo's."""
    shape = lead + (dim,)
    if kind == "rmsnorm":
        return {"w": torch.ones(shape, dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"w": torch.ones(shape, dtype=dtype, device=device),
                "b": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "nonparam_ln":
        return {}
    raise ValueError(kind)


def apply_norm(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    if kind == "layernorm":
        return layernorm(x, p["w"], p["b"])
    if kind == "nonparam_ln":
        return nonparam_ln(x)
    raise ValueError(kind)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for a rotary dim (must be even)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    # Halves convention: rotate (x1, x2) pairs split across the last axis.
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               theta: float):
    """Standard RoPE [arXiv:2104.09864] over the full head dim.

    q: (B, S, H, D), k: (B, S, Hkv, D), positions: (B, S) integer.
    """
    d = q.shape[-1]
    inv = rope_freqs(d, theta, device=q.device)               # (d/2,)
    ang = positions[..., None].float() * inv                  # (B, S, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return (_rotate(q.float(), cos, sin).to(q.dtype),
            _rotate(k.float(), cos, sin).to(k.dtype))


def apply_rope_half(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                    theta: float):
    """ChatGLM's 2D RoPE: rotary on the first half of the head dim only,
    with the frequencies of that half (``rope_freqs(d // 2)``, as the
    reference calls ``apply_rope`` on the slices); the second half passes
    through unchanged."""
    rot = q.shape[-1] // 2
    q1, k1 = apply_rope(q[..., :rot], k[..., :rot], positions, theta)
    return (torch.cat([q1, q[..., rot:]], dim=-1),
            torch.cat([k1, k[..., rot:]], dim=-1))


def apply_mrope(q: torch.Tensor, k: torch.Tensor, positions3: torch.Tensor,
                theta: float, sections):
    """Qwen2-VL's M-RoPE [arXiv:2409.12191]: the d/2 frequencies are cut
    into (temporal, height, width) ``sections``, and frequency f rotates by
    the position of its section's row of ``positions3`` (3, B, S).  Where
    the three rows are equal (text tokens) it is :func:`apply_rope`."""
    d = q.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not cover d/2 = {d // 2}")
    inv = rope_freqs(d, theta, device=q.device)               # (d/2,)
    # (d/2,) row of each frequency, built on the device: no host copy, so
    # a CUDA graph of the decode step can hold it.
    idx = torch.arange(d // 2, device=q.device)
    sec_id = torch.zeros_like(idx)
    edge = 0
    for n in sections[:-1]:
        edge += n
        sec_id += (idx >= edge).long()
    pos = positions3.float()[sec_id]                          # (d/2, B, S)
    ang = pos.permute(1, 2, 0) * inv                          # (B, S, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return (_rotate(q.float(), cos, sin).to(q.dtype),
            _rotate(k.float(), cos, sin).to(k.dtype))
