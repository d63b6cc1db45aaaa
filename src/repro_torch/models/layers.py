"""Shared layers: RMSNorm, standard RoPE, initializers, ``linear``.

Port of :mod:`repro.models.layers` (``rmsnorm`` ``:64``, ``apply_norm``,
``apply_rope`` ``:125``).  Norms and RoPE run in float32 whatever the
compute dtype, as in the reference.  The other norms and RoPE variants
(layernorm, ChatGLM's half RoPE, M-RoPE) belong to later slices and raise
``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = [
    "dense_init",
    "embed_init",
    "rmsnorm",
    "apply_norm",
    "rope_freqs",
    "apply_rope",
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
    accumulates in float32 on the card for bf16 inputs)."""
    cd = compute_dtype or x.dtype
    return torch.matmul(x.to(cd), w.to(cd))


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    nrm = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (nrm * weight.float()).to(dt)


def apply_norm(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    raise NotImplementedError(f"norm {kind!r} is not ported yet")


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
