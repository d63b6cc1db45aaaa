"""Dense feed-forward blocks: SwiGLU (llama lineage), GELU, GeGLU.

Port of :mod:`repro.models.mlp`, with the reference's two sharding
constraints (``shard_activation``; no-ops off a mesh).
GELU is ``jax.nn.gelu``'s default, the tanh approximation
(``approximate="tanh"``), applied in float32 as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import shard_activation
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear

__all__ = ["mlp_params", "mlp"]

_GATED = ("swiglu", "geglu")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp_params(gen: torch.Generator, cfg: ModelConfig, device,
               lead: tuple = ()) -> dict:
    """Weights stacked along ``lead`` (the layer axis): ``w_gate``,
    ``w_in`` and ``w_out`` for the gated activations, ``w_in`` and
    ``w_out`` for GELU."""
    if cfg.act not in _GATED + ("gelu",):
        raise ValueError(f"activation {cfg.act!r}")
    d, d_ff = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.act in _GATED:
        p["w_gate"] = dense_init(gen, d, d_ff, cfg.pdtype, device, lead=lead)
    p["w_in"] = dense_init(gen, d, d_ff, cfg.pdtype, device, lead=lead)
    p["w_out"] = dense_init(gen, d_ff, d, cfg.pdtype, device, lead=lead)
    return p


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    cd = cfg.cdtype
    h = linear(x, p["w_in"], compute_dtype=cd)
    if cfg.act in _GATED:
        g = linear(x, p["w_gate"], compute_dtype=cd)
        act = F.silu if cfg.act == "swiglu" else _gelu
        h = act(g.float()).to(cd) * h
    else:
        h = _gelu(h.float()).to(cd)
    h = shard_activation(h, "dp", None, "model")
    y = linear(h, p["w_out"], compute_dtype=cd)
    return shard_activation(y, "dp", None, None)
