"""Dense feed-forward block: SwiGLU (llama lineage).

Port of :mod:`repro.models.mlp`.  The reference's sharding annotations
(``shard_activation``) have no counterpart on one card and are dropped;
GELU/GeGLU belong to later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear

__all__ = ["mlp_params", "mlp"]


def mlp_params(gen: torch.Generator, cfg: ModelConfig, device,
               lead: tuple = ()) -> dict:
    """SwiGLU weights, stacked along ``lead`` (the layer axis)."""
    if cfg.act != "swiglu":
        raise NotImplementedError(f"activation {cfg.act!r} is not ported yet")
    d, d_ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, d, d_ff, cfg.pdtype, device, lead=lead),
        "w_in": dense_init(gen, d, d_ff, cfg.pdtype, device, lead=lead),
        "w_out": dense_init(gen, d_ff, d, cfg.pdtype, device, lead=lead),
    }


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act != "swiglu":
        raise NotImplementedError(f"activation {cfg.act!r} is not ported yet")
    cd = cfg.cdtype
    g = linear(x, p["w_gate"], compute_dtype=cd)
    h = linear(x, p["w_in"], compute_dtype=cd)
    h = F.silu(g.float()).to(cd) * h
    return linear(h, p["w_out"], compute_dtype=cd)
