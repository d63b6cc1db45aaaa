"""Decoder-only LM, dense path: parameters, embedding, prefill, head.

Port of the dense path of :mod:`repro.models.transformer` (``_embed``,
``_head``, ``_stack_names``, ``_layer_stacks``, ``_block_decode``
``:138``, ``prefill`` ``:309``, ``decode_step`` ``:358``,
``init_cache``).  Layer parameters keep the reference's stacked leading
layer axis and keys, so a JAX params pytree converts leaf for leaf
(:mod:`repro_torch.models.convert`); the reference's ``lax.scan`` over
layers is a Python loop over that axis.  MoE, SSM and hybrid stacks,
embeddings routed through ``async_query`` and tied heads belong to later
slices and raise ``NotImplementedError``.

Entry points:
  init_params(cfg, seed, device)              → params dict
  prefill(cfg, params, tokens, max_len=...)   → (logits, cache)
  decode_step(cfg, params, token, cache, lengths) → (logits, cache)
  init_cache(cfg, batch, max_len, device)     → stacked KV cache

``decode_step`` writes the cache in place and returns the dict it got
(the reference returns a new pytree and relies on buffer donation).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    attention,
    attn_params,
    decode_attention,
    init_kv_cache,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm, dense_init, embed_init
from repro_torch.models.mlp import mlp, mlp_params

__all__ = ["init_params", "prefill", "decode_step", "init_cache", "block_kind"]


def block_kind(cfg: ModelConfig, moe_stack: bool) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.hybrid:
        return "hybrid"
    if cfg.is_moe and moe_stack:
        return "moe"
    return "dense"


def _check_dense(cfg: ModelConfig) -> None:
    if any(kind != "dense" for _n, kind, _c in _stack_names(cfg)):
        raise NotImplementedError(
            f"{cfg.name}: only the dense family is ported so far")
    if cfg.norm != "rmsnorm" or cfg.tie_embeddings or cfg.query_embedding:
        raise NotImplementedError(
            f"{cfg.name}: norm {cfg.norm!r}, tied embeddings and the "
            "async_query embedding are not ported yet")


def _norm_params(cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    return {"w": torch.ones(lead + (cfg.d_model,), dtype=cfg.pdtype, device=device)}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random dense-decoder weights drawn from ``torch.Generator(seed)`` on
    ``device`` (same shapes, keys and scales as the reference's
    ``init_params``; different numbers, since the generators differ)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lead = (cfg.n_layers,)
    return {
        "embed": {"table": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                      cfg.pdtype, dev)},
        "layers": {
            "ln1": _norm_params(cfg, dev, lead),
            "attn": attn_params(gen, cfg, dev, lead),
            "ln2": _norm_params(cfg, dev, lead),
            "mlp": mlp_params(gen, cfg, dev, lead),
        },
        "final_norm": _norm_params(cfg, dev),
        "lm_head": {"w": dense_init(gen, cfg.d_model, cfg.vocab_size,
                                    cfg.pdtype, dev)},
    }


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    if cfg.query_embedding:
        raise NotImplementedError("the async_query embedding is not ported yet")
    return params["embed"]["table"][tokens.long()].to(cfg.cdtype)


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32 from float32 accumulators, as the reference's
    ``preferred_element_type=float32``: a bf16 product rounded to bf16
    would break greedy ties over the 128k vocabulary differently.  On the
    card ``torch.mm(..., out_dtype=float32)`` keeps the bf16 operands; on
    the CPU (where that overload is not registered) the operands are
    widened to float32 first, which is exact."""
    if cfg.tie_embeddings:
        raise NotImplementedError("tied embeddings are not ported yet")
    cd = cfg.cdtype
    xs, w = x.to(cd), params["lm_head"]["w"].to(cd)
    if cd == torch.float32:
        return torch.matmul(xs, w)
    if xs.is_cuda:
        out = torch.mm(xs.reshape(-1, xs.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*xs.shape[:-1], w.shape[-1])
    return torch.matmul(xs.float(), w.float())


def _stack_names(cfg: ModelConfig):
    out = []
    if cfg.is_moe and cfg.first_dense_layers > 0:
        out.append(("dense_layers", "dense", cfg.first_dense_layers))
    n_main = cfg.n_layers - (cfg.first_dense_layers if cfg.is_moe else 0)
    out.append(("layers", block_kind(cfg, True), n_main))
    return out


def _layer_stacks(cfg: ModelConfig, params: dict):
    """[(stacked_params, kind, n_layers)] in execution order."""
    out = []
    if cfg.is_moe and cfg.first_dense_layers > 0:
        out.append((params["dense_layers"], "dense", cfg.first_dense_layers))
    n_main = cfg.n_layers - (cfg.first_dense_layers if cfg.is_moe else 0)
    out.append((params["layers"], block_kind(cfg, True), n_main))
    return out


def layer_slice(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters (views) out of a stacked parameter dict."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> dict:
    """Stacked decode cache for every stack, keyed by stack name."""
    _check_dense(cfg)
    dev = resolve_device(device)
    return {name: init_kv_cache(cfg, batch, max_len, dev, n_layers=n)
            for name, _kind, n in _stack_names(cfg)}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: Optional[int] = None, return_all_logits: bool = False):
    """Full-sequence prefill of ``tokens`` (B, S) → (logits, cache).

    Logits are (B, V) at the last position, or (B, S, V) with
    ``return_all_logits`` for right-padded serving batches; the cache is
    ``{stack: {"k", "v": (L, B, S or max_len, Hkv, hd)}}``.  Right-padded
    prompts are safe: causal masking keeps pad keys invisible to real
    queries.  Runs on the device ``tokens`` and ``params`` live on.
    """
    _check_dense(cfg)
    x = _embed(cfg, params, tokens)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    pad = (max_len - S) if max_len is not None and max_len > S else 0
    caches = {}
    for (name, _kind, n), (stacked, _k2, _n2) in zip(
            _stack_names(cfg), _layer_stacks(cfg, params)):
        shape = (n, B, S + pad, cfg.n_kv_heads, cfg.hd)
        ck = torch.zeros(shape, dtype=cfg.cdtype, device=x.device)
        cv = torch.zeros(shape, dtype=cfg.cdtype, device=x.device)
        for i in range(n):
            lp = layer_slice(stacked, i)
            h = apply_norm(cfg.norm, lp["ln1"], x)
            a, (k, v) = attention(lp["attn"], cfg, h, positions, causal=True,
                                  return_kv=True)
            ck[i, :, :S] = k
            cv[i, :, :S] = v
            x = x + a
            x = x + mlp(lp["mlp"], cfg, apply_norm(cfg.norm, lp["ln2"], x))
        caches[name] = {"k": ck, "v": cv}
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if return_all_logits:
        return _head(cfg, params, x), caches
    return _head(cfg, params, x[:, -1:])[:, 0], caches


def _block_decode(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                  cache_k: torch.Tensor, cache_v: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """One dense block's one-token decode; ``cache_k``/``cache_v`` are this
    layer's (B, S_max, Hkv, hd) slices, written in place."""
    if kind != "dense":
        raise NotImplementedError(f"decode of {kind!r} blocks is not ported yet")
    window = cfg.attn_window if cfg.attn_window > 0 else None
    h = apply_norm(cfg.norm, p["ln1"], x)
    a, _k, _v = decode_attention(p["attn"], cfg, h, cache_k, cache_v, lengths,
                                 window=window)
    x = x + a
    return x + mlp(p["mlp"], cfg, apply_norm(cfg.norm, p["ln2"], x))


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, lengths: torch.Tensor):
    """Batched one-token decode over the dense stacked cache.

    ``token``/``lengths`` (B,) int32 on the device of ``params``;
    ``cache`` is ``{stack: {"k", "v": (L, B, S_max, Hkv, hd)}}``.  Updates
    ``cache`` in place and returns ``(logits (B, V) float32, cache)``.
    """
    _check_dense(cfg)
    x = _embed(cfg, params, token[:, None])
    for (name, kind, n), (stacked, _k2, _n2) in zip(
            _stack_names(cfg), _layer_stacks(cfg, params)):
        ck, cv = cache[name]["k"], cache[name]["v"]
        for i in range(n):
            x = _block_decode(layer_slice(stacked, i), cfg, kind, x, ck[i], cv[i],
                              lengths)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x)[:, 0], cache
