"""Encoder-decoder backbone (seamless-m4t-medium [arXiv:2308.11596]).

Port of :mod:`repro.models.encdec`: a bidirectional encoder over (stub)
audio-frame embeddings and a causal decoder with cross attention over the
encoder's memory; pre-LN LayerNorm, the GELU FFN, standard RoPE on
self-attention and none on cross attention.  Parameters keep the
reference's keys and stacked layer axes (``enc_layers``, ``enc_norm``,
``layers`` with ``ln_cross`` and ``cross_attn``), and the reference's
``lax.scan`` over layers is a loop over that axis, as in
:mod:`repro_torch.models.transformer`.  Every attention goes through the
port's ops: the encoder's self-attention and the decoder's cross attention
through the ``flash_attention`` op without a mask (T != S for cross), the
decoder's self-attention through it with the causal mask; at decode the
self-attention and the cross attention over the fixed memory KV
(:func:`~repro_torch.models.attention.cross_decode`) through the
``decode_attention`` op.

Decode path: the self-attention KV cache, padded to ``max_len`` and
written in place, and per-layer cross KV computed once from the memory at
prefill and only read afterwards.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import shard_activation
from repro_torch.models.attention import attention, attn_params, cross_decode, decode_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm, dense_init, embed_init, norm_params
from repro_torch.models.mlp import mlp, mlp_params
from repro_torch.models.transformer import _head, embed_lookup, layer_slice

__all__ = [
    "init_params_encdec",
    "encode",
    "forward_encdec",
    "prefill_encdec",
    "decode_step_encdec",
    "init_cache_encdec",
]


def _norm(cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    return norm_params(cfg.norm, cfg.d_model, cfg.pdtype, device, lead)


def init_params_encdec(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights drawn from ``torch.Generator(seed)`` on ``device``:
    the reference's keys, shapes, scales and dtypes (other numbers)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ne, nd = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": {"table": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.pdtype, dev)},
        "enc_layers": {"ln1": _norm(cfg, dev, ne), "attn": attn_params(gen, cfg, dev, ne),
                       "ln2": _norm(cfg, dev, ne), "mlp": mlp_params(gen, cfg, dev, ne)},
        "enc_norm": _norm(cfg, dev),
        "layers": {"ln1": _norm(cfg, dev, nd), "attn": attn_params(gen, cfg, dev, nd),
                   "ln_cross": _norm(cfg, dev, nd),
                   "cross_attn": attn_params(gen, cfg, dev, nd),
                   "ln2": _norm(cfg, dev, nd), "mlp": mlp_params(gen, cfg, dev, nd)},
        "final_norm": _norm(cfg, dev),
        "lm_head": {"w": dense_init(gen, cfg.d_model, cfg.vocab_size, cfg.pdtype, dev)},
    }


def _remat(fn, *args):
    """``fn(*args)``, recomputed in the backward (``cfg.remat`` in
    training, as the reference's ``jax.checkpoint`` of each layer)."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _enc_block(lp: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = x + attention(lp["attn"], cfg, apply_norm(cfg.norm, lp["ln1"], x), causal=False)
    return x + mlp(lp["mlp"], cfg, apply_norm(cfg.norm, lp["ln2"], x))


def encode(cfg: ModelConfig, params: dict, src_embeds: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """src_embeds (B, S_src, d) from the (stub) audio frontend → the memory
    (B, S_src, d), after ``enc_norm``; ``remat`` recomputes each layer in
    the backward."""
    x = shard_activation(src_embeds.to(cfg.cdtype), "dp", None, None)
    for i in range(cfg.n_enc_layers):
        lp = layer_slice(params["enc_layers"], i)
        x = _remat(_enc_block, lp, cfg, x) if remat else _enc_block(lp, cfg, x)
    return apply_norm(cfg.norm, params["enc_norm"], x)


def _embed_tgt(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    # the vocabulary-parallel gather is a partial sum over `model`
    return shard_activation(embed_lookup(cfg, params["embed"]["table"], tokens), "dp", None, None)


def _dec_block(lp: dict, cfg: ModelConfig, x: torch.Tensor, memory: torch.Tensor,
               return_kv: bool = False):
    """One decoder block over the full target: causal self-attention,
    cross attention over ``memory``, the MLP; with ``return_kv`` also
    the self KV and the cross KV."""
    a, kv = attention(lp["attn"], cfg, apply_norm(cfg.norm, lp["ln1"], x), causal=True,
                      return_kv=True)
    x = x + a
    c, xkv = attention(lp["cross_attn"], cfg, apply_norm(cfg.norm, lp["ln_cross"], x),
                       causal=False, kv_x=memory, return_kv=True)
    x = x + c
    x = x + mlp(lp["mlp"], cfg, apply_norm(cfg.norm, lp["ln2"], x))
    return (x, kv, xkv) if return_kv else x


def forward_encdec(cfg: ModelConfig, params: dict, src_embeds: torch.Tensor,
                   tgt_tokens: torch.Tensor):
    """Training forward: encode once, teacher-forced decoder →
    (logits (B, S, V) float32, aux 0); ``cfg.remat`` recomputes each
    encoder and decoder layer in the backward."""
    memory = encode(cfg, params, src_embeds, remat=cfg.remat)
    x = _embed_tgt(cfg, params, tgt_tokens)
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        x = (_remat(_dec_block, lp, cfg, x, memory) if cfg.remat
             else _dec_block(lp, cfg, x, memory))
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x), torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache_encdec(cfg: ModelConfig, batch: int, max_len: int, src_len: int,
                      device="cuda") -> dict:
    """``{"k", "v"}`` (L, B, max_len, Hkv, hd) self KV and ``{"cross_k",
    "cross_v"}`` (L, B, src_len, Hkv, hd), zeros."""
    dev = resolve_device(device)
    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    out = {}
    for key, rows in (("k", max_len), ("v", max_len), ("cross_k", src_len),
                      ("cross_v", src_len)):
        out[key] = torch.zeros((L, batch, rows, hkv, hd), dtype=cfg.cdtype, device=dev)
    return out


def prefill_encdec(cfg: ModelConfig, params: dict, src_embeds: torch.Tensor,
                   tgt_tokens: torch.Tensor, max_len: Optional[int] = None):
    """Encode + decoder prefill → (logits (B, V) float32 at the last target
    position, cache): the self KV padded to ``max_len`` (when longer than
    the target) and the cross KV of every layer."""
    memory = encode(cfg, params, src_embeds)
    x = _embed_tgt(cfg, params, tgt_tokens)
    B, S = x.shape[:2]
    cache = init_cache_encdec(cfg, B, max(S, max_len or 0), memory.shape[1], x.device)
    for i in range(cfg.n_layers):
        x, (k, v), (xk, xv) = _dec_block(layer_slice(params["layers"], i), cfg, x, memory,
                                          return_kv=True)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        cache["cross_k"][i] = xk
        cache["cross_v"][i] = xv
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x[:, -1:])[:, 0], cache


def decode_step_encdec(cfg: ModelConfig, params: dict, token: torch.Tensor, cache: dict,
                       lengths: torch.Tensor):
    """One decoder token per lane: ``token``/``lengths`` (B,) int32.  The
    self KV is written in place at ``min(lengths, max_len - 1)``; the cross
    KV is read only.  → (logits (B, V) float32, cache)."""
    x = _embed_tgt(cfg, params, token[:, None])
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        a, _k, _v = decode_attention(lp["attn"], cfg, apply_norm(cfg.norm, lp["ln1"], x),
                                     cache["k"][i], cache["v"][i], lengths)
        x = x + a
        x = x + cross_decode(lp["cross_attn"], cfg, apply_norm(cfg.norm, lp["ln_cross"], x),
                             cache["cross_k"][i], cache["cross_v"][i])
        x = x + mlp(lp["mlp"], cfg, apply_norm(cfg.norm, lp["ln2"], x))
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x)[:, 0], cache
