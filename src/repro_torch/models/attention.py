"""Grouped-query attention with RoPE and the stacked KV cache.

Port of :mod:`repro.models.attention` (``_project_qkv`` ``:52``, ``_rope``,
``attention`` ``:94``, ``init_kv_cache`` ``:176``, ``decode_attention``
``:186``).  The reference computes attention in plain jnp; here causal
self-attention goes through the ``flash_attention`` op and one-token
decode through the ``decode_attention`` op, i.e. the hand-written CUDA
kernels on the card and their plain versions on the CPU.  The model keeps
q/k/v as (B, S, H, hd); they reach the flash op as (B, H, S, hd) views,
which the kernel takes by strides, so no transpose is copied.

``decode_attention`` writes the new token's K/V into the cache **in
place** (the reference returns new arrays from ``.at[].set``).  The
reference masks ``idx <= min(length, S_max - 1)``, which includes the
token just written; the op attends ``[0, lengths)``, so it is called with
``min(length, S_max - 1) + 1``.

The causal mask is on token indices, which equals the reference's
position mask for the prefill positions ``arange(S)`` the serving path
uses.  In prefill, sliding windows (``cfg.attn_window``),
``cfg.attn_chunk`` and cross-attention (``kv_x``) run the plain version on
the CPU and raise ``NotImplementedError`` on the card for now; the
windowed (ring-buffer) decode raises on every device.

Shapes:
  x          (B, S, d_model)
  q          (B, S, H, hd)      k/v (B, S, Hkv, hd)
  cache k/v  (L, B, S_max, Hkv, hd); one layer's slice (B, S_max, Hkv, hd)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ops import decode_op
from repro_torch.kernels.flash_attention.ops import attention_op
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init

__all__ = ["attn_params", "attention", "decode_attention", "init_kv_cache"]


def attn_params(gen: torch.Generator, cfg: ModelConfig, device,
                lead: tuple = ()) -> dict:
    """wq (d, H, hd), wk/wv (d, Hkv, hd), wo (H, hd, d), stacked on ``lead``."""
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias is not ported yet")
    d, hd, h, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    pd = cfg.pdtype
    return {
        "wq": dense_init(gen, d, h * hd, pd, device, lead=lead).reshape(lead + (d, h, hd)),
        "wk": dense_init(gen, d, hkv * hd, pd, device, lead=lead).reshape(lead + (d, hkv, hd)),
        "wv": dense_init(gen, d, hkv * hd, pd, device, lead=lead).reshape(lead + (d, hkv, hd)),
        "wo": dense_init(gen, h * hd, d, pd, device, lead=lead).reshape(lead + (h, hd, d)),
    }


def _proj(x: torch.Tensor, w: torch.Tensor, cd) -> torch.Tensor:
    """(B, S, d) x (d, H, hd) → (B, S, H, hd) in ``cd``."""
    d, h, hd = w.shape
    return torch.matmul(x.to(cd), w.to(cd).reshape(d, h * hd)).unflatten(-1, (h, hd))


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, kv_x=None):
    cd = cfg.cdtype
    kv_x = x if kv_x is None else kv_x
    return _proj(x, p["wq"], cd), _proj(kv_x, p["wk"], cd), _proj(kv_x, p["wv"], cd)


def _rope(cfg: ModelConfig, q, k, positions):
    if cfg.rope == "standard":
        return apply_rope(q, k, positions, cfg.rope_theta)
    if cfg.rope == "none":
        return q, k
    raise NotImplementedError(f"rope {cfg.rope!r} is not ported yet")


def _out_proj(p: dict, cfg: ModelConfig, out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) x wo (H, hd, d) → (B, S, d) in the compute dtype."""
    cd = cfg.cdtype
    h, hd, d = p["wo"].shape
    return torch.matmul(out.to(cd).flatten(-2), p["wo"].to(cd).reshape(h * hd, d))


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True, kv_x=None,
              return_kv: bool = False):
    """Full-sequence attention (prefill).  ``kv_x`` != None is
    cross-attention (no RoPE on cross, as in the reference)."""
    q, k, v = _project_qkv(p, cfg, x, kv_x)
    if kv_x is None and cfg.rope != "none":
        q, k = _rope(cfg, q, k, positions)
    # (B, S, H, hd) buffers viewed as (B, H, S, hd); the op takes strides.
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    self_causal = causal and kv_x is None
    if kv_x is None and not cfg.attn_window and not cfg.attn_chunk:
        out = attention_op(qh, kh, vh, causal=self_causal)
    elif x.is_cuda:
        raise NotImplementedError(
            "sliding-window, chunked and cross attention have no CUDA kernel "
            "in the port yet")
    else:
        # attn_chunk is the same math in bounded memory: one plain pass.
        out = attention_ref(qh, kh, vh, causal=self_causal,
                            window=cfg.attn_window if self_causal else 0)
    y = _out_proj(p, cfg, out.transpose(1, 2))
    if return_kv:
        return y, (k, v)
    return y


def decode_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     lengths: torch.Tensor, *, window: Optional[int] = None):
    """One-token decode with KV-cache append.

    ``x`` (B, 1, d_model); ``cache_k``/``cache_v`` (B, S_max, Hkv, hd),
    this layer's slice, written in place; ``lengths`` (B,) int32, the
    current context length per lane.  The new K/V goes to slot
    ``min(lengths, S_max - 1)`` (a lane at capacity keeps rewriting its
    last row).  ``window`` (hymba's ring buffer) is not ported yet and
    raises.  Returns ``(y, cache_k, cache_v)``.
    """
    if window:
        raise NotImplementedError(
            "the ring-buffer (windowed) decode is not ported yet")
    b = x.shape[0]
    s_max = cache_k.shape[1]
    q, k_new, v_new = _project_qkv(p, cfg, x)
    if cfg.rope != "none":
        q, k_new = _rope(cfg, q, k_new, lengths[:, None])  # true positions
    slot = torch.clamp(lengths, max=s_max - 1).long()
    rows = torch.arange(b, device=x.device)
    cache_k.index_put_((rows, slot), k_new[:, 0].to(cache_k.dtype))
    cache_v.index_put_((rows, slot), v_new[:, 0].to(cache_v.dtype))
    out = decode_op(q[:, 0], cache_k, cache_v, (slot + 1).to(torch.int32))
    y = _out_proj(p, cfg, out.reshape(b, 1, cfg.n_heads, cfg.hd))
    return y, cache_k, cache_v


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                  n_layers=None) -> dict:
    """Stacked-over-layers KV cache (L, B, S, Hkv, hd)."""
    L = n_layers if n_layers is not None else cfg.n_layers
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}
