"""Grouped-query attention with RoPE, the KV cache, the ring buffer and
cross attention.

Port of :mod:`repro.models.attention` (``_project_qkv`` ``:52``, with the
QKV biases added in the compute dtype after the projection's cast,
``_rope`` ``:68`` with the standard, ChatGLM's half and Qwen2-VL's
M-RoPE, ``attention`` ``:94``, ``init_kv_cache`` ``:176``,
``decode_attention`` ``:186``) and of ``_cross_decode``
(``repro/models/encdec.py:184``).  The reference computes attention in
plain jnp; here every full-sequence attention goes through the
``flash_attention`` op and every one-token decode through the
``decode_attention`` op, i.e. the hand-written CUDA kernels on the card and
their plain versions on the CPU.  The model keeps q/k/v as (B, S, H, hd);
they reach the flash op as (B, H, S, hd) views, which the kernel takes by
strides, so no transpose is copied.

Masks of ``attention``: causal self-attention, banded by
``cfg.attn_window`` when it is set (the reference windows only causal
self-attention); the encoder's self-attention and cross attention
(``kv_x``, no RoPE, T != S) attend everything.  With ``positions=None``
(what the serving path and the training forward pass) the positions are
``arange(S)`` and the causal mask is on token indices; given positions
(an M-RoPE prefill over a patch grid, whose temporal row repeats) make it
compare them, as the reference's mask does.  ``cfg.attn_chunk`` is the
same math in bounded memory in the reference and changes nothing here.

``decode_attention`` writes the new token's K/V into the cache **in
place** (the reference returns new arrays from ``.at[].set``).  Without a
window the reference writes slot ``min(length, S_max - 1)`` and masks
``idx <= min(length, S_max - 1)``; the op attends ``[0, lengths)``, so it
is called with that slot + 1.  With a window (hymba's ring buffer) the
reference writes slot ``length % S_max`` and admits the slots whose age
``(slot - idx) % S_max`` is below ``min(length + 1, window)``.  A ring is
never longer than its window (``S_max = min(max_len, W)``), so those are
always the slots ``[0, min(length + 1, S_max))``, in ring order: the op
attends them with that length.  Softmax does not depend on the keys'
order, so the result is the reference's up to rounding.

On a mesh a decode runs where its cache lives: over caches sharded by
lanes or kv heads (or replicated) the op runs on each rank's shards, and
over caches whose rows are sharded (``kv_seq_shard``) the split-KV decode
of :mod:`repro_torch.distributed.split_kv` runs each rank's rows and
combines them with three all-reduces.

Shapes:
  x          (B, S, d_model)
  q          (B, S, H, hd)      k/v (B, S, Hkv, hd)
  cache k/v  (L, B, S_max, Hkv, hd); one layer's slice (B, S_max, Hkv, hd)
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import gather_dp, shard_activation
from repro_torch.distributed.split_kv import rows_split, split_kv_decode
from repro_torch.kernels.decode_attention.ops import decode_op
from repro_torch.kernels.flash_attention.ops import attention_op
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mrope, apply_rope, apply_rope_half, dense_init

__all__ = ["attn_params", "attention", "cross_decode", "decode_attention", "init_kv_cache"]


def attn_params(gen: torch.Generator, cfg: ModelConfig, device,
                lead: tuple = ()) -> dict:
    """wq (d, H, hd), wk/wv (d, Hkv, hd), wo (H, hd, d), stacked on ``lead``;
    with ``cfg.qkv_bias`` also bq (H, hd) and bk/bv (Hkv, hd), zeros as in
    the reference."""
    d, hd, h, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    pd = cfg.pdtype
    p = {
        "wq": dense_init(gen, d, h * hd, pd, device, lead=lead).reshape(lead + (d, h, hd)),
        "wk": dense_init(gen, d, hkv * hd, pd, device, lead=lead).reshape(lead + (d, hkv, hd)),
        "wv": dense_init(gen, d, hkv * hd, pd, device, lead=lead).reshape(lead + (d, hkv, hd)),
        "wo": dense_init(gen, h * hd, d, pd, device, lead=lead).reshape(lead + (h, hd, d)),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros(lead + (heads, hd), dtype=pd, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor, cd) -> torch.Tensor:
    """(B, S, d) x (d, H, hd) → (B, S, H, hd) in ``cd``."""
    d, h, hd = w.shape
    w = gather_dp(w).to(cd).reshape(d, h * hd)
    return torch.matmul(x.to(cd), w).unflatten(-1, (h, hd))


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, kv_x=None):
    cd = cfg.cdtype
    kv_x = x if kv_x is None else kv_x
    q, k, v = _proj(x, p["wq"], cd), _proj(kv_x, p["wk"], cd), _proj(kv_x, p["wv"], cd)
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def _rope(cfg: ModelConfig, q, k, positions):
    """RoPE by ``cfg.rope``; M-RoPE takes (3, B, S) positions and
    broadcasts (B, S) ones to three equal rows."""
    if cfg.rope == "standard":
        return apply_rope(q, k, positions, cfg.rope_theta)
    if cfg.rope == "half":
        return apply_rope_half(q, k, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        pos3 = positions if positions.dim() == 3 else positions.expand(3, *positions.shape)
        return apply_mrope(q, k, pos3, cfg.rope_theta, cfg.mrope_sections)
    if cfg.rope == "none":
        return q, k
    raise ValueError(cfg.rope)


def _out_proj(p: dict, cfg: ModelConfig, out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) x wo (H, hd, d) → (B, S, d) in the compute dtype."""
    cd = cfg.cdtype
    h, hd, d = p["wo"].shape
    wo = gather_dp(p["wo"]).to(cd).reshape(h * hd, d)
    y = torch.matmul(out.to(cd).contiguous().flatten(-2), wo)
    return shard_activation(y, "dp", None, None)


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None, *, causal: bool = True,
              kv_x=None, return_kv: bool = False):
    """Full-sequence attention (prefill, training, encoder, cross).
    ``kv_x`` != None is cross-attention (no RoPE on cross, as in the
    reference); ``positions`` (B, S), or (3, B, S) for M-RoPE, default to
    ``arange(S)`` (module docstring)."""
    q, k, v = _project_qkv(p, cfg, x, kv_x)
    if kv_x is None and cfg.rope != "none":
        rope_pos = positions
        if rope_pos is None:
            b, s = x.shape[:2]
            rope_pos = torch.arange(s, device=x.device).expand(b, s)
        q, k = _rope(cfg, q, k, rope_pos)
    q = shard_activation(q, "dp", None, "model", None)
    k = shard_activation(k, "dp", None, "model", None)
    self_causal = causal and kv_x is None
    mask_pos = None  # arange(S): the kernel's index mask, which skips tiles
    if self_causal and positions is not None:
        mask_pos = positions if positions.dim() == 2 else positions[0]
    # (B, S, H, hd) buffers viewed as (B, H, S, hd); the op takes strides.
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if isinstance(q, DTensor):  # a redistributed shard is laid out (B, H, S, hd)
        qt, kt, vt = (t.contiguous() for t in (qt, kt, vt))
    out = attention_op(qt, kt, vt,
                       causal=self_causal,
                       window=cfg.attn_window if self_causal else 0,
                       positions=mask_pos)
    y = _out_proj(p, cfg, out.transpose(1, 2))
    if return_kv:
        return y, (k, v)
    return y


def _decode(q, k, v, lengths, **new):
    """The decode op, or the split-KV decode over caches sharded by rows."""
    if rows_split(k):
        return split_kv_decode(q, k, v, lengths, **new)
    return decode_op(q, k, v, lengths, **new)


def decode_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     lengths: torch.Tensor, *, window: Optional[int] = None):
    """One-token decode with KV-cache append.

    ``x`` (B, 1, d_model); ``cache_k``/``cache_v`` (B, S_max, Hkv, hd),
    this layer's slice, written in place; ``lengths`` (B,) int32, the
    current context length per lane.  The new K/V goes to slot
    ``min(lengths, S_max - 1)`` (a lane at capacity keeps rewriting its
    last row), or ``lengths % S_max`` in a ring buffer (``window``, which
    must be at least ``S_max``; module docstring).  Returns ``(y,
    cache_k, cache_v)``.
    """
    b = x.shape[0]
    s_max = cache_k.shape[1]
    if window and s_max > window:
        raise ValueError(f"a ring buffer of {s_max} rows is longer than its window "
                         f"{window}: caches hold min(max_len, window) rows")
    q, k_new, v_new = _project_qkv(p, cfg, x)
    if cfg.rope != "none":
        q, k_new = _rope(cfg, q, k_new, lengths[:, None])  # true positions
    if window:
        slot = torch.remainder(lengths, s_max).long()
        att_len = torch.clamp(lengths + 1, max=s_max)
    else:
        slot = torch.clamp(lengths, max=s_max - 1).long()
        att_len = slot + 1
    out = _decode(q[:, 0], cache_k, cache_v, att_len.to(torch.int32),
                  k_new=k_new[:, 0], v_new=v_new[:, 0], slot=slot)
    y = _out_proj(p, cfg, out.reshape(b, 1, cfg.n_heads, cfg.hd))
    return y, cache_k, cache_v


def cross_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, xk: torch.Tensor,
                 xv: torch.Tensor) -> torch.Tensor:
    """Single-query cross-attention over the fixed memory KV (the
    reference's ``encdec._cross_decode``): x (B, 1, d_model), xk/xv (B,
    S_src, Hkv, hd), read only.  Every lane attends all S_src rows, so the
    op gets ``lengths = S_src``."""
    b, s_src = x.shape[0], xk.shape[1]
    q = _proj(x, p["wq"], cfg.cdtype)
    lengths = torch.full((b,), s_src, dtype=torch.int32, device=x.device)
    out = _decode(q[:, 0], xk, xv, lengths)
    return _out_proj(p, cfg, out.reshape(b, 1, cfg.n_heads, cfg.hd))


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                  n_layers=None) -> dict:
    """Stacked-over-layers KV cache (L, B, S, Hkv, hd)."""
    L = n_layers if n_layers is not None else cfg.n_layers
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}
