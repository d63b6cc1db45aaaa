"""One-token decode reading KV directly from a paged physical pool.

Port of :mod:`repro.models.paged_decode` (``supports_paged_decode``,
``_paged_attention``, ``paged_decode_step``, ``sample_tokens``).  The
dense per-lane KV cache is replaced by shared physical page arrays
``(L, P, page_size, Hkv, hd)`` addressed through per-request block
tables, and attention goes through the ``paged_decode_attention`` op: the
hand-written CUDA kernel on the card, its plain version on the CPU.

Two differences from the reference, neither visible in the results:

* the page arrays are updated **in place** (``index_put_``); the
  reference returns new arrays from ``.at[].set`` and relies on buffer
  donation.  ``paged_decode_step`` returns the same cache dict it got;
* the write slot, physical page and attention length are the same for
  every layer of every stack, so they are computed once per step instead
  of per layer.

M-RoPE configs (qwen2-vl) decode text tokens: ``_rope`` broadcasts the
(B, 1) positions to three equal rows, the reference's ``:100-105``.

A MoE config runs its stacks in order (``dense_layers``, then ``layers``,
whose blocks hold ``moe``); each stack has its own page arrays, and all
share the block tables and the write slots.

Physical page ``P - 1`` is a **trash page**: inactive lanes' KV writes go
there, so a batched step never touches a page an active request owns.
Several inactive lanes scatter into it at once and ``index_put_`` picks
an arbitrary winner among duplicate indices; that is harmless only
because no block table ever points at the trash page.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ops import paged_decode_op
from repro_torch.models.attention import _out_proj, _project_qkv, _rope
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm
from repro_torch.models.transformer import (
    _embed,
    _ffn,
    _head,
    _layer_stacks,
    _stack_names,
    layer_slice,
)

__all__ = ["supports_paged_decode", "paged_decode_step", "sample_tokens"]


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, in halves of
    16 bits so that no product leaves the int64 range."""
    return ((x & 0xFFFF) * c + (((x >> 16) * (c & 0xFFFF)) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer (a bijection with full avalanche) on
    int64 tensors holding 32-bit values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _uniforms(seeds: torch.Tensor, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V) float32 uniforms in ``[0, 1)``, a counter hash of (seed,
    position, vocabulary index) alone: the hash's top 24 bits over
    ``2**24``, exact in float32."""
    key = _fmix32(_fmix32(seeds.long() & _M32) ^ (positions.long() & _M32))
    col = _fmix32(torch.arange(vocab, device=seeds.device, dtype=torch.int64)
                  * 0x9E3779B9 & _M32)
    h = _fmix32(key[:, None] ^ col[None, :])
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def sample_tokens(logits: torch.Tensor, temps, seeds, lengths) -> torch.Tensor:
    """Per-lane next-token selection for the decode megabatch, on the
    logits' device and with no host sync (a CUDA graph holds it).

    ``logits`` (B, V); ``temps``/``seeds``/``lengths`` (B,), tensors or
    arrays.  Temperature-0 lanes take ``argmax`` (first maximum on ties,
    as ``jnp.argmax``).  A positive-temperature lane draws from the
    temperature-scaled categorical by Gumbel-max: ``argmax(logits / T -
    log(-log(u)))`` with ``u`` from :func:`_uniforms`, a function of
    (seed, position, vocabulary index) alone, so the draw at a given token
    index repeats across batch compositions, lane assignments and
    spill/restore.  It keeps the reference's contract, not its bits: the
    reference draws with threefry keys.
    """
    dev = logits.device
    temps = torch.as_tensor(temps, device=dev)
    seeds = torch.as_tensor(seeds, device=dev)
    lengths = torch.as_tensor(lengths, device=dev)
    greedy = logits.argmax(dim=-1)
    u = _uniforms(seeds, lengths, logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))  # u = 0 gives -inf: never drawn
    scaled = logits.float() / temps.float().clamp_min(1e-6)[:, None]
    drawn = (scaled + gumbel).argmax(dim=-1)
    return torch.where(temps > 0, drawn, greedy).to(torch.int32)


def supports_paged_decode(cfg: ModelConfig) -> bool:
    """Whether this config's decode math can run over paged KV (the
    reference's predicate: full-context dense/MoE attention stacks)."""
    if cfg.is_encoder_decoder or cfg.attn_window > 0:
        return False
    return all(kind in ("dense", "moe") for _name, kind, _n in _stack_names(cfg))


def _write_slots(block_tables, lengths, active, n_phys: int, ps: int):
    """(physical page, in-page offset) of each lane's write this step and
    each lane's attention length.

    The write position is the dense path's ``min(length, s_max - 1)`` (a
    lane at capacity keeps rewriting its last row); inactive lanes write
    the trash page.  Lanes attend ``[0, length]`` — the token just written
    included — so the op gets ``min(length + 1, s_max)``, and inactive
    lanes attend nothing (length 0, zeros)."""
    b = lengths.shape[0]
    s_max = block_tables.shape[1] * ps
    slot = torch.clamp(lengths, max=s_max - 1).long()
    logical = slot // ps
    rows = torch.arange(b, device=lengths.device)
    phys = torch.where(active, block_tables[rows, logical].long(),
                       torch.full_like(slot, n_phys - 1))
    att_len = torch.where(active, torch.clamp(lengths + 1, max=s_max),
                          torch.zeros_like(lengths)).to(torch.int32)
    return phys, slot % ps, att_len


def _paged_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     k_pages: torch.Tensor, v_pages: torch.Tensor,
                     block_tables: torch.Tensor, lengths: torch.Tensor,
                     phys: torch.Tensor, off: torch.Tensor,
                     att_len: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention over one layer's pages (in place).

    ``x`` (B, 1, d_model); ``k_pages``/``v_pages`` (P, ps, Hkv, hd) views
    of the stacked cache; ``phys``/``off``/``att_len`` from
    :func:`_write_slots`.  Scatters the new token's K/V, then attends
    through the paged op.  Returns y (B, 1, d_model)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x)
    if cfg.rope != "none":
        q, k_new = _rope(cfg, q, k_new, lengths[:, None])  # true positions
    k_pages.index_put_((phys, off), k_new[:, 0].to(k_pages.dtype))
    v_pages.index_put_((phys, off), v_new[:, 0].to(v_pages.dtype))
    out = paged_decode_op(q[:, 0], k_pages, v_pages, block_tables, att_len)
    return _out_proj(p, cfg, out.reshape(b, 1, cfg.n_heads, cfg.hd))


def paged_decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                      cache: dict, block_tables: torch.Tensor,
                      lengths: torch.Tensor, active: torch.Tensor):
    """Batched one-token decode over paged KV.

    ``token``/``lengths`` (B,) int32, ``active`` (B,) bool; ``cache`` is
    ``{stack: {"k": (L, P, ps, Hkv, hd), "v": ...}}`` for each stack, and
    ``block_tables`` (B, max_pages) int32, shared by every layer of every
    stack.  Updates ``cache`` in place and returns ``(logits (B, V)
    float32, cache)``.
    """
    if not supports_paged_decode(cfg):
        raise NotImplementedError(f"{cfg.name}: paged decode covers full-context "
                                  "dense and MoE stacks only")
    x = _embed(cfg, params, token[:, None])
    first = cache[_stack_names(cfg)[0][0]]["k"]
    phys, off, att_len = _write_slots(block_tables, lengths, active,
                                      first.shape[1], first.shape[2])
    for (name, kind, n), (stacked, _k2, _n2) in zip(
            _stack_names(cfg), _layer_stacks(cfg, params)):
        k_all, v_all = cache[name]["k"], cache[name]["v"]
        for i in range(n):
            lp = layer_slice(stacked, i)
            h = apply_norm(cfg.norm, lp["ln1"], x)
            x = x + _paged_attention(lp["attn"], cfg, h, k_all[i], v_all[i],
                                     block_tables, lengths, phys, off, att_len)
            x = x + _ffn(lp, cfg, kind, apply_norm(cfg.norm, lp["ln2"], x))[0]
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x)[:, 0], cache
