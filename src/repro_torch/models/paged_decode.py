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
  every layer, so they are computed once per step instead of per layer.

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
from repro_torch.models.mlp import mlp
from repro_torch.models.transformer import (
    _embed,
    _head,
    _layer_stacks,
    _stack_names,
    layer_slice,
)

__all__ = ["supports_paged_decode", "paged_decode_step", "sample_tokens"]


def _mix(seed: int, position: int) -> int:
    """A 64-bit seed that is a function of (seed, position) only
    (splitmix64's finalizer over the packed pair)."""
    z = ((seed & 0xFFFFFFFF) << 32 | (position & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def sample_tokens(logits: torch.Tensor, temps, seeds, lengths) -> torch.Tensor:
    """Per-lane next-token selection for the decode megabatch.

    ``logits`` (B, V); ``temps``/``seeds``/``lengths`` (B,).  Temperature-0
    lanes take ``argmax`` (first maximum on ties, as ``jnp.argmax``).  A
    positive-temperature lane draws from the temperature-scaled
    categorical with a ``torch.Generator`` seeded from (seed, position)
    alone, so the draw at a given token index repeats across batch
    compositions and lane assignments.  It keeps the reference's contract,
    not its bits: the reference draws with threefry keys.
    """
    out = logits.argmax(dim=-1).to(torch.int32)
    temps = torch.as_tensor(temps).tolist()
    hot = [i for i, t in enumerate(temps) if t > 0]
    if not hot:
        return out
    seeds = torch.as_tensor(seeds).tolist()
    lengths = torch.as_tensor(lengths).tolist()
    for i in hot:
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_mix(int(seeds[i]), int(lengths[i])))
        probs = torch.softmax(logits[i].float() / max(temps[i], 1e-6), dim=-1)
        out[i] = torch.multinomial(probs, 1, generator=gen)[0].to(torch.int32)
    return out


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
    ``{stack: {"k": (L, P, ps, Hkv, hd), "v": ...}}`` and ``block_tables``
    (B, max_pages) int32, shared by every layer.  Updates ``cache`` in
    place and returns ``(logits (B, V) float32, cache)``.
    """
    x = _embed(cfg, params, token[:, None])
    for (name, kind, n), (stacked, _k2, _n2) in zip(
            _stack_names(cfg), _layer_stacks(cfg, params)):
        if kind != "dense":
            raise NotImplementedError(f"paged decode of {kind!r} blocks is "
                                      "not ported yet")
        k_all, v_all = cache[name]["k"], cache[name]["v"]
        phys, off, att_len = _write_slots(block_tables, lengths, active,
                                          k_all.shape[1], k_all.shape[2])
        for i in range(n):
            lp = layer_slice(stacked, i)
            h = apply_norm(cfg.norm, lp["ln1"], x)
            x = x + _paged_attention(lp["attn"], cfg, h, k_all[i], v_all[i],
                                     block_tables, lengths, phys, off, att_len)
            x = x + mlp(lp["mlp"], cfg, apply_norm(cfg.norm, lp["ln2"], x))
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x)[:, 0], cache
