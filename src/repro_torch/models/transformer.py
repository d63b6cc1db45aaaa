"""Decoder-only LM, dense and SSM paths: parameters, embedding, forward,
prefill, head.

Port of the dense and SSM paths of :mod:`repro.models.transformer`
(``_embed``, ``_head``, ``_stack_names``, ``_layer_stacks``,
``_block_params`` ``:66``, ``_block_forward`` ``:87``, ``_block_decode``
``:138``, ``_run_stack`` ``:228``, ``forward`` ``:268``, ``prefill``
``:309``, ``decode_step`` ``:358``, ``init_cache``).  Layer parameters
keep the reference's stacked leading layer axis and keys, so a JAX params
pytree converts leaf for leaf (:mod:`repro_torch.models.convert`); the
reference's ``lax.scan`` over layers is a Python loop over that axis.  An
SSM block is ``ln1`` and the mamba2 mixer (:mod:`repro_torch.models.ssm`);
its cache is ``{"ssm", "conv"}`` per stack.  Tied embeddings use the
embedding table as the head.  With ``cfg.query_embedding`` the embedding
lookup is the ``table_gather`` query (``async_query``), which a fissioned
microbatch loop batches.  The training ``forward`` runs dense stacks only:
an SSM stack raises ``NotImplementedError`` there (``ssd_scan`` has no
gradient yet).  ``cfg.remat`` recomputes each block in the backward
through ``torch.utils.checkpoint``.  MoE and hybrid stacks and norms other
than RMSNorm belong to later slices and raise ``NotImplementedError``.

Entry points:
  init_params(cfg, seed, device)              → params dict
  forward(cfg, params, tokens, positions)     → (logits (B, S, V) f32, aux)
  prefill(cfg, params, tokens, max_len=...)   → (logits, cache)
  decode_step(cfg, params, token, cache, lengths) → (logits, cache)
  init_cache(cfg, batch, max_len, device)     → stacked KV or SSM cache

``decode_step`` writes the cache in place and returns the dict it got
(the reference returns a new pytree and relies on buffer donation).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.query import async_query, table_gather_spec
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
from repro_torch.models.ssm import (
    init_ssm_state,
    ssm_decode_step,
    ssm_forward,
    ssm_params,
)

__all__ = ["init_params", "forward", "prefill", "decode_step", "init_cache", "block_kind"]


def block_kind(cfg: ModelConfig, moe_stack: bool) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.hybrid:
        return "hybrid"
    if cfg.is_moe and moe_stack:
        return "moe"
    return "dense"


def _check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet:
    MoE and hybrid stacks, norms other than RMSNorm.  Dense and SSM stacks,
    tied embeddings and the async_query embedding pass."""
    if any(kind not in ("dense", "ssm") for _n, kind, _c in _stack_names(cfg)):
        raise NotImplementedError(
            f"{cfg.name}: only the dense and SSM families are ported so far")
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"{cfg.name}: norm {cfg.norm!r} is not ported yet")


def _norm_params(cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    return {"w": torch.ones(lead + (cfg.d_model,), dtype=cfg.pdtype, device=device)}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights drawn from ``torch.Generator(seed)`` on ``device``
    (same shapes, keys, scales and dtypes as the reference's
    ``init_params``; different numbers, since the generators differ).  An
    SSM block holds ``ln1`` and ``ssm`` only; a tied config has no
    ``lm_head``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lead = (cfg.n_layers,)
    # Draw order: embedding, layers, head.
    params = {"embed": {"table": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                            cfg.pdtype, dev)}}
    if block_kind(cfg, True) == "ssm":
        params["layers"] = {"ln1": _norm_params(cfg, dev, lead),
                            "ssm": ssm_params(gen, cfg, dev, lead)}
    else:
        params["layers"] = {
            "ln1": _norm_params(cfg, dev, lead),
            "attn": attn_params(gen, cfg, dev, lead),
            "ln2": _norm_params(cfg, dev, lead),
            "mlp": mlp_params(gen, cfg, dev, lead),
        }
    params["final_norm"] = _norm_params(cfg, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(gen, cfg.d_model, cfg.vocab_size,
                                             cfg.pdtype, dev)}
    return params


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    table = params["embed"]["table"]
    if cfg.query_embedding:
        # the paper's "query": a per-step table lookup, batchable by fission
        emb = async_query(table_gather_spec, table, tokens)
    else:
        emb = table[tokens.long()]
    return emb.to(cfg.cdtype)


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` of bf16 operands (x (M, d), w (d, V)) with float32
    accumulators and a float32 result, on the card.  ``torch.mm(...,
    out_dtype=float32)`` has no derivative, so the backward is written out:
    it computes what the transpose of the reference's ``einsum(...,
    preferred_element_type=float32)`` computes, float32 products of the
    float32 cotangent with the operands widened to float32 (exact), each
    rounded once to its operand's dtype (bf16)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = torch.mm(g, w.float().t()).to(x.dtype) if ctx.needs_input_grad[0] else None
        gw = torch.mm(x.float().t(), g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32 from float32 accumulators, as the reference's
    ``preferred_element_type=float32``: a bf16 product rounded to bf16
    would break greedy ties over the 128k vocabulary differently.  On the
    card ``torch.mm(..., out_dtype=float32)`` keeps the bf16 operands
    (:class:`_MatmulF32`, which also gives its gradient); on the CPU (where
    that overload is not registered) the operands are widened to float32
    first, which is exact.  A tied config's head is the embedding table,
    transposed (a view)."""
    cd = cfg.cdtype
    w = (params["embed"]["table"].T if cfg.tie_embeddings
         else params["lm_head"]["w"])
    xs, w = x.to(cd), w.to(cd)
    if cd == torch.float32:
        return torch.matmul(xs, w)
    if xs.is_cuda:
        out = _MatmulF32.apply(xs.reshape(-1, xs.shape[-1]), w)
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


def _block_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """One dense block over the full sequence (training): attention through
    the flash op, then the MLP, each with its residual."""
    h = apply_norm(cfg.norm, p["ln1"], x)
    x = x + attention(p["attn"], cfg, h, positions, causal=True)
    return x + mlp(p["mlp"], cfg, apply_norm(cfg.norm, p["ln2"], x))


def _run_stack(cfg: ModelConfig, stacked: dict, kind: str, n: int, x: torch.Tensor,
               positions: torch.Tensor):
    """The reference's ``_run_stack`` in ``"forward"`` mode: ``n`` blocks
    over ``x`` → ``(x, aux)``.  A dense block has no auxiliary loss."""
    if kind != "dense":
        raise NotImplementedError(
            f"training forward of {kind!r} blocks is not ported yet")
    for i in range(n):
        lp = layer_slice(stacked, i)
        if cfg.remat:
            x = checkpoint(_block_forward, lp, cfg, x, positions, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _block_forward(lp, cfg, x, positions)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None):
    """Training forward: tokens (B, S) integer → (logits (B, S, V) float32,
    aux loss).  ``positions`` defaults to ``arange(S)`` for every row."""
    _check_ported(cfg)
    x = _embed(cfg, params, tokens)
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for stacked, kind, n in _layer_stacks(cfg, params):
        x, aux = _run_stack(cfg, stacked, kind, n, x, positions)
        aux_total = aux_total + aux
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x), aux_total


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> dict:
    """Stacked decode cache for every stack, keyed by stack name: ``{"k",
    "v"}`` for a dense stack, ``{"ssm", "conv"}`` for an SSM stack (which
    does not grow with ``max_len``)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    caches = {}
    for name, kind, n in _stack_names(cfg):
        if kind == "ssm":
            caches[name] = init_ssm_state(cfg, batch, n_layers=n, device=dev)
        else:
            caches[name] = init_kv_cache(cfg, batch, max_len, dev, n_layers=n)
    return caches


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: Optional[int] = None, return_all_logits: bool = False):
    """Full-sequence prefill of ``tokens`` (B, S) → (logits, cache).

    Logits are (B, V) at the last position, or (B, S, V) with
    ``return_all_logits`` for right-padded serving batches.  The cache is
    ``{stack: {"k", "v": (L, B, S or max_len, Hkv, hd)}}`` for a dense
    stack and ``{stack: {"ssm": (L, B, H, P, N) float32, "conv": (L, B,
    K-1, Ch)}}`` for an SSM stack, nothing padded to ``max_len``.
    Right-padded prompts are safe for attention (causal masking keeps pad
    keys invisible to real queries) but not for a recurrence: an SSM
    stack's state and conv tail run over the pad positions too, as in the
    reference (``repro.models.ssm.ssm_forward``).  Runs on the device
    ``tokens`` and ``params`` live on.
    """
    _check_ported(cfg)
    x = _embed(cfg, params, tokens)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    pad = (max_len - S) if max_len is not None and max_len > S else 0
    caches = {}
    for (name, kind, n), (stacked, _k2, _n2) in zip(
            _stack_names(cfg), _layer_stacks(cfg, params)):
        if kind == "ssm":
            x, caches[name] = _prefill_ssm_stack(cfg, stacked, n, x)
            continue
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


def _prefill_ssm_stack(cfg: ModelConfig, stacked: dict, n: int, x: torch.Tensor):
    """Run ``n`` SSM blocks over x (B, S, d) → (x, {"ssm", "conv"})."""
    cache = init_ssm_state(cfg, x.shape[0], n_layers=n, device=x.device)
    for i in range(n):
        lp = layer_slice(stacked, i)
        y, state = ssm_forward(lp["ssm"], cfg, apply_norm(cfg.norm, lp["ln1"], x),
                               return_state=True)
        cache["ssm"][i] = state["ssm"]
        cache["conv"][i] = state["conv"]
        x = x + y
    return x, cache


def _block_decode(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                  cache: dict, lengths: torch.Tensor) -> torch.Tensor:
    """One block's one-token decode.  ``cache`` holds this layer's slices
    (views into the stacked cache), written in place: ``k``/``v`` (B,
    S_max, Hkv, hd) for a dense block, ``ssm`` (B, H, P, N) and ``conv``
    (B, K-1, Ch) for an SSM block."""
    h = apply_norm(cfg.norm, p["ln1"], x)
    if kind == "ssm":
        y, state, conv = ssm_decode_step(p["ssm"], cfg, h, cache["ssm"], cache["conv"])
        cache["ssm"].copy_(state)
        cache["conv"].copy_(conv)
        return x + y
    if kind != "dense":
        raise NotImplementedError(f"decode of {kind!r} blocks is not ported yet")
    window = cfg.attn_window if cfg.attn_window > 0 else None
    a, _k, _v = decode_attention(p["attn"], cfg, h, cache["k"], cache["v"], lengths,
                                 window=window)
    x = x + a
    return x + mlp(p["mlp"], cfg, apply_norm(cfg.norm, p["ln2"], x))


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, lengths: torch.Tensor):
    """Batched one-token decode over the stacked cache.

    ``token``/``lengths`` (B,) int32 on the device of ``params``;
    ``cache`` is :func:`init_cache`'s or :func:`prefill`'s layout
    (``lengths`` is read by dense stacks only).  Updates ``cache`` in place
    and returns ``(logits (B, V) float32, cache)``.
    """
    _check_ported(cfg)
    x = _embed(cfg, params, token[:, None])
    for (name, kind, n), (stacked, _k2, _n2) in zip(
            _stack_names(cfg), _layer_stacks(cfg, params)):
        stack = cache[name]
        for i in range(n):
            x = _block_decode(layer_slice(stacked, i), cfg, kind, x,
                              {k: a[i] for k, a in stack.items()}, lengths)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x)[:, 0], cache
