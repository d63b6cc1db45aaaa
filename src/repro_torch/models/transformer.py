"""Decoder-only LM, dense, MoE, SSM, hybrid and VLM paths: parameters,
embedding, forward, prefill, head.

Port of :mod:`repro.models.transformer` (``_embed``, ``_head``,
``_stack_names``, ``_layer_stacks``, ``_block_params`` ``:66``,
``_block_forward`` ``:87``, ``_block_prefill`` ``:113``, ``_block_decode``
``:138``, ``_run_stack`` ``:228``, ``forward`` ``:268``, ``init_cache``
``:284``, ``prefill`` ``:309``, ``decode_step`` ``:358``).  Layer
parameters keep the reference's stacked leading layer axis and keys, so a
JAX params pytree converts leaf for leaf
(:mod:`repro_torch.models.convert`); the reference's ``lax.scan`` over
layers is a Python loop over that axis.  An SSM block is ``ln1`` and the
mamba2 mixer (:mod:`repro_torch.models.ssm`); its cache is ``{"ssm",
"conv"}`` per stack.  A hybrid block (hymba [arXiv:2411.13676]) runs
attention and the mixer in parallel on the same normed input, RMS-norms
each branch (``attn_branch_norm``, ``ssm_branch_norm``) and adds their
mean, ``x + 0.5 * (a + s)``, before its MLP; its cache is ``{"k", "v",
"ssm", "conv"}``.  A windowed config (``cfg.attn_window`` W) keeps a ring
buffer of ``min(max_len, W)`` rows per layer, token p at slot ``p % W``;
``prefill`` lays its KV out so (below).  A MoE config keeps its
``first_dense_layers`` dense blocks in a stack of their own,
``dense_layers``, which runs before ``layers``, whose blocks hold ``moe``
(:mod:`repro_torch.models.moe`) in place of ``mlp``; each stack has its
own KV cache.  Norms follow ``cfg.norm`` (RMSNorm, LayerNorm or OLMo's
non-parametric LayerNorm, which holds no leaves).  Tied embeddings use the
embedding table as the head.  With ``cfg.query_embedding`` the embedding
lookup is the ``table_gather`` query (``async_query``), which a fissioned
microbatch loop batches.  A frontend config (qwen2-vl's patch stub) feeds
precomputed ``embeds`` instead of tokens, with (3, B, S) M-RoPE
``positions``.  The training ``forward`` runs every block kind and sums
the MoE blocks' auxiliary losses; an SSM or hybrid block's gradient goes
through the ``ssd_scan`` op's adjoint (``ssd_scan_bwd``).  ``cfg.remat``
recomputes each block in the backward through ``torch.utils.checkpoint``.

Entry points:
  init_params(cfg, seed, device)              → params dict
  forward(cfg, params, tokens, positions, embeds=) → (logits (B, S, V) f32, aux)
  prefill(cfg, params, tokens, max_len=..., positions=, embeds=) → (logits, cache)
  decode_step(cfg, params, token, cache, lengths) → (logits, cache)
  init_cache(cfg, batch, max_len, device)     → stacked KV and/or SSM cache

``decode_step`` writes the cache in place and returns the dict it got
(the reference returns a new pytree and relies on buffer donation).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.core.query import async_query, table_gather_spec
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import gather_dp, shard_activation
from repro_torch.models.attention import (
    attention,
    attn_params,
    decode_attention,
    init_kv_cache,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm, dense_init, embed_init, norm_params, rmsnorm
from repro_torch.models.mlp import mlp, mlp_params
from repro_torch.models.moe import moe, moe_params
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


def _norm_params(cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    return norm_params(cfg.norm, cfg.d_model, cfg.pdtype, device, lead)


def _block_params(gen: torch.Generator, cfg: ModelConfig, kind: str, device,
                  n: int) -> dict:
    """``n`` stacked blocks of ``kind``: an SSM block holds ``ln1`` and
    ``ssm``; a dense or MoE block ``ln1``, ``attn``, ``ln2`` and ``mlp`` or
    ``moe``; a hybrid block a dense block's leaves, ``ssm`` and the two
    branch norms (RMSNorm whatever ``cfg.norm`` is)."""
    lead = (n,)
    if kind == "ssm":
        return {"ln1": _norm_params(cfg, device, lead),
                "ssm": ssm_params(gen, cfg, device, lead)}
    p = {"ln1": _norm_params(cfg, device, lead),
         "attn": attn_params(gen, cfg, device, lead),
         "ln2": _norm_params(cfg, device, lead)}
    if kind == "moe":
        p["moe"] = moe_params(gen, cfg, device, lead)
    else:
        p["mlp"] = mlp_params(gen, cfg, device, lead)
    if kind == "hybrid":
        p["ssm"] = ssm_params(gen, cfg, device, lead)
        for name in ("ssm_branch_norm", "attn_branch_norm"):
            p[name] = norm_params("rmsnorm", cfg.d_model, cfg.pdtype, device, lead)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights drawn from ``torch.Generator(seed)`` on ``device``
    (same shapes, keys, scales and dtypes as the reference's
    ``init_params``; different numbers, since the generators differ), one
    entry per stack of :func:`_stack_names`; a tied config has no
    ``lm_head``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    # Draw order: embedding, the stacks in execution order, head.
    params = {"embed": {"table": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                            cfg.pdtype, dev)}}
    for name, kind, n in _stack_names(cfg):
        params[name] = _block_params(gen, cfg, kind, dev, n)
    params["final_norm"] = _norm_params(cfg, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(gen, cfg.d_model, cfg.vocab_size,
                                             cfg.pdtype, dev)}
    return params


def _lookup(cfg: ModelConfig, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if cfg.query_embedding:
        # the paper's "query": a per-step table lookup, batchable by fission
        return async_query(table_gather_spec, table, ids)
    return table[ids.long()]


def embed_lookup(cfg: ModelConfig, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` for ``tokens`` in the compute dtype.  A DTensor
    table, vocabulary-sharded over ``model``, is read by a masked local
    gather: each rank looks up the ids in its own row range (the others
    read row 0 and are zeroed), so the rows are a partial sum over
    ``model`` that the first activation constraint all-reduces; the
    table's data-parallel shards are gathered first (FSDP).  The lookup on
    each rank is the same ``batched_gather`` launch as on one card."""
    if not isinstance(table, DTensor):
        return _lookup(cfg, table, tokens).to(cfg.cdtype)
    mesh = table.device_mesh
    table = gather_dp(table)
    names = mesh.mesh_dim_names
    m = names.index("model") if "model" in names else None
    split = m is not None and table.placements[m] == Shard(0)
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    out_pl = [Partial() if (split and i == m) else p for i, p in enumerate(tokens.placements)]

    def local(tab, ids):
        if not split:
            return _lookup(cfg, tab, ids)
        v_loc = tab.shape[0]
        rel = ids.long() - mesh.get_local_rank("model") * v_loc
        inside = (rel >= 0) & (rel < v_loc)
        rows = _lookup(cfg, tab, torch.where(inside, rel, torch.zeros_like(rel)))
        return rows * inside[..., None].to(rows.dtype)

    # The table's gradient: each data-parallel rank's share of it (Partial).
    grad_pl = tuple(Partial() if isinstance(p, Replicate) and i != m else p
                    for i, p in enumerate(table.placements))
    emb = local_map(local, out_placements=out_pl,
                    in_placements=(table.placements, tokens.placements),
                    in_grad_placements=(grad_pl, tokens.placements),
                    device_mesh=mesh)(table, tokens)
    return emb.to(cfg.cdtype)


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return embed_lookup(cfg, params["embed"]["table"], tokens)


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
    w = (gather_dp(params["embed"]["table"]).T if cfg.tie_embeddings
         else gather_dp(params["lm_head"]["w"]))
    xs, w = x.to(cd), w.to(cd)
    if cd == torch.float32:
        logits = torch.matmul(xs, w)
    elif xs.is_cuda:
        x2 = xs.reshape(-1, xs.shape[-1])
        mm = _MatmulF32.apply
        if isinstance(w, DTensor):  # local products: rows over dp, vocab over model
            x2 = shard_activation(x2, "dp", None)
            out_pl = list(Shard(1) if isinstance(p, Shard) else q
                           for p, q in zip(w.placements, x2.placements))
            # gradients: x's a partial sum over the vocabulary's shards,
            # w's over the batch's
            gx = tuple(Partial() if isinstance(p, Shard) else q
                       for p, q in zip(w.placements, x2.placements))
            gw = tuple(Partial() if isinstance(q, Shard) else p
                       for p, q in zip(w.placements, x2.placements))
            mm = local_map(mm, out_placements=out_pl,
                           in_placements=(x2.placements, w.placements),
                           in_grad_placements=(gx, gw), device_mesh=w.device_mesh)
        logits = mm(x2, w).reshape(*xs.shape[:-1], w.shape[-1])
    else:
        logits = torch.matmul(xs.float(), w.float())
    return shard_activation(logits, "dp", None, "model")


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


def _ffn(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor):
    """The block's second half on the normed residual ``x``: the MLP, or
    the MoE layer → ``(y, aux)`` (aux is ``None`` for a dense block)."""
    if kind == "moe":
        return moe(p["moe"], cfg, x)
    return mlp(p["mlp"], cfg, x), None


def _block_forward(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                   positions: Optional[torch.Tensor]):
    """One block over the full sequence (training), the reference's
    ``_block_forward`` → ``(x, aux)``: an SSM block is the mixer on the
    normed input with its residual; the others run attention through the
    flash op (banded with a window), a hybrid block the mixer beside it on
    the same normed input (``_branch_mean``), then the MLP or MoE, each
    with its residual.  Only a MoE block's aux is nonzero."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(cfg.norm, p["ln1"], x)
    if kind == "ssm":
        return x + ssm_forward(p["ssm"], cfg, h), zero
    a = attention(p["attn"], cfg, h, positions, causal=True)
    x = x + (_branch_mean(p, a, ssm_forward(p["ssm"], cfg, h)) if kind == "hybrid" else a)
    y, aux = _ffn(p, cfg, kind, apply_norm(cfg.norm, p["ln2"], x))
    return x + y, (aux if aux is not None else zero)


def _run_stack(cfg: ModelConfig, stacked: dict, kind: str, n: int, x: torch.Tensor,
               positions: Optional[torch.Tensor]):
    """The reference's ``_run_stack`` in ``"forward"`` mode: ``n`` blocks
    over ``x`` → ``(x, summed aux)``."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        lp = layer_slice(stacked, i)
        if cfg.remat:
            x, aux = checkpoint(_block_forward, lp, cfg, kind, x, positions,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _block_forward(lp, cfg, kind, x, positions)
        aux_total = aux_total + aux
    return x, aux_total


def _inputs(cfg: ModelConfig, params: dict, tokens, embeds) -> torch.Tensor:
    """The first hidden state: the embedded ``tokens``, or a frontend's
    precomputed ``embeds`` (B, S, d) in the compute dtype."""
    if embeds is not None:
        return embeds.to(cfg.cdtype)
    return _embed(cfg, params, tokens)


def forward(cfg: ModelConfig, params: dict, tokens: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None):
    """Training forward: tokens (B, S) integer, or ``embeds`` (B, S, d) →
    (logits (B, S, V) float32, aux loss).  ``positions`` (B, S), or (3, B,
    S) for M-RoPE, default to ``arange(S)`` for every row."""
    x = shard_activation(_inputs(cfg, params, tokens, embeds), "dp", None, None)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for stacked, kind, n in _layer_stacks(cfg, params):
        x, aux = _run_stack(cfg, stacked, kind, n, x, positions)
        aux_total = aux_total + aux
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x), aux_total


def _kv_len(cfg: ModelConfig, max_len: int) -> int:
    """Rows of a layer's KV cache: a windowed config's ring holds
    ``min(max_len, W)``."""
    return min(max_len, cfg.attn_window) if cfg.attn_window > 0 else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> dict:
    """Stacked decode cache for every stack, keyed by stack name: ``{"k",
    "v"}`` for a dense or MoE stack, ``{"ssm", "conv"}`` for an SSM stack
    (which does not grow with ``max_len``), both for a hybrid stack."""
    dev = resolve_device(device)
    caches = {}
    for name, kind, n in _stack_names(cfg):
        c = {}
        if kind != "ssm":
            c.update(init_kv_cache(cfg, batch, _kv_len(cfg, max_len), dev, n_layers=n))
        if kind in ("ssm", "hybrid"):
            c.update(init_ssm_state(cfg, batch, n_layers=n, device=dev))
        caches[name] = c
    return caches


def prefill(cfg: ModelConfig, params: dict, tokens: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None, return_all_logits: bool = False, *,
            positions: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None, out: Optional[dict] = None):
    """Full-sequence prefill of ``tokens`` (B, S), or of a frontend's
    ``embeds`` (B, S, d) at ``positions`` ((3, B, S) for M-RoPE; default
    ``arange(S)``) → (logits, cache).

    Logits are (B, V) at the last position, or (B, S, V) with
    ``return_all_logits`` for right-padded serving batches.  The cache is
    ``{stack: {"k", "v": (L, B, S_kv, Hkv, hd)}}`` for a dense or MoE
    stack, with ``S_kv`` = ``max(S, max_len)``, and ``{stack: {"ssm": (L,
    B, H, P, N) float32, "conv": (L, B, K-1, Ch)}}`` for an SSM stack; a
    hybrid stack holds all four.  A windowed config's KV is re-laid out
    as the reference's ring buffer of W rows: the last W tokens, token p
    at slot ``p % W`` (``torch.roll`` of the last W rows by ``S % W``),
    or the S rows and zeros after them when S < W.  The ring keeps the
    last W rows of the *padded* length S, as the reference's does, so a
    right-padded prompt shorter than S loses real rows to pad rows once
    S reaches W.  Right-padded prompts are safe for full-context
    attention (causal masking keeps pad keys invisible to real queries)
    but not for a recurrence: an SSM stack's state and conv tail run over
    the pad positions too, as in the reference
    (``repro.models.ssm.ssm_forward``).  Runs on the device ``tokens`` or
    ``embeds`` and ``params`` live on.

    ``out`` (not on a mesh): a cache of exactly the shapes this prefill
    returns, zeroed and written in place and returned instead of a new one
    (the engines' compiled prefill writes into a staging cache whose
    address is fixed).
    """
    x = shard_activation(_inputs(cfg, params, tokens, embeds), "dp", None, None)
    B, S = x.shape[:2]
    W = cfg.attn_window
    rows = W if W > 0 else max(S, max_len or 0)
    caches = {}
    sharded = isinstance(x, DTensor)
    if out is not None:
        if sharded:
            raise ValueError("prefill writes no out= cache on a mesh")
        for stack in out.values():
            for a in stack.values():
                a.zero_()
    for (name, kind, n), (stacked, _k2, _n2) in zip(
            _stack_names(cfg), _layer_stacks(cfg, params)):
        if kind == "ssm":
            x, caches[name] = _prefill_ssm_stack(cfg, stacked, n, x,
                                                 None if out is None else out[name])
            continue
        shape = (n, B, rows, cfg.n_kv_heads, cfg.hd)
        # On a mesh each layer's rows are kept and stacked after the loop
        # (DTensor writes no slice of a sharded buffer in place).
        if sharded:
            c = {"k": [], "v": []}
        elif out is not None:
            c = out[name]
            if tuple(c["k"].shape) != shape:
                raise ValueError(f"prefill out= cache {name}: {tuple(c['k'].shape)}, "
                                 f"not {shape}")
        else:
            c = {"k": torch.zeros(shape, dtype=cfg.cdtype, device=x.device),
                 "v": torch.zeros(shape, dtype=cfg.cdtype, device=x.device)}
        if kind == "hybrid" and out is None:
            c.update({"ssm": [], "conv": []} if sharded else
                     init_ssm_state(cfg, B, n_layers=n, device=x.device))
        for i in range(n):
            lp = layer_slice(stacked, i)
            h = apply_norm(cfg.norm, lp["ln1"], x)
            a, (k, v) = attention(lp["attn"], cfg, h, positions, causal=True,
                                  return_kv=True)
            for key, t in (("k", k), ("v", v)):
                t = t.to(cfg.cdtype)
                if W > 0 and S >= W:  # token p at slot p % W
                    t = torch.roll(t[:, S - W:], S % W, dims=1)
                if sharded:
                    if rows > t.shape[1]:
                        t = F.pad(t, (0, 0, 0, 0, 0, rows - t.shape[1]))
                    c[key].append(t)
                elif W > 0 and S >= W:
                    c[key][i] = t
                else:
                    c[key][i, :, :S] = t
            if kind == "hybrid":
                s_out, state = ssm_forward(lp["ssm"], cfg, h, return_state=True)
                for key in ("ssm", "conv"):
                    if sharded:
                        c[key].append(state[key])
                    else:
                        c[key][i] = state[key]
                x = x + _branch_mean(lp, a, s_out)
            else:
                x = x + a
            x = x + _ffn(lp, cfg, kind, apply_norm(cfg.norm, lp["ln2"], x))[0]
        caches[name] = {k: torch.stack(v) for k, v in c.items()} if sharded else c
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if return_all_logits:
        return _head(cfg, params, x), caches
    return _head(cfg, params, x[:, -1:])[:, 0], caches


def _branch_mean(p: dict, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """A hybrid block's two branches, each RMS-normed, then their mean."""
    a = rmsnorm(a, p["attn_branch_norm"]["w"])
    s = rmsnorm(s, p["ssm_branch_norm"]["w"])
    return 0.5 * (a + s)


def _prefill_ssm_stack(cfg: ModelConfig, stacked: dict, n: int, x: torch.Tensor,
                       out: Optional[dict] = None):
    """Run ``n`` SSM blocks over x (B, S, d) → (x, {"ssm", "conv"}), the
    states written into ``out`` when given."""
    sharded = isinstance(x, DTensor)  # stacked after the loop, as in prefill
    if sharded:
        cache = {"ssm": [], "conv": []}
    else:
        cache = out if out is not None else init_ssm_state(cfg, x.shape[0], n_layers=n,
                                                           device=x.device)
    for i in range(n):
        lp = layer_slice(stacked, i)
        y, state = ssm_forward(lp["ssm"], cfg, apply_norm(cfg.norm, lp["ln1"], x),
                               return_state=True)
        for key in ("ssm", "conv"):
            if sharded:
                cache[key].append(state[key])
            else:
                cache[key][i] = state[key]
        x = x + y
    if sharded:
        cache = {k: torch.stack(v) for k, v in cache.items()}
    return x, cache


def _block_decode(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                  cache: dict, lengths: torch.Tensor) -> torch.Tensor:
    """One block's one-token decode.  ``cache`` holds this layer's slices
    (views into the stacked cache), written in place: ``k``/``v`` (B,
    S_max, Hkv, hd) for a dense block (a ring buffer with a window),
    ``ssm`` (B, H, P, N) and ``conv`` (B, K-1, Ch) for an SSM block, all
    four for a hybrid block; a MoE block routes its one token per lane
    (capacity 4 per expert, so nothing is dropped)."""
    h = apply_norm(cfg.norm, p["ln1"], x)
    if kind in ("ssm", "hybrid"):
        s, state, conv = ssm_decode_step(p["ssm"], cfg, h, cache["ssm"], cache["conv"])
        cache["ssm"].copy_(state)
        cache["conv"].copy_(conv)
        if kind == "ssm":
            return x + s
    window = cfg.attn_window if cfg.attn_window > 0 else None
    a, _k, _v = decode_attention(p["attn"], cfg, h, cache["k"], cache["v"], lengths,
                                 window=window)
    x = x + (_branch_mean(p, a, s) if kind == "hybrid" else a)
    return x + _ffn(p, cfg, kind, apply_norm(cfg.norm, p["ln2"], x))[0]


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, lengths: torch.Tensor):
    """Batched one-token decode over the stacked cache.

    ``token``/``lengths`` (B,) int32 on the device of ``params``;
    ``cache`` is :func:`init_cache`'s or :func:`prefill`'s layout
    (``lengths`` is read by dense stacks only).  Updates ``cache`` in place
    and returns ``(logits (B, V) float32, cache)``.
    """
    x = _embed(cfg, params, token[:, None])
    for (name, kind, n), (stacked, _k2, _n2) in zip(
            _stack_names(cfg), _layer_stacks(cfg, params)):
        stack = cache[name]
        for i in range(n):
            x = _block_decode(layer_slice(stacked, i), cfg, kind, x,
                              {k: a[i] for k, a in stack.items()}, lengths)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x)[:, 0], cache
