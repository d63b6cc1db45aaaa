"""Plain float32 decoder equations that the configurations' references share.

Frozen, written from the published descriptions and the configuration
files; nothing here imports the program or reads what it made.  One
request at a time, one layer at a time: each layer's weights are widened
to float32 when it runs, so the reference fits beside the served bf16
weights.  TF32 is off (:func:`highest_precision`).

``Weights.cast`` is the identity for the reference.  The control computes
the same equations with every bf16 matrix rounded to float8 e4m3 with one
scale per output channel (:func:`fp8_round`).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

__all__ = ["Weights", "highest_precision", "fp8_round", "rmsnorm", "rope", "attention",
           "swiglu", "moe", "capacity", "decoder_logits"]


def highest_precision() -> None:
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(w: torch.Tensor, in_dim: int) -> torch.Tensor:
    """``w`` (float32) rounded to float8 e4m3 with one scale per output
    channel (the amax over ``in_dim`` maps to 448), back in float32."""
    scale = w.abs().amax(dim=in_dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


class Weights:
    """Float32 views of the served tree, one layer at a time.  ``cast(w,
    in_dim)`` is applied to every matrix (not to norms, biases or the
    float32 router)."""

    def __init__(self, params: dict, cast: Optional[Callable] = None):
        self.params = params
        self.cast = cast or (lambda w, in_dim: w)

    def leaf(self, path: str, i: Optional[int] = None) -> torch.Tensor:
        t = self.params
        for key in path.split("."):
            t = t[key]
        return (t if i is None else t[i]).float()

    def mat(self, path: str, i: Optional[int] = None, in_features: Optional[int] = None):
        """A (in, out) matrix; a stacked (E, in, out) one keeps its E."""
        w = self.leaf(path, i)
        if in_features is not None:
            w = w.reshape(in_features, -1)
        return self.cast(w, w.dim() - 2)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        rows = self.params["embed"]["table"][tokens.long()].float()
        return self.cast(rows, 1)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, rot: int) -> torch.Tensor:
    """Rotary embedding of the first ``rot`` dims of each head of ``x``
    (T, H, D), frequencies ``theta ** (-2j / rot)``, pairs (j, j + rot/2);
    the other ``D - rot`` dims pass through."""
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot))
    ang = positions.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2, rest = x[..., : rot // 2], x[..., rot // 2: rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block: int = 512):
    """Causal attention of one sequence: q (T, Hq, D), k and v (T, Hkv, D),
    query head h reading KV head ``h // (Hq / Hkv)``; softmax of q.k /
    sqrt(D).  Query blocks of ``block`` rows bound the score memory."""
    T, hq, d = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)          # (Hq, T, D)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for s in range(0, T, block):
        e = min(T, s + block)
        qs = q[s:e].transpose(0, 1)                            # (Hq, b, D)
        scores = qs @ k[:, :e].transpose(1, 2) / math.sqrt(d)  # (Hq, b, e)
        keys = torch.arange(e, device=q.device)
        mask = keys[None, :] > torch.arange(s, e, device=q.device)[:, None]
        scores = scores.masked_fill(mask, float("-inf"))
        out[s:e] = (torch.softmax(scores, dim=-1) @ v[:, :e]).transpose(0, 1)
    return out


def swiglu(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor):
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def capacity(model: dict, group_len: int) -> int:
    """Slots per routed expert per batch row of a dispatch whose padded
    length is ``group_len``: ``ceil(S * top_k / E * capacity_factor)``
    rounded up to a multiple of 4, at least 4."""
    c = math.ceil(group_len * model["top_k"] / model["n_experts"] * model["capacity_factor"])
    return max(4, -(-c // 4) * 4)


def moe(x: torch.Tensor, router: torch.Tensor, experts: tuple, shared: Optional[tuple],
        top_k: int, cap: int, n_capped: int) -> torch.Tensor:
    """Routed and shared experts over x (T, d).  Softmax over the experts,
    the top ``top_k`` renormalised over their sum; among the first
    ``n_capped`` tokens (one prefill row), a route whose expert already
    holds ``cap`` earlier tokens of that row is dropped (its gate is
    zero, the rest are not renormalised); later tokens (decode, one per
    row) are never dropped.  The shared experts see every token."""
    probs = torch.softmax(x @ router, dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    n_exp = router.shape[1]
    if n_capped:
        head = idx[:n_capped].reshape(-1)
        onehot = F.one_hot(head, n_exp)
        pos = (torch.cumsum(onehot, 0) - onehot).gather(1, head[:, None])[:, 0]
        keep = torch.ones_like(gate, dtype=torch.bool)
        keep[:n_capped] = (pos < cap).reshape(n_capped, top_k)
        gate = gate * keep
    wg, wi, wo = experts
    y = torch.zeros_like(x)
    for e in range(n_exp):
        rows, ks = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        ye = swiglu(x[rows], wg[e], wi[e], wo[e])
        y.index_add_(0, rows, ye * gate[rows, ks][:, None])
    if shared is not None:
        sg, si, so = shared
        for s in range(sg.shape[0]):
            y = y + swiglu(x, sg[s], si[s], so[s])
    return y


def decoder_logits(model: dict, w: Weights, tokens: torch.Tensor, first: int,
                   stacks: list, attend: Callable, ffn: Callable) -> torch.Tensor:
    """Float32 logits (T - first, V) at positions ``first .. T-1`` of one
    sequence ``tokens`` (T,).  Each block: RMSNorm, ``attend(stack, i, h,
    positions)``, residual, RMSNorm, ``ffn(stack, i, h)``, residual; then
    the final RMSNorm and the head."""
    eps = model["norm_eps"]
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    x = w.embed(tokens)
    for name, _kind, n in stacks:
        for i in range(n):
            h = rmsnorm(x, w.leaf(f"{name}.ln1.w", i), eps)
            x = x + attend(name, i, h, positions)
            h = rmsnorm(x, w.leaf(f"{name}.ln2.w", i), eps)
            x = x + ffn(name, i, h)
    x = rmsnorm(x[first:], w.leaf("final_norm.w"), eps)
    return x @ w.mat("lm_head.w")


def project_attend(model: dict, w: Weights, name: str, i: int, h: torch.Tensor,
                   positions: torch.Tensor, rot: int) -> torch.Tensor:
    """Q, K, V projections (with biases where the tree has them), rotary
    over ``rot`` dims of each head, causal GQA attention, output
    projection."""
    d, hq, hkv, hd = model["d_model"], model["n_heads"], model["n_kv_heads"], model["head_dim"]
    T = h.shape[0]
    a = f"{name}.attn"
    q = (h @ w.mat(f"{a}.wq", i, d)).reshape(T, hq, hd)
    k = (h @ w.mat(f"{a}.wk", i, d)).reshape(T, hkv, hd)
    v = (h @ w.mat(f"{a}.wv", i, d)).reshape(T, hkv, hd)
    if model.get("qkv_bias"):
        q = q + w.leaf(f"{a}.bq", i)
        k = k + w.leaf(f"{a}.bk", i)
        v = v + w.leaf(f"{a}.bv", i)
    q = rope(q, positions, model["rope_theta"], rot)
    k = rope(k, positions, model["rope_theta"], rot)
    out = attention(q, k, v).reshape(T, hq * hd)
    return out @ w.mat(f"{a}.wo", i, hq * hd)
