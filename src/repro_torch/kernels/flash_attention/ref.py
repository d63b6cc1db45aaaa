"""Plain PyTorch version of causal GQA attention over full sequences.

Port of :func:`repro.kernels.flash_attention.ref.attention_ref`.  Takes
tensors of any strides (the model hands in (B, S, H, D) buffers viewed as
(B, H, S, D)).
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, S, D), k/v: (B, Hkv, T, D), GQA by head grouping.

    Returns (B, Hq, S, D) in q.dtype; softmax in float32.  The causal mask
    is ``qpos >= kpos`` on indices (top-left aligned), as in the reference.
    """
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, s, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(d)
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        m = qpos >= kpos
        if window > 0:
            m &= qpos - kpos < window
        scores = scores.masked_fill(~m, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)
