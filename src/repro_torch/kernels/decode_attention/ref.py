"""Plain PyTorch version of single-token GQA decode attention over a KV cache.

Port of :func:`repro.kernels.decode_attention.ref.decode_ref`: the plain
version of the ``decode_attention`` op (:mod:`.ops`), which the paged
plain version defers to as well.

One deliberate difference: a row with ``lengths == 0`` attends nothing and
returns zeros, as both Pallas kernels do (they finalize
``acc / max(l, 1e-30)`` with ``acc == l == 0``).  The jnp oracle returns
the mean of V there instead.  Rows with ``lengths >= 1`` are the same math.
"""
from __future__ import annotations

import math

import torch

__all__ = ["decode_ref"]


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D) one token; k/v: (B, T, Hkv, D); lengths: (B,) integer.

    Attends slots [0, lengths); returns (B, Hq, D) in q.dtype.
    """
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) / math.sqrt(d)
    valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None].long()
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float()).reshape(b, hq, d)
    out = torch.where((lengths > 0)[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)
