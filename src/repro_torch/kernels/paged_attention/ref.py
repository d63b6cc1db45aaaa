"""Plain PyTorch version of paged single-token decode attention.

Port of :func:`repro.kernels.paged_attention.ref.paged_decode_ref`: gather
each request's pages in logical order into a dense cache and defer to the
dense plain version, so paged and dense attention agree on the masked
range by construction.  Length-0 rows return zeros (see
:mod:`repro_torch.kernels.decode_attention.ref`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import decode_ref

__all__ = ["paged_decode_ref"]


def paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D); k/v_pages: (P, ps, Hkv, D); block_tables: (B, NP).

    ``lengths``: (B,) valid tokens per request (attends [0, lengths));
    table entries past ``ceil(length / ps)`` are padding and may hold any
    valid page id.  Returns (B, Hq, D) in q.dtype.
    """
    b, np_ = block_tables.shape
    ps, hkv, d = k_pages.shape[1:]
    tabs = block_tables.long()
    kd = k_pages[tabs].reshape(b, np_ * ps, hkv, d)
    vd = v_pages[tabs].reshape(b, np_ * ps, hkv, d)
    return decode_ref(q, kd, vd, lengths)
