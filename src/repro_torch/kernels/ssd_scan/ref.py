"""Plain PyTorch versions of the SSD inter-chunk state recurrence and its
gradient.

Port of :func:`repro.kernels.ssd_scan.ref.ssd_scan_ref`: the plain version
of the ``ssd_scan`` op (:mod:`.ops`).  The reference's ``lax.scan`` over
chunks is a Python loop over C, carried in float32.
:func:`ssd_scan_bwd_ref` is the plain version of the ``ssd_scan_bwd`` op,
the recurrence's adjoint, which the JAX package gets from XLA's autodiff of
its ``lax.scan`` (``repro.models.ssm.ssd_chunked``).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ssd_scan_ref", "ssd_scan_bwd_ref"]


def ssd_scan_ref(states: torch.Tensor, decay: torch.Tensor,
                 initial_state: Optional[torch.Tensor] = None):
    """states: (B, C, H, P, N) per-chunk contributions; decay: (B, C, H).

    Returns (prev (B, C, H, P, N) float32 — the state ENTERING each chunk —
    and final (B, H, P, N) float32)::

        s_0 = initial_state (zeros if None);  s_{c+1} = s_c * decay_c + states_c
    """
    b, c, h, p, n = states.shape
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=states.device)
             if initial_state is None else initial_state.float())
    st = states.float()
    dec = decay.float()
    prev = torch.empty((b, c, h, p, n), dtype=torch.float32, device=states.device)
    for ci in range(c):
        prev[:, ci] = carry
        carry = carry * dec[:, ci, :, None, None] + st[:, ci]
    return prev, carry


def ssd_scan_bwd_ref(g_prev: torch.Tensor, g_final: Optional[torch.Tensor],
                     prev: torch.Tensor, decay: torch.Tensor):
    """The adjoint of :func:`ssd_scan_ref`: the cotangents ``g_prev`` (B, C,
    H, P, N) of ``prev`` and ``g_final`` (B, H, P, N) of ``final`` (None:
    zeros), with the forward's ``prev`` and ``decay`` (B, C, H) → (d_states
    (B, C, H, P, N) in ``prev``'s dtype, d_decay (B, C, H) float32,
    d_initial (B, H, P, N) float32)::

        G_C = g_final;  d_states_c = G_{c+1};
        d_decay_c = sum_{p,n} G_{c+1} * prev_c;  G_c = g_prev_c + G_{c+1} * decay_c;
        d_initial = G_0

    The carry G is float32, each multiply and add rounded on its own."""
    b, c, h, p, n = prev.shape
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=prev.device)
             if g_final is None else g_final.float())
    dec = decay.float()
    d_states = torch.empty_like(prev)
    d_decay = torch.empty((b, c, h), dtype=torch.float32, device=prev.device)
    for ci in reversed(range(c)):
        d_states[:, ci] = carry
        d_decay[:, ci] = (carry * prev[:, ci].float()).sum((-2, -1))
        carry = carry * dec[:, ci, :, None, None] + g_prev[:, ci].float()
    return d_states, d_decay, carry
