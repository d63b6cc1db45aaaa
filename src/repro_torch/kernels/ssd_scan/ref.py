"""Plain PyTorch version of the SSD inter-chunk state recurrence.

Port of :func:`repro.kernels.ssd_scan.ref.ssd_scan_ref`: the plain version
of the ``ssd_scan`` op (:mod:`.ops`).  The reference's ``lax.scan`` over
chunks is a Python loop over C, carried in float32.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ssd_scan_ref"]


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
