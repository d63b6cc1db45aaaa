"""Device selection shared by the port's entry points.

Entry points default to ``device="cuda"``; there is no silent CPU path.
A caller that wants the CPU (the tests) says ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``device`` as a :class:`torch.device`, refusing CUDA without a
    card (``RuntimeError``) instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev
