"""Carry weights across from the reference package, through numpy.

:func:`params_from_numpy` takes the reference's params pytree with every
leaf already converted to a numpy array (the caller does the
``np.asarray``; this package never sees JAX) and returns the port's tensor
dict with the same keys and the stacked layer axis kept:
``embed.table``, ``layers.{ln1.w, attn.wq (L, d, H, hd), wk, wv,
wo (L, H, hd, d), ln2.w, mlp.w_gate/w_in/w_out}``, ``final_norm.w``,
``lm_head.w``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device="cuda") -> dict:
    """Nested dict of numpy arrays → nested dict of tensors in
    ``cfg.pdtype`` on ``device`` (keys and shapes unchanged)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        arr = np.asarray(node)
        # numpy has no bfloat16: go through float32 and cast on the device.
        if arr.dtype not in (np.float32, np.float64):
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.array(arr, copy=True)).to(dev, cfg.pdtype)

    return conv(tree)


def params_to_numpy(params: Mapping) -> dict:
    """The inverse: nested dict of tensors → nested dict of float32 numpy
    arrays (for round trips and comparisons)."""
    return {k: params_to_numpy(v) if isinstance(v, Mapping)
            else v.detach().float().cpu().numpy() for k, v in params.items()}
