"""Carry weights across from the reference package, through numpy.

:func:`params_from_numpy` takes the reference's params pytree with every
leaf already converted to a numpy array (the caller does the
``np.asarray``; this package never sees JAX) and returns the port's tensor
dict with the same keys and the stacked layer axis kept:
``embed.table``, ``layers.{ln1.w, attn.wq (L, d, H, hd), wk, wv,
wo (L, H, hd, d), ln2.w, mlp.w_gate/w_in/w_out}``, ``final_norm.w``,
``lm_head.w`` for the dense family, with ``attn.bq/bk/bv`` for QKV-bias
configs, ``ln*.b`` for LayerNorm, empty norm dicts for OLMo's
non-parametric norm and no ``mlp.w_gate`` for the GELU MLP; ``dense_layers``
beside ``layers`` for the MoE family, whose blocks hold ``moe.{router.w,
experts.w_gate/w_in/w_out, shared.w_gate/w_in/w_out}`` in place of
``mlp``; ``layers.{ln1.w, ssm.in_proj, conv_w, conv_b, A_log, D, dt_bias,
norm_w, out_proj}`` and no ``lm_head`` (tied) for mamba2; a hybrid block
(hymba) holds a dense block's leaves, ``ssm`` and
``attn_branch_norm.w``/``ssm_branch_norm.w``; the encoder-decoder
(seamless-m4t) adds ``enc_layers.{ln1, attn, ln2, mlp}`` and ``enc_norm``
and gives each decoder block ``ln_cross`` and ``cross_attn``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["params_from_numpy", "params_to_numpy"]

# (parent key, key) of the leaves the reference keeps in float32 whatever
# ``param_dtype`` is: an ``ssm`` mixer's decay rate ``A = -exp(A_log)``,
# skip ``D`` and ``dt`` bias (``repro.models.ssm.ssm_params``), and the
# MoE router's weight (``repro.models.moe.moe_params``).
_FLOAT32_LEAVES = frozenset({("ssm", "A_log"), ("ssm", "D"), ("ssm", "dt_bias"),
                             ("router", "w")})


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device="cuda") -> dict:
    """Nested dict of numpy arrays → nested dict of tensors on ``device``
    (keys and shapes unchanged), each in the reference's dtype for that
    leaf: ``A_log``, ``D`` and ``dt_bias`` under an ``ssm`` dict and ``w``
    under a ``router`` dict stay float32, every other leaf becomes
    ``cfg.pdtype``.  The rule is by key,
    not by the source array's dtype, so a tree that went through float32
    (``params_to_numpy``) comes back in the same dtypes."""
    dev = resolve_device(device)

    def conv(node, key=None, parent=None):
        if isinstance(node, Mapping):
            return {k: conv(v, k, key) for k, v in node.items()}
        arr = np.asarray(node)
        # numpy has no bfloat16: go through float32 and cast on the device.
        if arr.dtype not in (np.float32, np.float64):
            arr = arr.astype(np.float32)
        dtype = torch.float32 if (parent, key) in _FLOAT32_LEAVES else cfg.pdtype
        return torch.from_numpy(np.array(arr, copy=True)).to(dev, dtype)

    return conv(tree)


def params_to_numpy(params: Mapping) -> dict:
    """The inverse: nested dict of tensors → nested dict of float32 numpy
    arrays (for round trips and comparisons)."""
    return {k: params_to_numpy(v) if isinstance(v, Mapping)
            else v.detach().float().cpu().numpy() for k, v in params.items()}
