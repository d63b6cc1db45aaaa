"""chatglm3-6b [arXiv:2406.12793] in plain float32: 28 pre-norm blocks of
grouped-query attention (32 query heads over 2 KV heads of 128, with Q, K
and V biases, rotary over the first 64 dims of each head with a 64-dim
rotary's frequencies, base 10000) and a SwiGLU FFN of 13696."""
from __future__ import annotations

import torch

from portbench.reference import common
from portbench.weights import stacks

__all__ = ["logits"]


def logits(model: dict, w: common.Weights, tokens: torch.Tensor, first: int,
           group_len: int) -> torch.Tensor:
    """Logits at positions ``first ..`` of ``tokens`` (``group_len``, the
    prefill's padded length, changes nothing in a dense model)."""
    def attend(name, i, h, positions):
        return common.project_attend(model, w, name, i, h, positions, model["head_dim"] // 2)

    def ffn(name, i, h):
        return common.swiglu(h, w.mat(f"{name}.mlp.w_gate", i), w.mat(f"{name}.mlp.w_in", i),
                             w.mat(f"{name}.mlp.w_out", i))

    return common.decoder_logits(model, w, tokens, first, stacks(model), attend, ffn)
