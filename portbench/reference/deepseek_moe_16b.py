"""deepseek-moe-16b [arXiv:2401.06066] in plain float32: 28 pre-norm blocks
of multi-head attention (16 heads of 128, full rotary, base 10000), the
first with a SwiGLU FFN of 10944, the other 27 with a DeepSeekMoE layer:
64 routed experts of 1408, the top 6 of a softmax router renormalised over
their sum, capacity-dropped within a prefill row as the configuration
states, and 2 shared experts of 1408 on every token."""
from __future__ import annotations

import torch

from portbench.reference import common
from portbench.weights import stacks

__all__ = ["logits"]


def logits(model: dict, w: common.Weights, tokens: torch.Tensor, first: int,
           group_len: int) -> torch.Tensor:
    """Logits at positions ``first ..`` of ``tokens``, whose first
    ``first + 1`` positions are the prompt, prefilled in a dispatch padded
    to ``group_len`` rows (which sets the experts' capacity)."""
    cap = common.capacity(model, group_len)
    n_prompt = first + 1
    d = model["d_model"]

    def attend(name, i, h, positions):
        return common.project_attend(model, w, name, i, h, positions, model["head_dim"])

    def ffn(name, i, h):
        if name == "dense_layers":
            return common.swiglu(h, w.mat(f"{name}.mlp.w_gate", i), w.mat(f"{name}.mlp.w_in", i),
                                 w.mat(f"{name}.mlp.w_out", i))
        m = f"{name}.moe"
        experts = tuple(w.mat(f"{m}.experts.{k}", i) for k in ("w_gate", "w_in", "w_out"))
        shared = tuple(w.mat(f"{m}.shared.{k}", i) for k in ("w_gate", "w_in", "w_out"))
        router = w.leaf(f"{m}.router.w", i).reshape(d, -1)
        return common.moe(h, router, experts, shared, model["top_k"], cap, n_prompt)

    return common.decoder_logits(model, w, tokens, first, stacks(model), attend, ffn)
