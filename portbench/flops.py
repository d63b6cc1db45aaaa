"""Model FLOPs of useful work, from the configuration's file alone.

A served token costs two operations per weight it is multiplied by (the
attention projections, the dense or active expert FFNs, the router) and
causal attention over its own context, ``4 * layers * heads * head_dim``
per key.  The head's product counts only where a token is served: the last
prompt position of a prefill and every decode position.  The embedding
table is a lookup and counts nothing.  Padding, capacity slots that hold
no route, inactive lanes and logits no request reads are waste, not work.
"""
from __future__ import annotations

from typing import Iterable

__all__ = ["ModelFlops"]


class ModelFlops:
    """Per-token FLOP counts of one configuration file (a dict)."""

    def __init__(self, cfg: dict):
        m = cfg["model"]
        d, hq, hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
        attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
        layers = m["n_layers"]
        if m.get("n_experts", 0):
            dense = m["first_dense_layers"]
            ffn = dense * 3 * d * m["d_ff"] + (layers - dense) * (
                (m["top_k"] + m["n_shared_experts"]) * 3 * d * m["moe_d_ff"]
                + d * m["n_experts"])
        else:
            ffn = layers * 3 * d * m["d_ff"]
        self.body = 2 * (layers * attn + ffn)
        self.head = 2 * d * m["vocab_size"]
        self.per_key = 4 * layers * hq * hd

    def prefill(self, prompt_len: int) -> int:
        """One unpadded prompt: every position's body, causal attention,
        and the head at the last position."""
        n = prompt_len
        return self.body * n + self.per_key * (n * (n + 1) // 2) + self.head

    def decode(self, positions: Iterable[int]) -> int:
        """One decode tick over lanes whose new token sits at
        ``positions`` (it attends ``position + 1`` keys)."""
        pos = list(positions)
        return (self.body + self.head) * len(pos) + self.per_key * sum(p + 1 for p in pos)
