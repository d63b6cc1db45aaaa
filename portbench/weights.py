"""The served weights, drawn on the device from ``--seed``.

The tree has the keys, shapes, stacking and dtypes the port's decoder reads
(``params[stack][...]`` with a leading layer axis per stack), which is the
program's input format; the values are the benchmark's own: one generator
on the device, one ``normal_`` call per stacked leaf, in the dtype the
configuration serves (bf16; the MoE router in float32).  The same tensors
are handed to the program and, after the window, to the plain reference.

Matrices are N(0, 1/fan_in) (``wq`` and ``wk`` times the configuration's
``qk_scale``), the embedding N(0, 0.02^2), norm scales 1 + N(0, 0.1^2) and
QKV biases N(0, 0.5^2), so that every leaf the equations read carries
weight in the comparison.  With ``qk_scale`` 1, chatglm3-6b's attention
over its 3-7k random keys is near uniform and a greedy stream settles on
one token, which no precision changes: the check would see no fault of the
cache, so that configuration states a ``qk_scale`` of 2.  deepseek-moe-16b
keeps 1: its routed experts keep its streams apart, and a decode tick that
writes no cache row fails its cells' checks twentyfold or more.
"""
from __future__ import annotations

import math

import torch

__all__ = ["make_params", "stacks"]

BIAS_STD = 0.5
NORM_STD = 0.1


def stacks(model: dict) -> list[tuple[str, str, int]]:
    """[(stack name, block kind, layers)] in execution order: a MoE
    configuration's leading dense layers form ``dense_layers``."""
    n = model["n_layers"]
    if model.get("n_experts", 0):
        dense = model["first_dense_layers"]
        out = [("dense_layers", "dense", dense)] if dense else []
        return out + [("layers", "moe", n - dense)]
    return [("layers", "dense", n)]


def make_params(model: dict, seed: int, device, qk_scale: float = 1.0) -> dict:
    """Every leaf of ``model``'s decoder, drawn from ``seed`` on ``device``;
    ``wq`` and ``wk`` are ``qk_scale`` times wider (a configuration file's
    ``init``), so that attention logits have a standard deviation of
    ``qk_scale ** 2`` and a head attends to a few keys, as a trained one
    does, rather than averaging thousands alike."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dt = getattr(torch, model["param_dtype"])

    def normal(shape, std, dtype=dt, mean=0.0):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(mean, std, generator=gen)

    def mat(lead, i, o, shape=None):
        return normal(lead + (shape or (i, o)), 1.0 / math.sqrt(i))

    d, V = model["d_model"], model["vocab_size"]
    hq, hkv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    params = {"embed": {"table": normal((V, d), 0.02)}}
    for name, kind, n in stacks(model):
        lead = (n,)
        attn = {"wq": mat(lead, d, hq * hd, (d, hq, hd)).mul_(qk_scale),
                "wk": mat(lead, d, hkv * hd, (d, hkv, hd)).mul_(qk_scale),
                "wv": mat(lead, d, hkv * hd, (d, hkv, hd)),
                "wo": mat(lead, hq * hd, d, (hq, hd, d))}
        if model.get("qkv_bias"):
            for key, heads in (("bq", hq), ("bk", hkv), ("bv", hkv)):
                attn[key] = normal(lead + (heads, hd), BIAS_STD)
        p = {"ln1": {"w": normal(lead + (d,), NORM_STD, mean=1.0)},
             "attn": attn,
             "ln2": {"w": normal(lead + (d,), NORM_STD, mean=1.0)}}
        if kind == "moe":
            E, f = model["n_experts"], model["moe_d_ff"]

            def experts(k):
                return {"w_gate": mat(lead + (k,), d, f), "w_in": mat(lead + (k,), d, f),
                        "w_out": mat(lead + (k,), f, d)}

            p["moe"] = {"router": {"w": normal(lead + (d, E), 1.0 / math.sqrt(d),
                                               dtype=torch.float32)},
                        "experts": experts(E)}
            if model.get("n_shared_experts", 0):
                p["moe"]["shared"] = experts(model["n_shared_experts"])
        else:
            ff = model["d_ff"]
            p["mlp"] = {"w_gate": mat(lead, d, ff), "w_in": mat(lead, d, ff),
                        "w_out": mat(lead, ff, d)}
        params[name] = p
    params["final_norm"] = {"w": normal((d,), NORM_STD, mean=1.0)}
    params["lm_head"] = {"w": mat((), d, V)}
    return params
