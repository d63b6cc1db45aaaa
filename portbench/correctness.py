"""Whether what the timed path served is right: the logit gap of each
served token.

Once the window has closed and the program's state is freed, a sample of
the requests that finished in the window, drawn from the seed and holding
the one with the most served tokens, is run through the configuration's
plain float32 reference: each prompt with its served tokens, teacher-forced.
At every served position the gap is the reference's best logit minus the
reference's logit of the token the program served (0 where they agree).
The mean gap over the sample's positions is held to the cell's limit; the
widest gap and the share of positions off the reference's first token are
reported beside it.  (The widest gap is not held to a limit: sound bf16
runs of the MoE model read as wide as the control on some seeds, where one
near-tie among the routed experts goes the other way, PERF.md §6.)

The control (``cast=common.fp8_round``) computes the same logits with every
bf16 matrix rounded to float8 e4m3, the precision below the configuration's,
and its gap is read for the token the control puts first.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["sample", "gaps", "check"]


def sample(served: list, seed: int, k: int) -> list:
    """``k`` of ``served`` (prompt, tokens, group) drawn from ``seed``,
    always holding the one with the most served tokens."""
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: (len(served[i][1]), -i))
    rest = [i for i in range(len(served)) if i != longest]
    rng = np.random.default_rng([int(seed), 0x5EED])
    picked = [longest] + [int(i) for i in rng.permutation(rest)[: max(0, k - 1)]]
    return [served[i] for i in picked]


def gaps(model: dict, ref, weights, items: list, device,
         control: Optional[object] = None) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Per served position of ``items``: the gap of the served token and,
    with ``control``, the gap of the token the control puts first."""
    import torch
    served_gaps, control_gaps = [], []
    with torch.no_grad():
        for prompt, toks, group in items:
            seq = np.concatenate([np.asarray(prompt, np.int64), np.asarray(toks[:-1], np.int64)])
            tokens = torch.as_tensor(seq, device=device)
            first = len(prompt) - 1
            logits = ref.logits(model, weights, tokens, first, group)
            served = torch.as_tensor(np.asarray(toks, np.int64), device=device)
            best = logits.max(dim=-1).values
            served_gaps.append((best - logits.gather(1, served[:, None])[:, 0]).cpu().numpy())
            if control is not None:
                ctl = ref.logits(model, control, tokens, first, group).argmax(dim=-1)
                control_gaps.append((best - logits.gather(1, ctl[:, None])[:, 0]).cpu().numpy())
            del logits
    cat = (lambda g: np.concatenate(g) if g else np.zeros(0))
    return cat(served_gaps), (cat(control_gaps) if control is not None else None)


def summary(g: np.ndarray) -> dict:
    """Mean and widest gap, and the share of positions off the reference's
    first token."""
    if g.size == 0:
        return {"mean": 0.0, "widest": 0.0, "off_share": 0.0}
    return {"mean": float(g.mean()), "widest": float(g.max()), "off_share": float((g > 0).mean())}


def check(run, params, served: list, cast: Optional[Callable] = None) -> dict:
    """The cell's checks, each ``{"value", "limit"}``, correct when every
    value is at most its limit; with ``cast`` also the control's gap."""
    from portbench.harness import load_module
    from portbench.reference import common

    spec = run.cell["correctness"]
    picked = sample(served, run.seed, spec["sample"])
    common.highest_precision()
    ref = load_module(run.root / "reference" / f"{run.config['reference']}.py",
                      f"portbench_reference_{run.config['reference']}")
    weights = common.Weights(params)
    control = common.Weights(params, cast) if cast is not None else None
    vocab = run.model["vocab_size"]
    outside = sum(int(not 0 <= x < vocab) for _p, t, _g in picked for x in t)
    served_g, control_g = (gaps(run.model, ref, weights, picked, run.device, control)
                           if not outside else (np.full(1, 1e30), None))
    s = summary(served_g)
    checks = {
        "unserved": {"value": int(not served), "limit": 0},
        "out_of_vocab": {"value": outside, "limit": 0},
        "mean_logit_gap": {"value": s["mean"], "limit": spec["mean_logit_gap_limit"]},
    }
    run.counters.update(tokens_compared=int(served_g.size), widest_gap=s["widest"],
                        off_share=s["off_share"])
    if control_g is not None:
        c = summary(control_g)
        run.counters.update(control_mean_gap=c["mean"], control_widest_gap=c["widest"],
                            control_off_share=c["off_share"])
    return checks
