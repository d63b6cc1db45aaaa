"""Model FLOPs of the useful work in the window over the H100's 989
TFLOP/s (bf16, dense): every unpadded prompt (its last dispatch, the one
that served it) and every active lane's decode token, as ``flops.py``
counts them (or the configuration's own layout, ``layouts/``), over the
window's seconds."""
from portbench.layouts import model_flops
from portbench.roofline import BF16_FLOPS_PER_S


def read(run):
    lo, hi = run.layer_window()
    mf = model_flops(run)
    last = {}
    for _n, a, b, _t, d in sorted(run.spans.named("engine.prefill", lo, hi), key=lambda s: s[1]):
        for r, n in zip(d["requests"], d["prompts"]):
            last[id(r)] = min(n, run.cell["engine"]["max_prompt_len"])
    work = sum(mf.prefill(n) for n in last.values())
    work += sum(mf.decode(d) for _n, _a, _b, _t, d in run.spans.named("engine.tick", lo, hi)
                if d is not None)
    return 100.0 * work / ((hi - lo) * BF16_FLOPS_PER_S) if work else None
