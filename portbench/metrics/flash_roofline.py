"""The prefill flash kernel's share of its roofline in the traced window:
the summed least time of its calls (one per attention layer per prefill
dispatch; Q, K, V and O of each unpadded prompt once, causal QK and PV)
over the device time of the kernels this pattern names."""
from portbench.roofline import bound_s, flash_call

KERNEL = r"flash_(wgmma_)?kernel"


def read(run):
    tr = run.device_trace
    if tr is None or tr.t1 is None:
        return None
    busy = tr.matching(KERNEL)
    m = run.model
    cap = run.cell["engine"]["max_prompt_len"]
    least = 0.0
    for _n, _a, _b, _t, d in run.spans.named("engine.prefill", tr.t0, tr.t1):
        nbytes, flops = flash_call([min(n, cap) for n in d["prompts"]], m["n_heads"],
                                   m["n_kv_heads"], m["head_dim"])
        least += m["n_layers"] * bound_s(nbytes, flops)[0]
    return 100.0 * least / busy if busy > 0 and least > 0 else None
