"""Padded rows over all rows of the prefill buckets the engine dispatched
in the window: ``batch * prompt`` of each dispatch against the prompt
tokens of the requests handed to it."""


def read(run):
    lo, hi = run.layer_window()
    rows = real = 0
    cap = run.cell["engine"]["max_prompt_len"]
    for _n, _a, _b, _t, d in run.spans.named("engine.prefill", lo, hi):
        rows += d["shape"][0] * d["shape"][1]
        real += sum(min(n, cap) for n in d["prompts"])
    return 100.0 * (rows - real) / rows if rows else None
