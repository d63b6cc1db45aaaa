"""Host wall of the engine's decode ticks in the window over their count
(each tick: lane state in, the compiled tick replayed, tokens out)."""


def read(run):
    lo, hi = run.layer_window()
    walls = [b - a for _n, a, b, _t, d in run.spans.named("engine.tick", lo, hi) if d is not None]
    return 1e3 * sum(walls) / len(walls) if walls else None
