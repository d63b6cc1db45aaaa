"""Active lanes per decode tick over the engine's lanes, averaged over the
ticks in the window (a tick with no active lane does no work and is not a
tick)."""


def read(run):
    lo, hi = run.layer_window()
    ticks = [d for _n, _a, _b, _t, d in run.spans.named("engine.tick", lo, hi) if d is not None]
    if not ticks:
        return None
    n_lanes = run.cell["engine"]["n_lanes"]
    return 100.0 * sum(len(d) for d in ticks) / (len(ticks) * n_lanes)
