"""Queries of the application programs returned to them in the window,
over the window's seconds."""
from portbench.stats import rate


def read(run):
    return rate(sum(1 for t in run.queries if run.t0 <= t <= run.t1), run.window_s)
