"""Output tokens seen in the window (first tokens and decoded ones), over
the window's seconds."""
from portbench.stats import rate


def read(run):
    return rate(sum(n for t, n in run.tokens if run.t0 <= t <= run.t1), run.window_s)
