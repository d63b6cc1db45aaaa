"""95th percentile, over every request due in the window, of the time from
its due time to the moment the benchmark sees its first token; a request
with none when the window closes counts at its wait so far."""
from portbench.stats import percentile


def read(run):
    waits = [(tr.first if tr.first is not None and tr.first <= run.t1 else run.t1) - tr.due
             for tr in run.requests if run.t0 <= tr.due <= run.t1]
    return 1e3 * percentile(waits, 95) if waits else None
