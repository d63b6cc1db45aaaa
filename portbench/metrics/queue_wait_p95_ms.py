"""95th percentile, over every request due in the window, of the time from
its due time to its admission (the scheduler's ``RequestMetrics.admitted``:
its prefill's dispatch); one not admitted by the window's end counts at
its wait so far."""
from portbench.stats import percentile


def read(run):
    lo, hi = run.layer_window()
    waits = []
    for tr in run.requests:
        if not lo <= tr.due <= hi:
            continue
        a = tr.req.metrics.admitted
        waits.append((a if 0 < a <= hi else hi) - tr.due)
    return 1e3 * percentile(waits, 95) if waits else None
