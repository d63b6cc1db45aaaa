"""95th percentile of a query's wait in the runtime: the port's
``runtime.queued`` spans (a handle from its submission until a worker
takes it into a batch) that lie inside the traced window."""
from portbench.stats import percentile


def read(run):
    waits = [s.end - s.start for s in run.program_named("runtime.queued") or ()]
    return 1e3 * percentile(waits, 95) if waits else None
