"""Query-runtime batching: the query service's requests over its scheduler
drives in the window (``SchedulerQueryService.stats``)."""


def read(run):
    c = run.counters
    if "drives1" not in c or c["drives1"] == c["drives0"]:
        return None
    return (c["requests1"] - c["requests0"]) / (c["drives1"] - c["drives0"])
