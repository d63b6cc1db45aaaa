"""Set-up seconds: from the process's start to the first timed operation
(loading, weights, warm-up and, on a checkout's first run, kernel builds
and graph recordings)."""


def read(run):
    return run.setup_s
