"""Share of the traced window in which no operation ran on the device:
1 - the union of the trace's device intervals over the window."""


def read(run):
    tr = run.device_trace
    if tr is None or tr.t1 is None or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
