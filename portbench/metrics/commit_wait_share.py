"""Share of the traced window that prefill commits spend waiting for
their first tokens: the port's ``commit.wait`` spans (inside
``prefill.commit``, the host blocked on the dispatched prefill), clipped
to the window, over its length.  While it waits, no decode tick runs.
A run with no commit recorded reads nothing."""


def read(run):
    waits = [(s.start, s.end) for s in run.program_spans or () if s.name == "commit.wait"]
    if not waits:
        return None
    lo, hi = run.layer_window()
    return 100.0 * sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in waits) / (hi - lo)
