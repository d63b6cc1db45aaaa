"""Host work of a decode tick before its launch: the mean of the port's
``decode.prep`` spans (``_prepare_tick``: the lane arrays into the tick
step's static inputs) of the ticks with an active lane inside the
traced window."""


def read(run):
    ticks = run.program_named("decode.tick")
    if ticks is None:
        return None
    live = {s.id for s in ticks if s.data.get("positions")}
    preps = [s.end - s.start for s in run.program_named("decode.prep") if s.parent in live]
    return 1e3 * sum(preps) / len(preps) if preps else None
