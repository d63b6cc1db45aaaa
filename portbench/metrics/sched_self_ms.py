"""The scheduler's own time a tick: the mean, over the port's
``scheduler.tick`` spans inside the traced window, of a tick's
wall less the part of it that the engine's spans on its thread cover
(``decode.tick``, ``prefill.dispatch``, ``prefill.commit``): admission,
lane bookkeeping, retirement and the strategy's decisions."""
import bisect

from portbench.trace import union

ENGINE = ("decode.tick", "prefill.dispatch", "prefill.commit")


def read(run):
    ticks = run.program_named("scheduler.tick")
    if not ticks:
        return None
    by_thread: dict = {}
    for s in run.program_spans:
        if s.name in ENGINE:
            by_thread.setdefault(s.thread, []).append((s.start, s.end))
    for spans in by_thread.values():
        spans.sort()
    own = []
    for t in ticks:
        spans = by_thread.get(t.thread, [])
        inner = spans[bisect.bisect_left(spans, (t.start,)):
                      bisect.bisect_right(spans, (t.end, float("inf")))]
        own.append(t.end - t.start - sum(b - a for a, b in union(inner, t.start, t.end)))
    return 1e3 * sum(own) / len(own)
