"""Mean wait of a scheduler drive for the query service's lock: the
port's ``bridge.lock_wait`` under each ``bridge.drive`` inside the traced
window (0 where it recorded none), over those drives."""


def read(run):
    drives = run.program_named("bridge.drive")
    if not drives:
        return None
    waits = {s.parent: s.end - s.start for s in run.program_spans if s.name == "bridge.lock_wait"}
    return 1e3 * sum(waits.get(d.id, 0.0) for d in drives) / len(drives)
