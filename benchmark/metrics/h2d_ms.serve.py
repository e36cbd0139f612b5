"""Device time of the host-to-device copies per traced batch (the
profiler's memcpy records): the 1.4 GB of a batch of 100 segments."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    ns = sum(b - a for kind, a, b in t.copies if kind == "HtoD")
    return ns / 1e6 / t.units if ns else None
