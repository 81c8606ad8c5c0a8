"""100 - the share of the profiled slice in which an operation ran on the
card (the union of the profiler's device events)."""


def read(rec):
    b = rec.trace.busy() if rec.trace is not None else None
    if b is None or b[1] <= 0:
        return None
    return 100.0 * (1.0 - b[0] / b[1])
