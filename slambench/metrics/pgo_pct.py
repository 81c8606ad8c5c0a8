"""Share of the window spent in LoopCloser.optimize_graph (PGO), timed on
the host clock ending in a sync."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * t.pgo_s / t.window_s
