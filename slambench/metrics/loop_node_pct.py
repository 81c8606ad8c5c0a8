"""Share of the window spent in the loop node's LoopStage calls (resolve,
ingest, flush), each timed on the host clock ending in a sync."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * t.loop_s / t.window_s
