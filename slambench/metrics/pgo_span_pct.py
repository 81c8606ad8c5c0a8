"""Share of the window in LoopCloser.optimize_graph's `pgo` spans (a call
the throttle skips included), as the program records them, no sync
added."""

import program_spans


def read(rec):
    w = program_spans.window(rec)
    if w is None:
        return None
    spans, window_ns = w
    if not any(s.name == "chunk" for s in spans):
        return None
    return 100.0 * sum(s.t1 - s.t0 for s in spans if s.name == "pgo") / window_ns
