"""Share of the window the host waits in the chunk ends' one fetch for the
device (chunk.fetch's `sync_ns`)."""

import program_spans


def read(rec):
    w = program_spans.window(rec)
    if w is None:
        return None
    spans, window_ns = w
    fetches = [s for s in spans if s.name == "chunk.fetch"]
    if not fetches:
        return None
    return 100.0 * sum(s.sync_ns for s in fetches) / window_ns
