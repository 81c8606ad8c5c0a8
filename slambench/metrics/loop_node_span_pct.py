"""Share of the window in the loop node's spans at the top of the chunk
ends (loop.resolve, loop.ingest, loop.gate, and what they hold: the
verification, its acceptance, PGO, the vocabulary), as the program records
them, no sync added."""

import program_spans


def read(rec):
    w = program_spans.window(rec)
    if w is None:
        return None
    spans, window_ns = w
    ends = {s.id for s in spans if s.name == "chunk.end"}
    if not ends:
        return None
    top = [s for s in spans if s.parent in ends and program_spans.is_loop_node(s)]
    return 100.0 * sum(s.t1 - s.t0 for s in top) / window_ns
