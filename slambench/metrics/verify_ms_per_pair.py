"""Host milliseconds of the loop node's verification a candidate pair: the
dispatch (loop.verify) and the acceptance a chunk later (loop.accept) over
the window, over the pairs dispatched (loop.verify's `pairs`)."""

import program_spans


def read(rec):
    w = program_spans.window(rec)
    if w is None:
        return None
    spans = w[0]
    pairs = sum(s.attrs.get("pairs", 0) for s in spans if s.name == "loop.verify")
    if not pairs:
        return None
    ns = sum(s.t1 - s.t0 for s in spans if s.name in ("loop.verify", "loop.accept"))
    return ns / pairs / 1e6
