"""Host waits for the device the program counted (its host reads and the
blocks where torch waits, each span's `syncs`) in the window, per chunk
call."""

import program_spans


def read(rec):
    w = program_spans.window(rec)
    if w is None:
        return None
    spans = w[0]
    chunks = sum(s.name == "chunk" for s in spans)
    if not chunks:
        return None
    return sum(s.syncs for s in spans) / chunks
