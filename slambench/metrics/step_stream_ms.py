"""The captured step's stream time a replay: the CUDA-event time from
before a chunk's first replay to after its last (step.run's `stream_ns`,
read at the chunk's end), summed over the chunks of the window that ended
before the profiler started, over their replays.  Where the host enqueues
slower than the card runs, the stream waits for it inside this time."""

import program_spans


def read(rec):
    w = program_spans.window(rec)
    if w is None:
        return None
    runs = [s for s in program_spans.before_profile(rec, w[0])
            if s.name == "step.run" and "stream_ns" in s.attrs]
    n = sum(s.attrs["replays"] for s in runs)
    if not n:
        return None
    return sum(s.attrs["stream_ns"] for s in runs) / n / 1e6
