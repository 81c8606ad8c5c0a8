"""Host milliseconds a frame step spends in step.run outside the replays
(step.run's self time: the per-frame input copies, draws and output
copies), over the frame steps of the window that ended before the profiler
started."""

import program_spans


def read(rec):
    w = program_spans.window(rec)
    if w is None:
        return None
    runs = [s for s in program_spans.before_profile(rec, w[0]) if s.name == "step.run"]
    n = sum(s.attrs.get("replays", 0) for s in runs)
    if not n:
        return None
    return sum(s.self_ns for s in runs) / n / 1e6
