"""Share of the device's idle time in the profiled slice that falls inside
the loop node's spans (loop.*, pgo): the complement of the slice's device
events between its ends, intersected with those spans mapped onto the
profiler's clock (profiling.to_profiler_ns)."""

import program_spans


def read(rec):
    t = rec.trace
    w = program_spans.window(rec)
    if w is None or not t.prof_s or t.prof_s[1] is None:
        return None
    to_prof = program_spans.recorder().to_profiler_ns
    lo, hi = (to_prof(int(x * 1e9)) for x in t.prof_s)
    busy = program_spans.union((max(a, lo), min(b, hi)) for _, a, b in t.device_events()
                               if b > lo and a < hi)
    if not busy:
        return None
    idle, at = [], lo
    for a, b in busy:
        if a > at:
            idle.append([at, a])
        at = max(at, b)
    if at < hi:
        idle.append([at, hi])
    idle_ns = sum(b - a for a, b in idle)
    if idle_ns <= 0:
        return None
    loop = program_spans.union((to_prof(s.t0), to_prof(s.t1)) for s in w[0]
                               if program_spans.is_loop_node(s))
    return 100.0 * program_spans.overlap(idle, loop) / idle_ns
