"""The program's own spans (flvis_tpu_torch.utils.profiling) in a traced
run's window, for the metric readers that read them.

The window is the tracer's [t0, t1] on the host's perf_counter, the spans'
own clock.  A program without the recorder, or a run with no spans in the
window, gives None, and so does every reader built on it.
"""

from __future__ import annotations

LOOP_NODE = ("loop.", "pgo")        # span names (prefix, exact) of the loop node's work


def recorder():
    """flvis_tpu_torch.utils.profiling, or None where it has no spans."""
    try:
        from flvis_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def window(rec):
    """(the spans that lie wholly in the traced window, its length in ns),
    or None."""
    t = rec.trace
    prof = recorder()
    if t is None or prof is None or t.t0 is None or t.t1 is None or t.t1 <= t.t0:
        return None
    spans = prof.spans(int(t.t0 * 1e9), int(t.t1 * 1e9))
    if not spans:
        return None
    return spans, (t.t1 - t.t0) * 1e9


def before_profile(rec, spans) -> list:
    """The spans that ended before the traced run's profiler started (all of
    them where it took no profile): launches in and after the profiled slice
    run slower than untraced ones, so a reader of the step's own time keeps
    to the window's untraced part."""
    prof_s = rec.trace.prof_s
    if not prof_s:
        return spans
    start = int(prof_s[0] * 1e9)
    return [s for s in spans if s.t1 < start]


def is_loop_node(span) -> bool:
    return span.name.startswith(LOOP_NODE[0]) or span.name == LOOP_NODE[1]


def union(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs, ys) -> int:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
