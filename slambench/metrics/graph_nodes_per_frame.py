"""Kernel nodes a replay of the captured frame step runs, IF and WHILE
bodies weighted by their taken counts (CapturedStep.node_stats, the
program's own census)."""


def read(rec):
    if rec.trace is None or rec.trace.node_stats is None:
        return None
    return float(rec.trace.node_stats[0])
