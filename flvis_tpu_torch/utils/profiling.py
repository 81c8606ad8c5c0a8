"""Per-stage timing and device tracing (port of flvis_tpu/utils/profiling.py).

The reference's only instrumentation is wall-clock tic_toc_ros stopwatches
(the reference: src/utils/include/tic_toc_ros.h:13-36) and the per-frame
solving-time overlay (f2f_tracking.cpp:65,397-399).  Here: a stage timer
that waits for the device at each stage boundary (timing.sync), so the
split is honest under CUDA's asynchronous launches, plus a thin wrapper over
torch.profiler for a full host + device trace.  Importing this package
keeps CUPTI up between traces (flvis_tpu_torch/__init__.py), so a captured
frame step can be traced more than once in a process.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

from .timing import sync as _sync


class StageTimer:
    """Accumulates wall time per named stage; a device sync at each boundary
    charges each stage its own device time (without it, CUDA's asynchronous
    launches move the time to the first later sync point)."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        """Time the block; set box["out"] to the block's tensors to wait for
        them at its end."""
        t0 = time.perf_counter()
        box = {}
        yield box
        if self.sync and box.get("out") is not None:
            _sync(box["out"])
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def record(self, name: str, out):
        """Convenience: time the completion of `out` from now."""
        t0 = time.perf_counter()
        _sync(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            tot = self.totals[name]
            n = max(self.counts[name], 1)
            lines.append(f"{name:28s} {1e3 * tot / n:8.2f} ms/call ×{n}  ({tot:.2f} s total)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A host + device trace of the block (torch.profiler), written to
    log_dir/trace.json for Perfetto or chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
