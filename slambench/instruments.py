"""The traced run's instruments: wrappers of the benchmark's own around
calls into the program, and a profile of a short steady slice.

  - each CapturedStep.replay call: host clock, no sync (replay_host_ms);
  - each LoopStage call (resolve, ingest, flush) and each
    LoopCloser.optimize_graph call: host clock ending in a sync, so the
    loop node's and PGO's device work is theirs (loop_node_pct, pgo_pct);
  - torch.profiler over `profile_replays` replays from a fixed position in
    a chunk (the slice holds a chunk end), started after a sync: the
    device's busy and idle time, each kernel's device time and launches
    (rooflines), the longest idle gaps by what the host was doing.

The step is captured in set-up, before the first trace: an 8-branch graph
captured after a trace faults when traced (PERF.md §6, PR 11).
"""

from __future__ import annotations

import collections
import time

import torch


class Tracer:
    def __init__(self, sut, traffic: dict, seconds: float, device):
        self.sut, self.device = sut, device
        self.chunk = int(traffic["chunk"])
        self.profile_replays = int(traffic.get("profile_replays", 16))
        self.profile_after = 0.3 * seconds
        self.replay_s = 0.0
        self.replays = 0                # in the window
        self.loop_s = 0.0
        self.pgo_s = 0.0
        self.t0 = self.t1 = None
        self.prof = None
        self.prof_from = None           # the window's replay the profile starts at
        self.prof_s = None              # (start, stop) host clock of the profiled slice
        self.events = None
        self.ba_work = []               # (W, L, live observations, pair terms) at the stop
        self.node_stats = None
        # The wrappers' host spans; the profiler mirrors each on the device
        # timeline as an annotation, which is no device work.
        self.labels = {"captured_step.replay", "loop_closer.optimize_graph"}
        for cap in sut.captured():
            self._wrap_replay(cap.step)
        for st in sut.stages():
            for name in ("resolve", "ingest", "flush"):
                self._wrap_synced(st, name, "loop_s", f"loop_stage.{name}")
                self.labels.add(f"loop_stage.{name}")
        for lc in sut.closers():
            self._wrap_synced(lc, "optimize_graph", "pgo_s", "loop_closer.optimize_graph")

    # ------------------------------------------------------------ wrappers
    def _wrap_replay(self, step) -> None:
        real = step.replay

        def replay():
            if self.t0 is not None and self.t1 is None:
                self._profile_edge()
                a = time.perf_counter()
                with torch.profiler.record_function("captured_step.replay"):
                    real()
                self.replay_s += time.perf_counter() - a
                self.replays += 1
            else:
                real()

        step.replay = replay

    def _wrap_synced(self, obj, name: str, total: str, label: str) -> None:
        real = getattr(obj, name)

        def call(*a, **kw):
            if self.t0 is None or self.t1 is not None:
                return real(*a, **kw)
            t = time.perf_counter()
            with torch.profiler.record_function(label):
                out = real(*a, **kw)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            setattr(self, total, getattr(self, total) + time.perf_counter() - t)
            return out

        setattr(obj, name, call)

    # ------------------------------------------------------------- profile
    def _profile_edge(self) -> None:
        """Start the profile at the first replay past profile_after at the
        slice's position in a chunk; stop it profile_replays replays on."""
        now = time.perf_counter()
        if self.prof is None and self.events is None:
            pos = (self.chunk - 8) % self.chunk
            if now - self.t0 >= self.profile_after and self.replays % self.chunk == pos:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                    torch.cuda.synchronize(self.device)
                self.prof = profile(activities=acts)
                self.prof.start()
                self.prof_from = self.replays
                self.prof_s = [time.perf_counter(), None]
        elif self.prof is not None and self.replays - self.prof_from >= self.profile_replays:
            self._stop()

    def _stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof_s[1] = time.perf_counter()
        self.prof.stop()
        self.events = list(self.prof.profiler.kineto_results.events())
        self.prof = None
        for ba in self.sut.ba_states():
            w = ba.obs_valid & ba.kf_valid[:, None] & ba.lm_valid[None, :]
            per_lm = w.sum(0).double()
            self.ba_work.append((w.shape[0], w.shape[1], float(w.sum()),
                                 float((per_lm * per_lm).sum())))

    def start_window(self, t0: float) -> None:
        self.t0 = t0

    def end_window(self, t1: float) -> None:
        if self.prof is not None:
            self._stop()
        self.t1 = t1
        caps = self.sut.captured()
        if caps:
            self.node_stats = caps[0].step.node_stats()

    # -------------------------------------------------------------- reads
    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def device_events(self):
        """[(name, start ns, end ns)] of the profile's device activity:
        kernels, copies and sets, not the wrappers' annotations."""
        from torch.autograd import DeviceType

        if not self.events:
            return []
        return [(e.name(), e.start_ns(), e.end_ns()) for e in self.events
                if e.device_type() == DeviceType.CUDA and e.name() not in self.labels]

    def busy(self):
        """(busy seconds: the union of the device events' intervals, the
        profiled slice's host seconds), or None without device events."""
        spans = sorted((a, b) for _, a, b in self.device_events())
        if not spans:
            return None
        union, end = 0, None
        for a, b in spans:
            if end is None or a > end:
                union += b - a
                end = b
            elif b > end:
                union += b - end
                end = b
        return union / 1e9, self.prof_s[1] - self.prof_s[0]

    def kernel(self, marker: str):
        """(launches, device seconds) of the device events whose name holds
        `marker`."""
        ev = [(a, b) for n, a, b in self.device_events() if marker in n]
        return len(ev), sum(b - a for a, b in ev) / 1e9

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the 10 longest
        idle gaps, each named by the innermost host span around its middle."""
        from torch.autograd import DeviceType

        dev = self.device_events()
        if not dev:
            return {}
        per = collections.Counter()
        for n, a, b in dev:
            per[n] += (b - a) / 1e9
        spans = sorted((a, b) for _, a, b in dev)
        gaps, end = [], spans[0][1]
        for a, b in spans[1:]:
            if a > end:
                gaps.append((a - end, end, a))
            end = max(end, b)
        gaps.sort(reverse=True)
        host = [(e.start_ns(), e.end_ns(), e.name()) for e in self.events
                if e.device_type() == DeviceType.CPU]
        named = []
        for length, a, b in gaps[:10]:
            mid = (a + b) // 2
            inner = [h for h in host if h[0] <= mid <= h[1]]
            name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "no host span"
            named.append([name, length / 1e9])
        return {"device_ops": [[n, s] for n, s in per.most_common(10)], "idle_gaps": named}
