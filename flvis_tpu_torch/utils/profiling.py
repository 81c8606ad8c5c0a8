"""The port's tracer: spans and counts on the host clock, the host's waits
for the device, and device traces (the port's counterpart of
flvis_tpu/utils/profiling.py).

The reference's only instrumentation is wall-clock tic_toc_ros stopwatches
(the reference: src/utils/include/tic_toc_ros.h:13-36) and the per-frame
solving-time overlay (f2f_tracking.cpp:65,397-399).  Here one recorder,
always on unless `enable(False)`:

  - `span(name, chunk=, seq=, **attrs)`: a context manager stamping
    time.perf_counter_ns() at entry and exit.  It records its parent (a
    per-thread stack), the chunk it serves (a parent's, unless given:
    `new_chunk()` makes an id) and the sequence `seq` (likewise).  Counts
    are the span's attributes (its `set` and `add`), so a count over a
    time window is a sum over its spans.
  - `host_read(*tensors, site=)`: the one funnel for the program's device →
    host reads; each tensor read adds 1 to the innermost open span's
    `syncs` and the host's wait to its `sync_ns`.  `host_sync(site)` counts
    the same for a block in which torch itself waits for the device (an
    upload from pageable host memory, an error flag read back).  The count
    is of call sites: a system on the CPU counts the reads its card
    counterpart would block on.
  - Finished spans go to a bounded ring (`RING` spans; `spans(since_ns,
    until_ns)` reads a window of it); per-name aggregates (calls, total,
    self, syncs, sync time) and per-site sync counts outlive the ring
    (`totals()`, `sites()`, `report()`).
  - `to_profiler_ns(t)` maps a span's stamp onto torch.profiler's event
    clock (the Unix-epoch clock of time.time_ns()), from an anchor pair
    refreshed at every chunk, so spans join a device trace without being
    in it.
  - `device_trace(log_dir)`: a host + device trace of the block; inside it,
    and only there, each span also enters record_function("flvis." + name),
    so the trace shows the program's spans beside the device's kernels.

Recording costs host clock reads and one tuple a span: no device sync, no
device allocation, no record_function outside device_trace.  Importing
this package keeps CUPTI up between traces (flvis_tpu_torch/__init__.py),
so a captured frame step can be traced more than once in a process.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch

RING = 1 << 15          # finished spans kept for spans(); ~2,300 in a 40 s window of a cell

Span = collections.namedtuple(
    "Span", "id parent name t0 t1 self_ns chunk seq syncs sync_ns attrs")
Span.__doc__ = """A finished span: stamps t0/t1 (perf_counter_ns), self_ns (its
time less its children's), its own host waits (syncs, sync_ns) and its
attributes (counts, routes)."""

_on = True
_mirror = False                 # inside device_trace: spans enter record_function
_tls = threading.local()
_lock = threading.Lock()
_ids = itertools.count(1)
_chunks = itertools.count(1)
_ring: collections.deque = collections.deque(maxlen=RING)
_agg: dict = {}                 # name -> [calls, total_ns, self_ns, syncs, sync_ns]
_sites: dict = {}               # site -> [syncs, sync_ns]
_offset = 0                     # time.time_ns() - time.perf_counter_ns() at the last anchor


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _anchor() -> None:
    """Refresh the perf_counter → Unix-epoch offset from a tight pair of
    reads (the wall clock between two perf_counter reads)."""
    global _offset
    p0 = time.perf_counter_ns()
    w = time.time_ns()
    p1 = time.perf_counter_ns()
    _offset = w - (p0 + p1) // 2


_anchor()


class _Null:
    """What span() gives while recording is off: every call a no-op."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        pass

    def add(self, **kw):
        pass


_NULL = _Null()


class _Open:
    """An open span (module note)."""

    __slots__ = ("name", "chunk", "seq", "attrs", "id", "parent", "t0", "child_ns", "syncs",
                 "sync_ns", "_rf")

    def __init__(self, name, chunk, seq, attrs):
        self.name, self.chunk, self.seq, self.attrs = name, chunk, seq, attrs

    def set(self, **kw):
        """Set attributes (they may be set after the span closed too)."""
        self.attrs.update(kw)

    def add(self, **kw):
        """Add to numeric attributes."""
        a = self.attrs
        for k, v in kw.items():
            a[k] = a.get(k, 0) + v

    def __enter__(self):
        st = _stack()
        if st:
            p = st[-1]
            self.parent = p.id
            if self.chunk is None:
                self.chunk = p.chunk
            if self.seq is None:
                self.seq = p.seq
        else:
            self.parent = 0
            if self.chunk is None:
                self.chunk = 0
        self.id = next(_ids)
        self.child_ns = self.syncs = self.sync_ns = 0
        st.append(self)
        self._rf = None
        if _mirror:
            self._rf = torch.profiler.record_function("flvis." + self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        st = _stack()
        st.pop()
        dur = t1 - self.t0
        if st:
            st[-1].child_ns += dur
        self_ns = dur - self.child_ns
        _ring.append((self.id, self.parent, self.name, self.t0, t1, self_ns, self.chunk,
                      self.seq, self.syncs, self.sync_ns, self.attrs))
        with _lock:
            a = _agg.get(self.name)
            if a is None:
                a = _agg[self.name] = [0, 0, 0, 0, 0]
            a[0] += 1
            a[1] += dur
            a[2] += self_ns
            a[3] += self.syncs
            a[4] += self.sync_ns
        return False


def span(name: str, chunk: int | None = None, seq: int | None = None, **attrs):
    """A span of `name` over a `with` block (module note); the object it
    gives takes further attributes through set()/add()."""
    if not _on:
        return _NULL
    return _Open(name, chunk, seq, attrs)


def new_chunk() -> int:
    """A fresh chunk id (and a fresh clock anchor for to_profiler_ns)."""
    _anchor()
    return next(_chunks)


def _count_sync(site: str, n: int, ns: int) -> None:
    if not _on or not n:
        return
    st = getattr(_tls, "stack", None)
    if st:
        st[-1].syncs += n
        st[-1].sync_ns += ns
    with _lock:
        s = _sites.get(site)
        if s is None:
            s = _sites[site] = [0, 0]
        s[0] += n
        s[1] += ns


def host_read(*tensors, site: str):
    """Each tensor's values on the host (a numpy array; None passes), one
    counted device → host read each: the array for one tensor, a list for
    several."""
    t0 = time.perf_counter_ns()
    out = [None if t is None else t.detach().cpu().numpy() for t in tensors]
    _count_sync(site, sum(t is not None for t in tensors), time.perf_counter_ns() - t0)
    return out[0] if len(tensors) == 1 else out


class host_sync:
    """`with host_sync(site, n):` counts n host waits for the device inside
    the block (where torch itself waits: an upload from pageable host
    memory, an error flag read back) and the block's time."""

    __slots__ = ("site", "n", "t0")

    def __init__(self, site: str, n: int = 1):
        self.site, self.n = site, n

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _count_sync(self.site, self.n, time.perf_counter_ns() - self.t0)
        return False


def enable(flag: bool = True) -> bool:
    """Turn recording on or off (on by default); returns the previous
    setting.  Off, span() and the counters record nothing."""
    global _on
    prev, _on = _on, bool(flag)
    return prev


def enabled() -> bool:
    return _on


def reset(capacity: int | None = None) -> None:
    """Forget every span, aggregate and site count; optionally resize the
    ring."""
    global _ring
    with _lock:
        _ring = collections.deque(maxlen=capacity or _ring.maxlen)
        _agg.clear()
        _sites.clear()


def spans(since_ns: int | None = None, until_ns: int | None = None) -> list:
    """The ring's spans that lie wholly in [since_ns, until_ns]
    (perf_counter_ns; either end open when None), in the order they
    finished."""
    lo = -(1 << 62) if since_ns is None else since_ns
    hi = (1 << 62) if until_ns is None else until_ns
    return [Span(*s) for s in list(_ring) if s[3] >= lo and s[4] <= hi]


def capacity() -> int:
    return _ring.maxlen


def totals() -> dict:
    """{name: {calls, total_ns, self_ns, syncs, sync_ns}} since the last
    reset, every span counted (the ring's bound does not apply)."""
    keys = ("calls", "total_ns", "self_ns", "syncs", "sync_ns")
    with _lock:
        return {n: dict(zip(keys, a)) for n, a in _agg.items()}


def sites() -> dict:
    """{site: (syncs, sync_ns)} since the last reset."""
    with _lock:
        return {s: tuple(v) for s, v in _sites.items()}


def report() -> str:
    """Per-name time, calls and host waits, most time first, then the host
    waits by site."""
    lines = []
    tot = totals()
    for name in sorted(tot, key=lambda n: -tot[n]["total_ns"]):
        a = tot[name]
        n = max(a["calls"], 1)
        lines.append(f"{name:20s} {a['total_ns'] / 1e6 / n:9.3f} ms/call ×{a['calls']:<6d} "
                     f"({a['total_ns'] / 1e9:.3f} s total, {a['self_ns'] / 1e9:.3f} s self; "
                     f"{a['syncs']} syncs, {a['sync_ns'] / 1e9:.3f} s waiting)")
    for site, (n, ns) in sorted(sites().items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  sync {site:30s} ×{n:<6d} {ns / 1e9:.3f} s")
    lines.append(f"spans kept: {len(_ring)} of {_ring.maxlen}")
    return "\n".join(lines)


def to_profiler_ns(t_ns: int) -> int:
    """A perf_counter_ns stamp on torch.profiler's event clock (a kineto
    event's start_ns(): the Unix-epoch clock)."""
    return t_ns + _offset


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A host + device trace of the block (torch.profiler), written to
    log_dir/trace.json for Perfetto or chrome://tracing, with the program's
    spans in it as "flvis.<name>" ranges."""
    global _mirror
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _anchor()
    with profile(activities=activities) as prof:
        prev, _mirror = _mirror, True
        try:
            yield prof
        finally:
            _mirror = prev
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
