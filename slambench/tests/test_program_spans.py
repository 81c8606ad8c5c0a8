"""CPU tests of the readers of the program's own spans (metrics/*.py over
program_spans.py) at the harness's tiny cells.

    python -m pytest slambench/tests -q

The tiny traced cells report every new metric the CPU can give (the
stream time and the device's idle share need a card), and the program's
spans never reach the benchmark's own profile: no event of the traced
slice is named "flvis.*", so device_idle_pct and breakdown read the trace
they read before.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
for _p in (HERE.parent, HERE, Path(__file__).resolve().parent):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import program_spans  # noqa: E402
from test_slambench_harness import _run, tiny_root  # noqa: E402,F401

ON_THE_CPU = {"step_copy_ms", "fetch_wait_pct", "host_syncs_per_chunk", "loop_node_span_pct",
              "pgo_span_pct", "verify_ms_per_pair"}
CARD_ONLY = {"step_stream_ms", "idle_in_loop_node_pct"}


def _profile_on_the_cpu(monkeypatch) -> list:
    """The tracer's profile of the traced slice, on the CPU: a stand-in for
    the captured step whose replay() (the tracer wraps it) runs before
    each eager frame step; returns the list the slice's events go to."""
    from types import SimpleNamespace

    import driver
    import instruments
    from flvis_tpu_torch.parallel import multiseq
    from flvis_tpu_torch.pipeline import runner

    cap = SimpleNamespace(step=SimpleNamespace(replay=lambda: None, node_stats=lambda: None))
    for cls in (driver.Single, driver.Multi):
        monkeypatch.setattr(cls, "captured", lambda self: [cap])
    for mod in (runner, multiseq):
        real = mod.run_chunk_eager

        def eager(step, *a, _real=real, **kw):
            def each(*b):
                cap.step.replay()
                return step(*b)
            return _real(each, *a, **kw)

        monkeypatch.setattr(mod, "run_chunk_eager", eager)
    profiles = []
    real_stop = instruments.Tracer._stop

    def stop(self):
        real_stop(self)
        profiles.append(self.events)

    monkeypatch.setattr(instruments.Tracer, "_stop", stop)
    return profiles


@pytest.mark.parametrize("workload", ["tiny.replay", "tiny.fleet"])
def test_tiny_traced_cells_read_the_programs_spans(tiny_root, monkeypatch, workload):  # noqa: F811
    profiles = _profile_on_the_cpu(monkeypatch)
    out = _run(tiny_root, workload, traced=True)
    assert out["correct"] is True, out["checks"]
    got = out["metrics"]
    assert ON_THE_CPU <= set(got), sorted(got)
    assert not CARD_ONLY & set(got)
    assert got["host_syncs_per_chunk"]["value"] >= 1          # the chunk end's fetch
    assert 0 < got["loop_node_span_pct"]["value"] < 100
    assert 0 <= got["pgo_span_pct"]["value"] < got["loop_node_span_pct"]["value"]
    assert 0 <= got["fetch_wait_pct"]["value"] < 100
    assert got["verify_ms_per_pair"]["value"] > 0
    assert profiles and profiles[0], "the traced slice holds no events"
    names = {e.name() for ev in profiles for e in ev}
    assert not [n for n in names if n.startswith("flvis.")]


def test_interval_helpers():
    assert program_spans.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]
    assert program_spans.overlap([[0, 3], [5, 8]], [[2, 6]]) == 2
    assert program_spans.overlap([[0, 1]], [[1, 2]]) == 0


def test_readers_give_none_without_the_recorder(monkeypatch):
    """A program without the recorder (the benchmark laid over an older
    tree): every reader of the spans returns None and raises nothing."""
    from types import SimpleNamespace

    from spec import Spec

    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    rec = SimpleNamespace(trace=SimpleNamespace(t0=1.0, t1=2.0, prof_s=[1.0, 2.0],
                                                device_events=lambda: []))
    spec = Spec(HERE.parent)
    for name in ON_THE_CPU | CARD_ONLY:
        assert spec.reader(name)(rec) is None, name


def test_step_readers_keep_to_the_part_before_the_profile(monkeypatch):
    """step_stream_ms and step_copy_ms read only the step.run spans that
    ended before the profiler started (launches in and after the profiled
    slice run slower); with no profile taken, every span of the window."""
    from types import SimpleNamespace

    from spec import Spec

    def run(t0, t1, stream_ms, self_ms):
        return SimpleNamespace(name="step.run", t0=t0, t1=t1, self_ns=self_ms * 1e6,
                               attrs={"replays": 2, "stream_ns": stream_ms * 1e6})

    spans = [run(1.1e9, 1.2e9, 40, 2), run(1.3e9, 1.4e9, 44, 4), run(1.6e9, 1.7e9, 900, 90)]
    monkeypatch.setattr(program_spans, "recorder", lambda: SimpleNamespace(
        spans=lambda lo, hi: [s for s in spans if s.t0 >= lo and s.t1 <= hi]))
    spec = Spec(HERE.parent)
    traced = SimpleNamespace(trace=SimpleNamespace(t0=1.0, t1=2.0, prof_s=[1.5, 1.55]))
    assert spec.reader("step_stream_ms")(traced) == pytest.approx(21.0)
    assert spec.reader("step_copy_ms")(traced) == pytest.approx(1.5)
    untraced = SimpleNamespace(trace=SimpleNamespace(t0=1.0, t1=2.0, prof_s=None))
    assert spec.reader("step_stream_ms")(untraced) == pytest.approx(984 / 6)
    early = SimpleNamespace(trace=SimpleNamespace(t0=1.0, t1=2.0, prof_s=[1.05, 1.1]))
    assert spec.reader("step_stream_ms")(early) is None
