"""The recorder (flvis_tpu_torch.utils.profiling) on the card, over a chunk
of each of the benchmark's cells (built by slambench/driver.py and warmed
up as the benchmark warms them): euroc.replay, a SlamSystem that uploads
its chunk through pinned memory, and euroc.fleet8, a pipelined
MultiSeqSlam of 8 sequences that uploads from pageable memory and ends 8
loop nodes' chunk in the next call.  Over a chunk whose end runs the loop
node's verification and PGO, the host waits the recorder counts equal the
synchronising operations torch reports under
torch.cuda.set_sync_debug_mode("warn"); the captured step's stream time is
positive and inside the chunk's host time.

Needs an NVIDIA GPU; every test skips without one (marker `cuda`).  This
file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_profiling_cuda.py -q -s
"""

from __future__ import annotations

import collections
import sys
import traceback
import warnings
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
SEED = 2147483701


def _need_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")


@pytest.fixture(scope="module", params=["euroc.replay", "euroc.fleet8"])
def cell(request):
    """The cell's system, warmed up as the benchmark warms it."""
    _need_a_card()
    for p in (ROOT, ROOT / "slambench"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import driver
    from spec import Spec

    spec = Spec(ROOT).cell(request.param)
    dev = torch.device("cuda", 0)
    sut, _ = driver.build(spec, SEED, dev)
    for frames, chunk in spec["traffic"]["warmup"]:
        for _ in range(int(frames) // int(chunk)):
            sut.chunk(int(chunk))
    torch.cuda.synchronize(dev)
    yield sut, int(spec["traffic"]["chunk"])
    del sut
    torch.cuda.empty_cache()


def _chunk_under_sync_debug(sut, T):
    """One chunk (the cell's process_frames_vio or process_chunk_vio call;
    the stream's frames are host arrays made in set-up) under
    set_sync_debug_mode("warn"): (the warnings' sites, the call's spans,
    the recorder's site counts of the call).  A pipelined call ends the
    chunk before it."""
    from flvis_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    before = profiling.sites()
    warned = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        # The innermost frame of the port's own code names the site; the
        # switch back to mode 0 warns once by itself, outside the program.
        if "synchroniz" in str(message):
            stack = traceback.extract_stack()[:-1]
            own = [f for f in stack if "flvis_tpu_torch" in f.filename]
            if own:
                warned[f"{Path(own[-1].filename).name}:{own[-1].lineno}"] += 1
            else:
                assert any(f.name == "set_sync_debug_mode" for f in stack), stack

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sut.chunk(T)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    after = profiling.sites()
    sites = {k: after[k][0] - before.get(k, (0, 0))[0] for k in after
             if after[k][0] != before.get(k, (0, 0))[0]}
    root = max((s for s in profiling.spans() if s.name == "chunk"), key=lambda s: s.t0)
    spans = [s for s in profiling.spans(root.t0, root.t1)]
    return warned, spans, sites


def test_host_syncs_match_sync_debug_mode(cell):
    """Over a chunk whose end verifies candidate pairs and solves PGO: the
    recorder's syncs (every span's, and by site) sum to the synchronising
    operations torch warns of; the chunk's one fetch is one of them."""
    sut, T = cell
    for _ in range(6):
        warned, spans, sites = _chunk_under_sync_debug(sut, T)
        names = collections.Counter(s.name for s in spans)
        pgo = [s for s in spans if s.name == "pgo" and s.attrs["route"] != "throttled"]
        pairs = sum(s.attrs.get("pairs", 0) for s in spans if s.name == "loop.verify")
        if pgo and pairs:
            break
    else:
        pytest.fail("no chunk end verified pairs and solved PGO in 6 chunks")
    counted = sum(s.syncs for s in spans)
    print(f"\nsync debug mode: {sum(warned.values())} warnings by site {dict(warned)}")
    print(f"recorder: {counted} syncs by site {sites}; spans {dict(names)}; "
          f"pgo {[s.attrs for s in pgo]}; pairs {pairs}")
    assert counted == sum(sites.values())
    assert sites["runner.fetch"] == 1
    assert counted == sum(warned.values()), (dict(warned), sites)


def test_stream_time_inside_the_chunk(cell):
    """step.run's stream_ns (CUDA events around the chunk's replays, read at
    its end) is positive and below the chunk's host time, from its call's
    start to its fetch (in the next call where pipelined); one chunk.fetch
    a chunk carries the taken counts' deltas."""
    from flvis_tpu_torch.utils import profiling

    sut, T = cell
    sut.chunk(T)
    sut.chunk(T)
    root = sorted((s for s in profiling.spans() if s.name == "chunk"), key=lambda s: s.t0)[-2]
    mine = [s for s in profiling.spans(root.t0) if s.chunk == root.chunk]
    run, = [s for s in mine if s.name == "step.run"]
    fetch, = [s for s in mine if s.name == "chunk.fetch"]
    assert run.attrs["replays"] == T
    assert sum(s.name == "step.replay" for s in mine) == T
    assert 0 < run.attrs["stream_ns"] < fetch.t1 - root.t0
    assert fetch.attrs["iterations_run"] > 0 and fetch.attrs["body_kernels"] > 0
    print(f"\nstream {run.attrs['stream_ns'] / 1e6:.3f} ms for {T} replays; host: step.run "
          f"{(run.t1 - run.t0) / 1e6:.3f} ms, call to fetch {(fetch.t1 - root.t0) / 1e6:.3f} "
          f"ms, fetch wait {fetch.sync_ns / 1e6:.3f} ms")


def test_spans_join_the_device_trace_clock():
    """Under torch.profiler with CUDA activity (torch's kineto clock on this
    machine): a record_function inside a span lies within the span mapped
    by to_profiler_ns, widened by 250 us.  Last in the file: the cells'
    graphs are captured before the process traces."""
    _need_a_card()
    from torch.profiler import ProfilerActivity, profile, record_function

    from flvis_tpu_torch.utils import profiling

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            profiling.new_chunk()
            with profiling.span("joined"):
                with record_function("probe"):
                    torch.ones(1 << 20, device="cuda").sum().item()
    spans = sorted((s for s in profiling.spans() if s.name == "joined"), key=lambda s: s.t0)[-3:]
    evs = sorted((e for e in prof.profiler.kineto_results.events() if e.name() == "probe"
                  and e.device_type() == torch.autograd.DeviceType.CPU),
                 key=lambda e: e.start_ns())
    assert len(evs) == 3
    for s, e in zip(spans, evs):
        lo = profiling.to_profiler_ns(s.t0) - 250_000
        hi = profiling.to_profiler_ns(s.t1) + 250_000
        assert lo <= e.start_ns() <= e.end_ns() <= hi, (lo, e.start_ns(), e.end_ns(), hi)
