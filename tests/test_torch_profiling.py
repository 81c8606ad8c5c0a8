"""flvis_tpu_torch.utils.profiling, the port's recorder, on the CPU: the
spans of a chunked SlamSystem VIO run with the loop node and of a pipelined
MultiSeqSlam of 2 (nesting, parents, chunk ids, `seq`, one chunk.fetch a
chunk), the `pgo` span's attributes on a synthetic pose graph, the ring's
bound, the switch, the clock join with torch.profiler and the mirror into
record_function only inside device_trace().  Imports nothing of JAX."""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

import flvis_tpu_torch.config as tconfig
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.geometry.se3 import SE3
from flvis_tpu_torch.io.synthetic import PlanarScene, SceneConfig, imu_from_trajectory
from flvis_tpu_torch.loop import loop_closing, pose_graph
from flvis_tpu_torch.parallel.multiseq_loop import MultiSeqSlam
from flvis_tpu_torch.pipeline.runner import SlamSystem, depth_counts
from flvis_tpu_torch.utils import control, profiling

torch.set_num_threads(1)

SCFG = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                   baseline=0.12)
LOOP = dict(max_keyframes=64, num_orb_features=128, vocab_words=128, kf_start=10, kf_dist=8,
            kf_max_dist=64, nkf_closest=2, min_pts=12, min_score=0.03, ratio_ransac=0.3,
            seq_edge_successors=3)
N, CHUNK = 24, 8


def _cfg(**fe):
    """The CPU tests' tiny configuration (tests/test_torch_runner.py's VIO
    scene and loop node)."""
    return tconfig.SystemConfig(
        frontend=tconfig.FrontendConfig(width=SCFG.width, height=SCFG.height, num_slots=128,
                                        pyramid_levels=3, per_cell=8, min_distance=12.0,
                                        margin=22, kf_min_trans=0.04, **fe),
        backend=tconfig.BackendConfig(window_size=5, max_landmarks=256, iters1=8, iters2=4),
        loop=tconfig.LoopConfig(**LOOP))


def _cam():
    return tcam.make(SCFG.fx, SCFG.fy, SCFG.cx, SCFG.cy, SCFG.baseline, width=SCFG.width,
                     height=SCFG.height, device="cpu")


@pytest.fixture(scope="module")
def scene():
    """The 24-frame out-and-back of tests/test_torch_runner.py's VIO scene,
    with its per-frame IMU samples."""
    sc = PlanarScene(SCFG, plane_depth=8.0, seed=11)
    half = N // 2
    xs = list(np.linspace(0, 0.9, half)) + list(np.linspace(0.9, 0.02, N - half))
    poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
    frames = [sc.render(R, t)[:2] for (R, t) in poses]
    t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
    accs, gyros, imuts = [], [], []
    prev = -np.inf
    for ft in frame_t:
        m = (t_imu > prev) & (t_imu <= ft)
        accs.append(acc[m])
        gyros.append(gyro[m])
        imuts.append(t_imu[m])
        prev = ft
    return frames, frame_t, accs, gyros, imuts


def _by_id(spans):
    return {s.id: s for s in spans}


def _check_tree(spans):
    """Every span's parent finished after it and encloses it; children
    inherit their parent's chunk unless a chunk end names its own."""
    ids = _by_id(spans)
    for s in spans:
        assert s.t0 <= s.t1 and 0 <= s.self_ns <= s.t1 - s.t0
        if s.parent:
            p = ids[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1, (s.name, p.name)
            if s.name != "chunk.end":
                assert s.chunk == p.chunk, (s.name, p.name)


@pytest.fixture(scope="module")
def vio_spans(scene):
    frames, frame_t, accs, gyros, imuts = scene
    profiling.reset()
    slam = SlamSystem(_cfg(), _cam(), device="cpu", use_imu=True, use_loop=True)
    for c0 in range(0, N, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        slam.process_frames_vio(np.stack([f[0] for f in frames[sl]]),
                                np.stack([f[1] for f in frames[sl]]), ts=frame_t[sl],
                                imu_acc=accs[sl], imu_gyro=gyros[sl], imu_t=imuts[sl])
    slam.flush_loop()
    return slam, profiling.spans()


def test_chunked_vio_run_spans(vio_spans):
    """Each call is one `chunk` root with its own id; its upload, its T
    frame steps and its end are its children and carry its id; the chunk
    end holds exactly one fetch (one host read) and the loop node's spans;
    seq is None in a SlamSystem."""
    slam, spans = vio_spans
    _check_tree(spans)
    ids = _by_id(spans)
    roots = sorted((s for s in spans if s.name == "chunk"), key=lambda s: s.t0)
    assert [r.parent for r in roots] == [0] * (N // CHUNK)
    cids = [r.chunk for r in roots]
    assert len(set(cids)) == len(cids) and cids == sorted(cids)
    assert all(r.attrs == {"frames": CHUNK, "seqs": 1} for r in roots)
    kids = collections.defaultdict(list)
    for s in spans:
        if s.parent:
            kids[s.parent].append(s)
    for r in roots:
        assert [k.name for k in sorted(kids[r.id], key=lambda s: s.t0)] == \
            ["chunk.upload", "step.run", "chunk.end"]
        assert all(k.chunk == r.chunk for k in kids[r.id])
    runs = [s for s in spans if s.name == "step.run"]
    assert [s.attrs["replays"] for s in runs] == [CHUNK] * len(roots)
    assert sum(s.name == "step.eager" for s in spans) == N
    fetches = collections.Counter(s.chunk for s in spans if s.name == "chunk.fetch")
    assert fetches == collections.Counter(cids)
    for f in (s for s in spans if s.name == "chunk.fetch"):
        assert ids[f.parent].name == "chunk.end" and f.syncs == 1
    ends = [s for s in spans if s.name == "chunk.end"]
    loop = [s for s in spans if s.name.startswith("loop.") or s.name == "pgo"]
    assert {"loop.resolve", "loop.ingest", "loop.gate", "loop.verify", "loop.accept",
            "pgo", "vocab.train", "loop.flush"} <= {s.name for s in spans}
    assert all(s.seq is None for s in spans)
    for s in loop:
        if s.name in ("loop.resolve", "loop.ingest", "loop.gate"):
            assert ids[s.parent].name == "chunk.end"
    assert sum(s.attrs["keyframes"] for s in spans if s.name == "loop.ingest") == \
        slam.loop_closer.count
    assert sum(s.attrs.get("accepted", 0) for s in spans if s.name == "loop.accept") == \
        len(slam.loop_closer.closures) >= 1
    assert all(ids[e.parent].name == "chunk" for e in ends)


def test_depth_counts_on_the_fetch(scene):
    """Each chunk.fetch of process_frames carries `active` and `stereo_ok`:
    the sums over the chunk's frames of the slots active, and stereo
    accepted, in the tracker state each frame step left — recomputed here
    from those states."""
    frames = scene[0]
    profiling.reset()
    slam = SlamSystem(_cfg(), _cam(), device="cpu")
    per_frame = []
    real = slam._stereo_step

    def step(carry, x, draws):
        carry, ys = real(carry, x, draws)
        per_frame.append(depth_counts(carry[0]).tolist())
        return carry, ys

    slam._stereo_step = step
    for c0 in range(0, N, CHUNK):
        slam.process_frames(np.stack([f[0] for f in frames[c0:c0 + CHUNK]]),
                            np.stack([f[1] for f in frames[c0:c0 + CHUNK]]))
    fetches = sorted((s for s in profiling.spans() if s.name == "chunk.fetch"),
                     key=lambda s: s.t0)
    sums = np.asarray(per_frame).reshape(N // CHUNK, CHUNK, 2).sum(1)
    assert [(f.attrs["active"], f.attrs["stereo_ok"]) for f in fetches] == \
        [(int(a), int(b)) for a, b in sums]
    assert all(f.syncs == 1 for f in fetches)
    assert 0 < sums[:, 1].sum() <= sums[:, 0].sum()


def test_capture_span_attributes(monkeypatch):
    """The `capture` span names the step's kind (vo, vio) and the tracker's
    depth-prior route (fixed, image): the attributes SlamSystem and
    MultiSeqSlam hand their CapturedStep, which opens the span with them
    (on the card; tests/test_torch_profiling_cuda.py reads the span)."""
    seen = []

    class Recorder:
        def __init__(self, fn, carry, xs, *, name, branches=0, attrs=None):
            seen.append(attrs)

    monkeypatch.setattr(control, "CapturedStep", Recorder)
    wide = tcam.make(718.856, 718.856, SCFG.cx, SCFG.cy, 386.1448 / 718.856,
                     width=SCFG.width, height=SCFG.height, device="cpu")
    img = torch.zeros((2, SCFG.height, SCFG.width), dtype=torch.uint8)
    for cam, route in ((_cam(), "fixed"), (wide, "image")):
        slam = SlamSystem(_cfg(), cam, device="cpu", use_imu=True)
        slam._captured_step("stereo", (img, img))
        slam._captured_step("vio", (img, img) + tuple(torch.zeros((2, 16)) for _ in range(5)))
        ms = MultiSeqSlam(_cfg(), cam, num_seqs=2, device="cpu")
        ms._captured_step("stereo", (img[None].expand(2, -1, -1, -1),) * 2)
        assert seen[-3:] == [{"kind": "vo", "route": route}, {"kind": "vio", "route": route},
                             {"kind": "vo", "route": route}]


def test_pipelined_multiseq_spans(scene):
    """A pipelined MultiSeqSlam of 2: a chunk's end runs inside the next
    chunk's call (its parent) yet carries its own chunk's id; flush() ends
    the last chunk as a root; the loop node's spans carry their sequence;
    one chunk.fetch a chunk."""
    frames = scene[0]
    profiling.reset()
    ms = MultiSeqSlam(_cfg(pnp_fallback=False), _cam(), num_seqs=2, use_loop=True,
                      pipelined=True, device="cpu")
    outs = []
    for c0 in range(0, N, CHUNK):
        sl = frames[c0:c0 + CHUNK]
        i0 = np.stack([np.stack([f[0] for f in sl])] * 2)
        i1 = np.stack([np.stack([f[1] for f in sl])] * 2)
        outs.append(ms.process_chunk(i0, i1))
    outs.append(ms.flush())
    assert outs[0] is None and all(o.shape == (2, CHUNK, 12) for o in outs[1:])
    spans = profiling.spans()
    _check_tree(spans)
    ids = _by_id(spans)
    roots = sorted((s for s in spans if s.name == "chunk"), key=lambda s: s.t0)
    ends = sorted((s for s in spans if s.name == "chunk.end"), key=lambda s: s.t0)
    assert len(roots) == len(ends) == N // CHUNK
    assert [e.chunk for e in ends] == [r.chunk for r in roots]
    for e, nxt in zip(ends[:-1], roots[1:]):
        assert e.parent == nxt.id and e.chunk == nxt.chunk - 1
    assert ends[-1].parent == 0
    assert collections.Counter(s.chunk for s in spans if s.name == "chunk.fetch") == \
        collections.Counter(r.chunk for r in roots)
    for name in ("loop.resolve", "loop.ingest", "loop.gate"):
        got = [s for s in spans if s.name == name]
        assert {s.seq for s in got} == {0, 1}, name
        assert all(ids[s.parent].name == "chunk.end" for s in got)
    for s in spans:
        if s.name in ("pgo", "loop.verify", "loop.accept", "chunk.log"):
            assert s.seq in (0, 1), s.name
    assert {s.seq for s in spans if s.name == "pgo"} == {0, 1}
    uploads = sum(s.syncs for s in spans if s.name == "chunk.upload")
    assert uploads == 2 * len(roots)            # the two image stacks of each call


def _loop_closer(K: int, n_closures: int):
    """A CPU LoopCloser holding K keyframes of a drifting out-and-back
    (odometry poses), with n_closures loop closures between the legs."""
    cfg = tconfig.LoopConfig(**dict(LOOP, max_keyframes=max(64, K)))
    lc = loop_closing.LoopCloser(cfg, _cam(), device="cpu")
    rng = np.random.default_rng(5)
    x = np.concatenate([np.linspace(0, 1.2, K // 2), np.linspace(1.2, 0.01, K - K // 2)])
    G = np.stack([x, 0 * x, 0 * x], -1)
    odom = np.concatenate([np.zeros((1, 3)), np.cumsum(
        np.diff(G, axis=0) * 1.03 + rng.normal(0, 0.002, (K - 1, 3)), 0)])
    t = torch.tensor(odom, dtype=torch.float32)
    lc.kf_t_odom[:K] = t
    lc.kf_t[:K] = t
    lc.count = K
    for m in range(n_closures):
        j = K - 1 - m
        i = K - 1 - j
        T_ij = SE3(torch.tensor([1.0, 0.0, 0.0, 0.0]),
                   torch.tensor(G[j] - G[i] + rng.normal(0, 0.003, 3), dtype=torch.float32))
        lc.closures.append(loop_closing.LoopClosure(i, j, 50, T_ij))
    return lc


@pytest.mark.parametrize("pgo_device", [None, "cpu"])
@pytest.mark.parametrize("K,route", [(40, "dense"), (300, "banded")])
def test_pgo_span_attributes(monkeypatch, K, route, pgo_device):
    """optimize_graph is one `pgo` span: its route, padded nodes, window
    and loop edges; lm_iters and lm_rejects are the LM loop's solves and
    rejected steps; its syncs are the host waits made inside it — the five
    loop-edge uploads (a closure's T_ij is a host tensor: no read a loop
    edge), the held node's flag, the assembly plans' widths, λ's upload,
    the LM's reads and, on the dense route, linalg.solve's error flag a
    solve.  edge_launches, the pgo_edges kernel's launches inside the
    solve, is 0 on the CPU, with the graph on the loop node's device or
    moved to pgo_device="cpu".  The throttle's skip is a `pgo` span with
    route "throttled", no launch and no wait."""
    seen = {"solves": 0, "reads": 0, "rejects": 0}
    real_loop, real_read = pose_graph._lm_outer_loop, profiling.host_read

    def lm_loop(linearize, solve, total_cost, nodes0, lam0, iters):
        costs = []

        def counted_solve(*a):
            seen["solves"] += 1
            return solve(*a)

        def counted_cost(nodes):
            c = total_cost(nodes)
            costs.append(float(c))
            return c

        out = real_loop(linearize, counted_solve, counted_cost, nodes0, lam0, iters)
        best = costs[0]
        for c in costs[1:]:
            if c < best:
                best = c
            else:
                seen["rejects"] += 1
        return out

    def host_read(*tensors, site):
        if site == "pgo.lm":
            seen["reads"] += 1
        return real_read(*tensors, site=site)

    monkeypatch.setattr(pose_graph, "_lm_outer_loop", lm_loop)
    monkeypatch.setattr(profiling, "host_read", host_read)
    L = 6
    lc = _loop_closer(K, L)
    lc.pgo_device = None if pgo_device is None else torch.device(pgo_device)
    profiling.reset()
    lc.optimize_graph()
    lc.optimize_graph()                 # nothing new since: throttled
    solved, skipped = [s for s in profiling.spans() if s.name == "pgo"]
    wn = K
    n_pad = max(32, 1 << (wn - 1).bit_length())
    assert solved.attrs["route"] == route
    assert (solved.attrs["nodes"], solved.attrs["window"], solved.attrs["loop_edges"]) == \
        (n_pad, wn, L)
    assert solved.attrs["lm_iters"] == seen["solves"] >= 1
    assert solved.attrs["lm_rejects"] == seen["rejects"]
    plans, checks = (1, seen["solves"]) if route == "dense" else (2, 0)
    assert solved.syncs == 5 + 1 + plans + 1 + seen["reads"] + checks
    assert seen["reads"] >= seen["solves"]
    assert solved.attrs["edge_launches"] == 0
    assert skipped.attrs == {"route": "throttled", "edge_launches": 0} and skipped.syncs == 0


def test_ring_bound_keeps_aggregates():
    """The ring keeps its last `capacity` spans; the per-name aggregates
    count every span."""
    profiling.reset(capacity=8)
    try:
        for i in range(20):
            with profiling.span("tiny", i=i):
                with profiling.span("tiny.child"):
                    pass
        kept = profiling.spans()
        assert len(kept) == 8 and profiling.capacity() == 8
        assert [s.attrs["i"] for s in kept if s.name == "tiny"] == list(range(16, 20))
        tot = profiling.totals()
        assert tot["tiny"]["calls"] == tot["tiny.child"]["calls"] == 20
        assert tot["tiny"]["total_ns"] >= tot["tiny"]["self_ns"] + tot["tiny.child"]["total_ns"]
        assert "spans kept: 8 of 8" in profiling.report()
    finally:
        profiling.reset(capacity=profiling.RING)


def test_enable_false_records_nothing():
    profiling.reset()
    prev = profiling.enable(False)
    try:
        with profiling.span("off", a=1) as sp:
            sp.set(b=2)
            sp.add(c=3)
            v = profiling.host_read(torch.arange(3), site="off.read")
            with profiling.host_sync("off.wait"):
                pass
        assert list(v) == [0, 1, 2]
        assert profiling.spans() == [] and profiling.totals() == {} and profiling.sites() == {}
    finally:
        profiling.enable(prev)
    assert profiling.enabled()


def test_host_reads_count_on_the_innermost_span():
    """Each tensor read adds one sync to the innermost open span only; a
    host_sync block adds its count; the sites keep their own totals."""
    profiling.reset()
    with profiling.span("outer"):
        a, b = profiling.host_read(torch.zeros(2), torch.ones(3), site="t.two")
        with profiling.span("inner"):
            assert profiling.host_read(torch.zeros(()), site="t.one").shape == ()
            with profiling.host_sync("t.wait", 3):
                pass
    assert a.shape == (2,) and b.shape == (3,)
    got = {s.name: s.syncs for s in profiling.spans()}
    assert got == {"outer": 2, "inner": 4}
    assert {k: v[0] for k, v in profiling.sites().items()} == {"t.two": 2, "t.one": 1,
                                                                "t.wait": 3}


def test_spans_join_the_profilers_clock():
    """Under a CPU torch.profiler, a record_function opened inside a span
    lies inside the span's stamps mapped by to_profiler_ns, widened by
    250 us on each side."""
    from torch.profiler import ProfilerActivity, profile, record_function

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            profiling.new_chunk()
            with profiling.span("joined"):
                with record_function("probe"):
                    torch.ones(256, 256).sum()
    spans = sorted((s for s in profiling.spans() if s.name == "joined"), key=lambda s: s.t0)
    evs = sorted((e for e in prof.profiler.kineto_results.events() if e.name() == "probe"),
                 key=lambda e: e.start_ns())
    assert len(spans) == len(evs) == 3
    for s, e in zip(spans, evs):
        lo = profiling.to_profiler_ns(s.t0) - 250_000
        hi = profiling.to_profiler_ns(s.t1) + 250_000
        assert lo <= e.start_ns() <= e.end_ns() <= hi, (lo, e.start_ns(), e.end_ns(), hi)


def test_no_record_function_outside_device_trace(monkeypatch):
    """Outside device_trace() no span enters record_function, even under
    a profiler the program did not start."""
    from torch.profiler import ProfilerActivity, profile

    def refuse(*a, **kw):
        raise AssertionError("record_function entered outside device_trace")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("quiet"):
            with profiling.span("quiet.child"):
                torch.ones(4).sum()
    g = pose_graph.optimize(*_tiny_graph())
    assert g[0].node_q.shape == (32, 4)


def _tiny_graph():
    lc = _loop_closer(32, 2)
    i0 = 0
    loop_i = np.array([c.kf_i for c in lc.closures] + [0] * 6)
    loop_j = np.array([c.kf_j for c in lc.closures] + [0] * 6)
    q = np.tile(np.float32([1, 0, 0, 0]), (8, 1))
    t = np.zeros((8, 3), np.float32)
    for e, c in enumerate(lc.closures):
        t[e] = c.T_ij.t.numpy()
    valid = np.arange(8) < 2
    g = lc._build_graph(i0, 32, loop_i, loop_j, q, t, valid, 32, 3)
    fixed = torch.zeros(32, dtype=torch.bool)
    fixed[0] = True
    return g, fixed


def test_device_trace_mirrors_spans(tmp_path):
    """Inside device_trace() the spans enter the trace as flvis.<name>
    ranges, nested as they ran; the trace file is written."""
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.span("mirrored"):
            with profiling.span("mirrored.child"):
                torch.ones(64).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "flvis.mirrored" in names and "flvis.mirrored.child" in names
    assert (tmp_path / "trace.json").exists()
