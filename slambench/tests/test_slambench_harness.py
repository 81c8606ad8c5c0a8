"""CPU tests of the benchmark's harness (slambench/), at a tiny cell that a
test run can hold; the cases marked `cuda` run on the card.

    python -m pytest slambench/tests -q

Every cell, configuration and metric of BENCHMARK.json loads by name; a
tiny cell, added from files in a temporary directory, runs end to end and
prints the contract's keys; the lower-precision control and four faults
planted in the timed path come out not correct; the reference's pose-graph
solve agrees with the program's; nothing loads JAX or the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for _p in (ROOT, HERE):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import reference  # noqa: E402
import run  # noqa: E402
from spec import Spec  # noqa: E402

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _tiny_config() -> dict:
    """euroc_mav at the CPU tests' VIO scene (tests/test_torch_runner.py's
    VIO_SCFG, VIO_LOOP): 256x192, a window of 5, a small loop node."""
    with open(HERE / "configs" / "euroc_mav.json") as f:
        c = json.load(f)
    c.update(image_width=256, image_height=192, num_slots=128, margin=22, feature_para1=8,
             feature_para3=12, lcKFStart=10, lcKFDist=8, lcKFMaxDist=64, minPts=12,
             minScore=0.03, ratioRansac=0.3, window_size=5)
    c["camera"] = {"fx": 200.0, "fy": 200.0, "cx": 128.0, "cy": 96.0, "baseline": 0.12,
                   "camera_hz": 20.0, "imu_hz": 200.0}
    c["overrides"] = {"backend": {"max_landmarks": 256, "iters1": 8, "iters2": 4},
                      "loop": {"max_keyframes": 64, "num_orb_features": 128,
                               "vocab_words": 128}}
    c["pgo"] = dict(c["pgo"], seq_edge_successors=3)
    return c


# Limits of the tiny cells, from their CPU readings on three seeds:
# frame_step_mm 4.1-6.1 (the fleet 10.7-26.4), pgo_gap_mm 0.006-0.11 against
# 1.59-1.95 for the bfloat16 reference and 99-284 with PGO left out.
TINY_LIMITS = {"missing": {"limit": 0}, "not_tracking": {"limit": 0},
               "frame_step_mm": {"limit": 40.0}, "pgo_gap_mm": {"limit": 0.6},
               "no_closure": {"limit": 0}}

TINY_TRAFFIC = {
    "tiny.replay": {"system": "single", "sequences": 1, "lap": {"frames": 24, "far_m": 0.9},
                    "chunk": 8, "warmup": [[24, 8]], "profile_replays": 4},
    "tiny.fleet": {"system": "multi", "sequences": 2, "offset_m": 0.03, "ba_every": 1,
                   "pipelined": True, "lap": {"frames": 24, "far_m": 0.9}, "chunk": 8,
                   "warmup": [[24, 8]], "profile_replays": 4},
}

NEW_METRIC = '''"""A metric a later change adds as a file of its own: frames a run judged."""


def read(rec):
    return float(rec.frames)
'''


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A benchmark root in a temporary directory: its own BENCHMARK.json,
    configuration, traffic, limits and one new metric reader; everything
    else comes from the harness's folder, unedited."""
    root = tmp_path_factory.mktemp("bench")
    sb = root / "slambench"
    for d in ("configs", "traffic", "limits", "metrics"):
        (sb / d).mkdir(parents=True)
    (sb / "configs" / "tiny.json").write_text(json.dumps(_tiny_config()))
    for name, tr in TINY_TRAFFIC.items():
        (sb / "traffic" / f"{name.split('.')[1]}.json").write_text(json.dumps(tr))
        limits = dict(TINY_LIMITS)
        if tr["system"] == "multi":
            # Batched runs have no PnP rescue (multiseq.py's note): at 256x192
            # frame 3 starves and keeps frame 2's pose, an 82 mm step.
            limits["frame_step_mm"] = {"limit": 120.0}
        (sb / "limits" / f"{name}.json").write_text(json.dumps(limits))
    (sb / "metrics" / "frames_judged.py").write_text(NEW_METRIC)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "source": "tests/test_torch_runner.py VIO_SCFG",
                         "file": "slambench/configs/tiny.json", "reduced": [], "why": "CPU"}]
    bench["workloads"] = [{"name": n, "config": "tiny", "traffic": n.split(".")[1],
                           "chips": 1, "why": "CPU"} for n in TINY_TRAFFIC]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    bench["end_to_end"].append({"name": "frames_judged", "unit": "frames", "better": "higher",
                                "bound": 0.01, "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, workload, seconds=1.5, traced=False):
    torch.set_num_threads(2)
    return run.run_cell(Spec(root), workload, 2**33 + 7, seconds, traced, "cpu", 0.0)


def test_every_cell_config_and_metric_loads_by_name():
    spec = Spec(ROOT)
    bench = spec.bench
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["limits"], f"{w['name']} has no limits"
        for traced in (False, True):
            for name, unit, read in spec.metrics(w["name"], traced):
                assert callable(read), name
        assert spec.metrics(w["name"], False), w["name"]
        assert spec.metrics(w["name"], True), w["name"]
    for c in bench["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert set(c["reduced"]) == set(cfg["reduced"]), c["name"]
        from driver import system_config

        sc = system_config(cfg)
        assert sc.frontend.width == cfg["image_width"]
        assert sc.loop.seq_edge_successors == cfg["pgo"]["seq_edge_successors"]
        assert sc.loop.pgo_max_loop_edges == cfg["pgo"]["max_loop_edges"]


def test_tiny_cell_runs_end_to_end_with_the_contract_keys(tiny_root, monkeypatch, capsys):
    """main() with the look for a chip skipped, on the CPU: the last line
    of standard output is the contract's object, `checks` last; the metric
    that the temporary root added is read with no file edited."""
    monkeypatch.chdir(tiny_root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real = run.run_cell
    monkeypatch.setattr(run, "run_cell", lambda *a: real(*a[:5], "cpu", a[6]))
    monkeypatch.setattr(run, "card", lambda: "cpu")
    assert run.main(["--workload", "tiny.replay", "--seed", str(2**32 + 3), "--seconds",
                     "1.5", "--trace", "0"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == RESULT_KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"frames_per_s", "setup_s", "frames_judged"}
    assert out["metrics"]["frames_judged"]["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_without_a_card_no_result(tiny_root, monkeypatch, capsys):
    monkeypatch.chdir(tiny_root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "tiny.replay", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("workload", ["tiny.replay", "tiny.fleet"])
def test_tiny_traced_cells(tiny_root, workload):
    out = _run(tiny_root, workload, traced=True)
    assert out["correct"] is True, out["checks"]
    assert {"loop_node_pct", "pgo_pct"} <= set(out["metrics"])


def test_lower_precision_control_is_not_correct(tiny_root):
    """The reference put in the program's place in bfloat16, and the
    program's outputs with PGO left out, fail the tiny cell's limits where
    the program's own pass them."""
    import control

    torch.set_num_threads(2)
    out, outputs, gt, cell = run.measure(Spec(tiny_root), "tiny.replay", 2**31 + 5, 1.5,
                                         False, "cpu", 0.0)
    got = {kind: (over, ok) for kind, _, _, over, ok in control.readings(outputs, gt, cell)}
    assert got["program"] == ([], True)
    assert got["bfloat16 reference"] == (["pgo_gap_mm"], False)
    assert got["PGO left out"] == (["pgo_gap_mm"], False)


def test_reference_pose_graph_agrees_with_the_program():
    """The reference's float64 solve and the program's dense and banded LM
    solvers land on the same poses of a drifting out-and-back graph with
    loop edges (the program's solvers stop early, within microns)."""
    from flvis_tpu_torch.geometry import se3 as se3m
    from flvis_tpu_torch.geometry.se3 import SE3
    from flvis_tpu_torch.loop import pose_graph

    rng = np.random.default_rng(3)
    K = 40
    x = np.concatenate([np.linspace(0, 1.2, K // 2), np.linspace(1.2, 0.01, K - K // 2)])
    G = np.stack([x, 0 * x, 0 * x], -1)
    odom_t = np.concatenate([np.zeros((1, 3)), np.cumsum(
        np.diff(G, axis=0) * 1.02 + rng.normal(0, 0.002, (K - 1, 3)), 0)])
    odom_q = reference.so3_exp(rng.normal(0, 0.002, (K, 3)))
    edges = [(K - 1 - j, j, 40 + j % 5, np.array([1.0, 0, 0, 0]),
              G[j] - G[K - 1 - j] + rng.normal(0, 0.003, 3)) for j in range(K // 2 + 3, K)]
    pgo = {"seq_edge_successors": 5, "max_loop_edges": 64, "loop_edge_weight": 5.0,
           "cauchy_c": 1.0}
    rq, rt, solved = reference.pgo_reference(odom_q, odom_t, edges, [], K, pgo)
    assert solved
    i0, j1 = edges[-1][0], edges[-1][1]
    wn, P = j1 - i0 + 1, 64
    a = torch.arange(P)
    rows = torch.clamp(i0 + a, max=K - 1)
    T = SE3(torch.tensor(odom_q, dtype=torch.float32)[rows],
            torch.tensor(odom_t, dtype=torch.float32)[rows])
    ei, ej, eq, et, ev, ew = [], [], [], [], [], []
    for s in range(1, 6):
        b = torch.clamp(a + s, max=P - 1)
        rel = se3m.compose(se3m.inverse(T), SE3(T.q[b], T.t[b]))
        for lst, v in zip((ei, ej, eq, et, ev, ew),
                          (a, b, rel.q, rel.t, a + s < wn, torch.full((P,), 1.0 / s))):
            lst.append(v)
    for lst, v in zip((ei, ej, eq, et, ev, ew),
                      (torch.tensor([e[0] - i0 for e in edges]),
                       torch.tensor([e[1] - i0 for e in edges]),
                       torch.tensor(np.array([e[3] for e in edges]), dtype=torch.float32),
                       torch.tensor(np.array([e[4] for e in edges]), dtype=torch.float32),
                       torch.ones(len(edges), dtype=torch.bool),
                       torch.full((len(edges),), 5.0))):
        lst.append(v)
    g = pose_graph.PoseGraph(node_q=T.q, node_t=T.t, node_valid=a < wn,
                             edge_i=torch.cat(ei), edge_j=torch.cat(ej), edge_q=torch.cat(eq),
                             edge_t=torch.cat(et), edge_valid=torch.cat(ev),
                             edge_weight=torch.cat(ew))
    fixed = a == 0
    moved = np.linalg.norm(odom_t[i0:j1 + 1] - rt[i0:j1 + 1], axis=-1).max()
    assert moved > 0.01
    for g2, _ in (pose_graph.optimize(g, fixed, iters=30),
                  pose_graph.optimize_banded(g, fixed, band_edges=5 * P, iters=20)):
        gap = np.linalg.norm(g2.node_t[:wn].double().numpy() - rt[i0:j1 + 1], axis=-1).max()
        assert gap < 1e-4, gap


def _fault_step_keeps_state(monkeypatch):
    """A frame step that returns its state unchanged."""
    from flvis_tpu_torch.pipeline import runner

    real = runner._fused_vio_frame_step

    def step(*a):
        carry = a[-3]
        _, ys = real(*a)
        return carry, ys

    monkeypatch.setattr(runner, "_fused_vio_frame_step", step)


def _fault_half_batch(monkeypatch):
    """Half of the sequences left out: their frames never reach the step."""
    from flvis_tpu_torch.parallel.multiseq_loop import MultiSeqSlam

    real = MultiSeqSlam._run_chunk

    def run_chunk(self, kind, seq_xs):
        S = seq_xs[0].shape[0]
        kept = tuple(torch.cat([x[: S // 2], torch.zeros_like(x[S // 2:])]) if i < 2 else x
                     for i, x in enumerate(seq_xs))
        return real(self, kind, kept)

    monkeypatch.setattr(MultiSeqSlam, "_run_chunk", run_chunk)


def _fault_altered_answer(monkeypatch):
    """One frame's pose altered where the step produces it."""
    from flvis_tpu_torch.pipeline import runner

    real = runner._frame_row
    calls = [0]

    def frame_row(ys, *a):
        row, pkt = real(ys, *a)
        calls[0] += 1
        if calls[0] == 30:              # a frame of the window (24 of warm-up)
            row = row.clone()
            row[9] += 0.05
        return row, pkt

    monkeypatch.setattr(runner, "_frame_row", frame_row)


def _fault_pgo_returns_at_once(monkeypatch):
    """A loop node whose PGO returns at once."""
    from flvis_tpu_torch.loop.loop_closing import LoopCloser

    monkeypatch.setattr(LoopCloser, "optimize_graph", lambda self: None)


def _fault_no_verification(monkeypatch):
    """A loop node that stops verifying once the window opens."""
    import driver

    real_mark = driver.mark_window

    def mark_window(sut):
        real_mark(sut)
        for lc in sut.closers():
            lc.dispatch_verify = lambda pending, rows_np=None: None

    monkeypatch.setattr(driver, "mark_window", mark_window)


@pytest.mark.parametrize("fault,workload", [(_fault_step_keeps_state, "tiny.replay"),
                                            (_fault_half_batch, "tiny.fleet"),
                                            (_fault_altered_answer, "tiny.replay"),
                                            (_fault_pgo_returns_at_once, "tiny.replay"),
                                            (_fault_no_verification, "tiny.fleet")])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault, workload):
    assert _run(tiny_root, workload)["correct"] is True
    fault(monkeypatch)
    out = _run(tiny_root, workload)
    assert out["correct"] is False, out["checks"]


def test_judge_compares_every_limit_and_fails_without_limits():
    nums = {"missing": 0, "not_tracking": 0, "frame_step_mm": 1.0}
    assert reference.judge(nums, {})[0] is False
    ok, checks = reference.judge(nums, {"frame_step_mm": {"limit": 2.0},
                                        "missing": {"limit": 0}})
    assert ok and list(checks) == ["missing", "frame_step_mm"]
    assert reference.judge(dict(nums, frame_step_mm=3.0), {"frame_step_mm": {"limit": 2.0}})[0] \
        is False
    assert reference.judge(nums, {"pgo_gap_mm": {"limit": 2.0}})[0] is False


def test_bfloat16_rounding():
    a = np.array([1.0, 2.5, 0.1, 2.003, -3.3])
    got = reference.round_to(a, "bfloat16")
    want = torch.tensor(a, dtype=torch.float32).to(torch.bfloat16).double().numpy()
    assert np.array_equal(got, want)


def test_nothing_loads_jax_or_the_jax_package(tiny_root):
    """A run's process holds no module whose top-level name is jax, jaxlib,
    flax or flvis_tpu, compared whole (flvis_tpu_torch is the program)."""
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(HERE)!r}]\n"
            "import torch, run, control\nfrom spec import Spec\n"
            f"run.run_cell(Spec({str(tiny_root)!r}), 'tiny.replay', 5, 1.0, True, 'cpu', 0.0)\n"
            "assert 'flvis_tpu_torch' in sys.modules\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    sys.modules.setdefault("flvis_tpu_fake_probe", sys)
    try:
        assert "flvis_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["flvis_tpu_fake_probe"]


@pytest.mark.cuda
def test_control_and_a_short_run_on_the_card():
    """On the card: a short euroc.replay run through the command is correct,
    and the control's run reads the bfloat16 reference and the PGO left
    out as not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload", "euroc.replay",
                          "--seed", "2147483659", "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    out = subprocess.run([sys.executable, "slambench/control.py", "--workload", "euroc.replay",
                          "--seeds", "2147483661", "--seconds", "5"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = {r["kind"]: r["correct"] for r in map(json.loads, out.stdout.strip().splitlines())}
    assert got == {"program": True, "bfloat16 reference": False, "PGO left out": False}
