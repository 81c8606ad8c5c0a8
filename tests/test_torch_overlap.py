"""flvis_tpu_torch.pipeline.overlap.OverlappedPipeline and
SlamSystem(loop_device=) on the CPU.

  - The pipeline (frontend and backend both on the CPU) against the port's
    stepwise SlamSystem.process_frame at atol 1e-6, with one host fetch a
    frame, and against the JAX package's OverlappedPipeline on two of the
    8 virtual devices, at the config of tests/test_pipeline.py:268-312 (an
    8-frame MultiPlaneScene orbit), the reference's draws handed to the port
    (the tolerances of tests/test_torch_runner.py: statuses and keyframes
    exactly, poses 2e-4 m, BA costs 1e-3 relative).
  - SlamSystem(loop_device="cpu") at the config of
    tests/test_pipeline.py:135-188 (a 16-frame out-and-back in chunks of 8):
    the loop node, its tables and its PGO on the loop device, and the same
    keyframes, closures and loop poses as the system without loop_device.
"""

import numpy as np
import pytest
import torch

import flvis_tpu_torch.config as tconfig
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.io.synthetic import (MultiPlaneScene, PlanarScene, SceneConfig,
                                          orbit_trajectory)
from flvis_tpu_torch.pipeline import runner as trunner
from flvis_tpu_torch.pipeline.overlap import OverlappedPipeline

torch.set_num_threads(1)


def _overlap_cfg(mod, scfg):
    """The config of tests/test_pipeline.py:285-290, from `mod`."""
    return mod.SystemConfig(
        frontend=mod.FrontendConfig(width=scfg.width, height=scfg.height, num_slots=128,
                                    pyramid_levels=3, per_cell=8, min_distance=12.0,
                                    margin=22),
        backend=mod.BackendConfig(window_size=5, max_landmarks=256, iters1=4, iters2=2))


def _overlap_frames(scfg):
    scene = MultiPlaneScene(scfg, seed=3)
    return [scene.render(R, t)[:2] for (R, t) in orbit_trajectory(8, step=0.03)]


@pytest.fixture(scope="module")
def overlap_runs():
    from flvis_tpu.geometry import camera as jcam
    from flvis_tpu.pipeline.overlap import OverlappedPipeline as JaxPipeline
    import flvis_tpu.config as jconfig
    from tests.test_torch_multiseq import _jax_draws

    scfg = SceneConfig()
    frames = _overlap_frames(scfg)
    cam = tcam.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline, width=scfg.width,
                    height=scfg.height, device="cpu")
    cfg = _overlap_cfg(tconfig, scfg)
    pipe, ref = OverlappedPipeline(cfg, cam, "cpu", "cpu"), trunner.SlamSystem(cfg, cam,
                                                                               device="cpu")
    outs = [(pipe.process_frame(a, b), ref.process_frame(a, b)) for a, b in frames]

    jpipe = JaxPipeline(_overlap_cfg(jconfig, scfg),
                        jcam.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline,
                                  width=scfg.width, height=scfg.height))
    jouts = [jpipe.process_frame(a, b) for a, b in frames]
    mp = pytest.MonkeyPatch()
    try:
        _jax_draws(mp)
        drawn = OverlappedPipeline(cfg, cam, "cpu", "cpu")
        douts = [drawn.process_frame(a, b) for a, b in frames]
    finally:
        mp.undo()
    return dict(frames=frames, pipe=pipe, ref=ref, outs=outs, jpipe=jpipe, jouts=jouts,
                drawn=drawn, douts=douts)


def test_pipeline_matches_stepwise_system(overlap_runs):
    r = overlap_runs
    pipe, ref = r["pipe"], r["ref"]
    t_pipe = np.asarray([t for (_, _, t) in pipe.trajectory])
    t_ref = np.asarray([t for (_, _, q, t) in ref.trajectory])
    np.testing.assert_allclose(t_pipe, t_ref, atol=1e-6, rtol=0)
    for o, o_ref in r["outs"]:
        assert o.status == int(o_ref.status)
        assert bool(o.is_keyframe) == bool(o_ref.is_keyframe)
    # One host fetch a frame; the CPU backend's step on its worker, its
    # Correction waited for by the next frame; no packet copy (both on the
    # CPU); the BA costs fetched off the frame loop.
    assert pipe.fetch_count == len(r["frames"])
    assert pipe.backend_waits == len(r["frames"]) - 1 and pipe.handoff_count == 0
    costs = pipe.ba_costs()
    assert len(costs) == len(ref.ba_costs) >= 2
    np.testing.assert_allclose(costs, ref.ba_costs, rtol=0, atol=1e-6)
    assert pipe.ba_state.kf_q.device == pipe.ba_dev
    assert pipe.fe_state.T_c_w.q.device == pipe.fe_dev


def test_pipeline_matches_jax_overlapped_pipeline(overlap_runs):
    r = overlap_runs
    jpipe, drawn = r["jpipe"], r["drawn"]
    for o, jo in zip(r["douts"], r["jouts"]):
        assert o.status == int(jo.status)
        assert bool(o.is_keyframe) == bool(jo.is_keyframe)
    t = np.asarray([t for (_, _, t) in drawn.trajectory])
    tj = np.asarray([np.asarray(t) for (_, _, t) in jpipe.trajectory])
    np.testing.assert_allclose(t, tj, atol=2e-4, rtol=0)
    assert jpipe.fetch_count == drawn.fetch_count == len(r["frames"])
    np.testing.assert_allclose(drawn.ba_costs(), jpipe.ba_costs(), rtol=1e-3, atol=1e-6)


def _loop_cfg(scfg):
    """The config of tests/test_pipeline.py:148-161."""
    return tconfig.SystemConfig(
        frontend=tconfig.FrontendConfig(width=scfg.width, height=scfg.height, num_slots=128,
                                        pyramid_levels=3, per_cell=8, min_distance=12.0,
                                        margin=22, kf_min_trans=0.04),
        backend=tconfig.BackendConfig(window_size=5, max_landmarks=256, iters1=8, iters2=4),
        loop=tconfig.LoopConfig(max_keyframes=64, num_orb_features=128, vocab_words=128,
                                kf_start=10, kf_dist=8, kf_max_dist=64, nkf_closest=2,
                                min_pts=12, min_score=0.03, ratio_ransac=0.3,
                                seq_edge_successors=3))


def test_loop_node_on_its_own_device():
    scfg = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                       baseline=0.12)
    scene = PlanarScene(scfg, plane_depth=8.0, seed=11)
    cam = tcam.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline, width=scfg.width,
                    height=scfg.height, device="cpu")
    n = 16
    xs = list(np.linspace(0, 0.6, n // 2)) + list(np.linspace(0.6, 0.02, n - n // 2))
    frames = [scene.render(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
    runs = {}
    for loop_device in (None, "cpu"):
        sys_ = trunner.SlamSystem(_loop_cfg(scfg), cam, device="cpu", use_loop=True,
                                  loop_device=loop_device)
        for c0 in range(0, n, 8):
            batch = frames[c0:c0 + 8]
            sys_.process_frames(np.stack([b[0] for b in batch]), np.stack([b[1] for b in batch]))
        sys_.flush_loop()
        runs[loop_device] = sys_
    one, two = runs[None], runs["cpu"]
    lc = two.loop_closer
    assert lc.device == torch.device("cpu") and lc.pgo_device == torch.device("cpu")
    assert lc.bow_db.device == lc.kf_q.device == lc.cam.fx.device == torch.device("cpu")
    assert lc.count == one.loop_closer.count >= 10
    np.testing.assert_array_equal(lc.kf_pc[:n].numpy(), one.loop_closer.kf_pc[:n].numpy())
    pairs = [(c.kf_i, c.kf_j, c.num_inliers) for c in lc.closures]
    assert pairs == [(c.kf_i, c.kf_j, c.num_inliers) for c in one.loop_closer.closures]
    np.testing.assert_array_equal(lc.kf_t[:lc.count].numpy(),
                                  one.loop_closer.kf_t[:lc.count].numpy())
