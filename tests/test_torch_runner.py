"""The slice end to end: flvis_tpu_torch.pipeline.runner.SlamSystem
.process_frames (tracker + keyframe window BA + correction feedback)
against the JAX stepwise SlamSystem.process_frame loop, at the config of
tests/test_pipeline.py:20-23.  (tests/test_pipeline.py:190 holds that
stepwise JAX path equal to the fused chunk program.)

The port's tracker is handed the JAX draws of every frame (the runner's
track_frame is wrapped for this test only), so both systems make the same
discrete decisions and differ by float rounding alone.  Tolerances:
keyframe flags and statuses exactly; per-frame poses 2e-4 m / 2e-5 (the
frame tolerance of test_torch_tracker doubled: BA corrections feed back
into the tracker, so rounding compounds across keyframes); BA costs 1e-3
relative (a sum of Huber terms of small residuals after convergence, where
relative rounding is largest; measured ≤ 6e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.config import BackendConfig, FrontendConfig, SystemConfig
from flvis_tpu.frontend import tracker as jtr
from flvis_tpu.geometry import camera as jcam
from flvis_tpu.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory
from flvis_tpu.pipeline.runner import SlamSystem as JaxSlam
from flvis_tpu_torch.frontend import tracker as ttr
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.pipeline import runner as trunner

torch.set_num_threads(1)
N_FRAMES = 10


def _cfg(scfg):
    return SystemConfig(
        frontend=FrontendConfig(width=scfg.width, height=scfg.height, num_slots=128,
                                pyramid_levels=3, per_cell=8, min_distance=12.0, margin=22),
        backend=BackendConfig(window_size=5, max_landmarks=256, iters1=8, iters2=4))


def _jax_draws(cfg, frame_id, status):
    key = jax.random.fold_in(jax.random.PRNGKey(7), frame_id)
    h, n = cfg.ransac_hypotheses, cfg.num_slots
    lo, hi = cfg.dummy_depth_range
    if status == jtr.STATUS_TRACKING:
        k_r, k_d, k_p = jax.random.split(key, 3)
        arrs = (jax.random.uniform(k_r, (h, n)), jax.random.uniform(k_p, (h, n)),
                jax.random.uniform(k_d, (n,), jnp.float32, lo, hi))
    else:
        arrs = (jnp.zeros((h, n)), jnp.zeros((h, n)),
                jax.random.uniform(key, (n,), jnp.float32, lo, hi))
    return ttr.Draws(*(torch.as_tensor(np.array(a)) for a in arrs))


@pytest.fixture(scope="module")
def runs():
    scfg = SceneConfig()
    scene = PlanarScene(scfg, plane_depth=8.0, seed=4)
    poses = orbit_trajectory(N_FRAMES, step=0.03)
    frames = [scene.render(R, t)[:2] for (R, t) in poses]
    cfg = _cfg(scfg)
    cam_args = (scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline)

    jsys = JaxSlam(cfg, jcam.make(*cam_args, width=scfg.width, height=scfg.height))
    jouts = [jsys.process_frame(l, r) for (l, r) in frames]

    real = ttr.track_frame

    def with_jax_draws(fcfg, cam, state, img0, img1, **kw):
        kw.pop("generator")
        draws = _jax_draws(fcfg, int(state.frame_id), int(state.status))
        return real(fcfg, cam, state, img0, img1, draws=draws, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(trunner.tracker, "track_frame", with_jax_draws)
    try:
        tsys = trunner.SlamSystem(
            cfg, tcam.make(*cam_args, width=scfg.width, height=scfg.height, device="cpu"),
            device="cpu")
        touts = [tsys.process_frames(np.stack([f[0] for f in frames[i:i + 4]]),
                                     np.stack([f[1] for f in frames[i:i + 4]]))
                 for i in range(0, N_FRAMES, 4)]
    finally:
        mp.undo()
    return poses, jsys, jouts, tsys, touts


def test_statuses_and_keyframes_match(runs):
    _, jsys, jouts, tsys, touts = runs
    t_kf = np.concatenate([o.is_keyframe for o in touts])
    t_st = np.concatenate([o.status for o in touts])
    np.testing.assert_array_equal(t_kf, [bool(o.is_keyframe) for o in jouts])
    np.testing.assert_array_equal(t_st, [int(o.status) for o in jouts])
    assert len(tsys.keyframes) == len(jsys.keyframes) >= 3
    assert tsys.n_valid_corrections >= 1


def test_poses_match(runs):
    _, jsys, _, tsys, _ = runs
    jt = np.asarray([t for (_, _, _, t) in jsys.trajectory])
    jq = np.asarray([q for (_, _, q, _) in jsys.trajectory])
    tt = np.asarray([t for (_, _, _, t) in tsys.trajectory])
    tq = np.asarray([q for (_, _, q, _) in tsys.trajectory])
    np.testing.assert_allclose(tt, jt, atol=2e-4, rtol=0)
    np.testing.assert_allclose(tq, jq, atol=2e-5, rtol=0)


def test_ba_costs_match(runs):
    _, jsys, _, tsys, _ = runs
    jc = np.asarray([float(c) for c in jsys.ba_costs])
    tc = np.asarray(tsys.ba_costs)
    assert np.all(np.isfinite(tc))
    np.testing.assert_allclose(tc, jc, rtol=1e-3, atol=1e-6)


def test_ate_and_backend_state(runs):
    """Trajectory accuracy of tests/test_pipeline.py, and the BA window the
    two systems end with holds the same keyframes and landmark slots."""
    poses, jsys, _, tsys, _ = runs
    C_gt = np.asarray([-R.T @ t for (R, t) in poses])
    ate = np.sqrt(np.mean(np.sum((tsys.trajectory_cam_centers() - C_gt) ** 2, axis=-1)))
    assert ate < 0.02 * 0.03 * N_FRAMES + 0.01, ate
    np.testing.assert_allclose(tsys.trajectory_cam_centers(), jsys.trajectory_cam_centers(),
                               atol=2e-4, rtol=0)
    np.testing.assert_array_equal(tsys.ba_state.kf_frame_id.numpy(),
                                  np.asarray(jsys.ba_state.kf_frame_id))
    np.testing.assert_array_equal(tsys.ba_state.lm_id.numpy(), np.asarray(jsys.ba_state.lm_id))


def test_unported_options_raise():
    scfg = SceneConfig()
    cam = tcam.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline, device="cpu")
    for kw in ({"use_imu": True}, {"use_loop": True}, {"pipelined": True},
               {"output_sparse_map": True}, {"loop_device": "cpu"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            trunner.SlamSystem(_cfg(scfg), cam, device="cpu", **kw)
