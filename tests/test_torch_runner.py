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

import flvis_tpu.config as jconfig
import flvis_tpu_torch.config as tconfig
from flvis_tpu.frontend import tracker as jtr
from flvis_tpu.geometry import camera as jcam
from flvis_tpu.io.synthetic import (PlanarScene, SceneConfig, imu_from_trajectory,
                                    orbit_trajectory)
from flvis_tpu.pipeline.runner import SlamSystem as JaxSlam
from flvis_tpu_torch.frontend import tracker as ttr
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.pipeline import runner as trunner

torch.set_num_threads(1)
N_FRAMES = 10


def _cfg(scfg, mod=tconfig, kf_min_trans=0.05, loop=None):
    """The config of tests/test_pipeline.py:20-23, built from `mod` (the
    JAX package's config module or the port's copy)."""
    return mod.SystemConfig(
        frontend=mod.FrontendConfig(width=scfg.width, height=scfg.height, num_slots=128,
                                    pyramid_levels=3, per_cell=8, min_distance=12.0,
                                    margin=22, kf_min_trans=kf_min_trans),
        backend=mod.BackendConfig(window_size=5, max_landmarks=256, iters1=8, iters2=4),
        loop=mod.LoopConfig(**(loop or {})))


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

    jsys = JaxSlam(_cfg(scfg, jconfig),
                   jcam.make(*cam_args, width=scfg.width, height=scfg.height),
                   output_sparse_map=True)
    jouts = [jsys.process_frame(l, r) for (l, r) in frames]

    real = ttr.track_frame

    def with_jax_draws(fcfg, cam, state, img0, img1, **kw):
        kw.pop("generator", None)
        kw.pop("draws", None)      # replaced by the reference's draws
        draws = _jax_draws(fcfg, int(state.frame_id), int(state.status))
        return real(fcfg, cam, state, img0, img1, draws=draws, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(trunner.tracker, "track_frame", with_jax_draws)
    try:
        tsys = trunner.SlamSystem(
            cfg, tcam.make(*cam_args, width=scfg.width, height=scfg.height, device="cpu"),
            device="cpu", output_sparse_map=True)
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
    """loop_device, the last option that raised, is ported (the name is kept
    from then): the whole loop node — its tables, camera and PGO — is placed
    on the loop device, and a chunk's keyframes reach it there (closures:
    tests/test_torch_overlap.py)."""
    scfg = SceneConfig()
    cam = tcam.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline, width=scfg.width,
                    height=scfg.height, device="cpu")
    sys_ = trunner.SlamSystem(_cfg(scfg, kf_min_trans=0.02), cam, device="cpu", use_loop=True,
                              loop_device="cpu")
    lc = sys_.loop_closer
    cpu = torch.device("cpu")
    assert sys_.loop_device == lc.device == lc.pgo_device == cpu
    assert lc.bow_db.device == lc.kf_desc.device == lc.kf_q.device == lc.cam.fx.device == cpu
    scene = PlanarScene(scfg, plane_depth=8.0, seed=0)
    frames = [scene.render(R, t)[:2] for (R, t) in orbit_trajectory(8, step=0.03)]
    sys_.process_frames(np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]))
    sys_.flush_loop()
    assert lc.count == len(sys_.keyframes) >= 2


def _assert_same_cloud(tsys, jsys):
    """The two systems' sparse maps: the same landmark count and voxel
    count, voxels within 1e-3 m in the same order (landmark positions after
    BA, float rounding compounded across keyframes)."""
    ct, cj = tsys.sparse_map.cloud(), jsys.sparse_map.cloud()
    assert len(tsys.sparse_map) == len(jsys.sparse_map) > 0
    assert len(ct) == len(cj) > 10
    np.testing.assert_allclose(ct, cj, atol=1e-3, rtol=0)


def test_sparse_map_matches(runs):
    """SlamSystem(output_sparse_map=True) through process_frames (chunks of
    4: the corrections' landmarks come with the chunk's one fetch) against
    the JAX stepwise system's SparseMapRecorder."""
    _, jsys, _, tsys, _ = runs
    _assert_same_cloud(tsys, jsys)


# --- stereo + IMU (+ loop): the out-and-back pan of tests/test_pipeline.py:383-415
VIO_SCFG = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                       baseline=0.12)
VIO_LOOP = dict(max_keyframes=64, num_orb_features=128, vocab_words=128, kf_start=10,
                kf_dist=8, kf_max_dist=64, nkf_closest=2, min_pts=12, min_score=0.03,
                ratio_ransac=0.3, seq_edge_successors=3)
N_VIO = 24


@pytest.fixture(scope="module")
def vio_scene():
    scene = PlanarScene(VIO_SCFG, plane_depth=8.0, seed=11)
    half = N_VIO // 2
    xs = list(np.linspace(0, 0.9, half)) + list(np.linspace(0.9, 0.02, N_VIO - half))
    poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
    frames = [scene.render(R, t)[:2] for (R, t) in poses]
    t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
    accs, gyros, imuts = [], [], []
    prev = -np.inf
    for ft in frame_t:
        m = (t_imu > prev) & (t_imu <= ft)
        accs.append(acc[m]); gyros.append(gyro[m]); imuts.append(t_imu[m])
        prev = ft
    return poses, frames, frame_t, accs, gyros, imuts


def _vio_systems(**kw):
    cam_args = (VIO_SCFG.fx, VIO_SCFG.fy, VIO_SCFG.cx, VIO_SCFG.cy, VIO_SCFG.baseline)
    size = dict(width=VIO_SCFG.width, height=VIO_SCFG.height)
    jsys = JaxSlam(_cfg(VIO_SCFG, jconfig, 0.04), jcam.make(*cam_args, **size), **kw)
    tsys = trunner.SlamSystem(_cfg(VIO_SCFG, tconfig, 0.04),
                              tcam.make(*cam_args, **size, device="cpu"), device="cpu", **kw)
    return jsys, tsys


def _with_jax_draws():
    real = ttr.track_frame

    def with_jax_draws(fcfg, cam, state, img0, img1, **kw):
        kw.pop("generator", None)
        kw.pop("draws", None)      # replaced by the reference's draws
        draws = _jax_draws(fcfg, int(state.frame_id), int(state.status))
        return real(fcfg, cam, state, img0, img1, draws=draws, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(trunner.tracker, "track_frame", with_jax_draws)
    return mp


def _assert_same_run(jsys, tsys):
    for i in (1, 2):        # translation (2e-4 m), quaternion (2e-5)
        jt = np.asarray([e[-i] for e in jsys.trajectory])
        tt = np.asarray([e[-i] for e in tsys.trajectory])
        np.testing.assert_allclose(tt, jt, atol=2e-4 if i == 1 else 2e-5, rtol=0)
    assert len(tsys.keyframes) == len(jsys.keyframes) >= 2
    # The IMU ring follows the poses (2e-4); the accelerometer bias is an IIR
    # of Δp/dt² innovations (dt = 0.05 s, gain 0.01), which scales pose
    # rounding by ~4 per frame before the IIR: 2e-3.
    for f, tol in (("bias_acc", 2e-3), ("bias_gyro", 2e-4), ("pos", 2e-4), ("vel", 2e-3),
                   ("q", 2e-4)):
        np.testing.assert_allclose(getattr(tsys.vio_state, f).numpy(),
                                   np.asarray(getattr(jsys.vio_state, f)), atol=tol,
                                   rtol=0, err_msg=f)
    assert bool(tsys.vio_state.initialized)


def test_stepwise_imu_matches(vio_scene):
    """feed_imu + process_frame(t_img) with use_imu=True, 10 frames."""
    _, frames, frame_t, accs, gyros, imuts = vio_scene
    jsys, tsys = _vio_systems(use_imu=True)
    mp = _with_jax_draws()
    try:
        for k in range(10):
            for s in (jsys, tsys):
                if len(imuts[k]):
                    s.feed_imu(accs[k], gyros[k], imuts[k])
                s.process_frame(frames[k][0], frames[k][1], t_img=float(frame_t[k]))
    finally:
        mp.undo()
    _assert_same_run(jsys, tsys)


def test_stepwise_sparse_map_matches(vio_scene):
    """output_sparse_map through the stepwise process_frame, 12 frames."""
    _, frames, _, _, _, _ = vio_scene
    jsys, tsys = _vio_systems(output_sparse_map=True)
    mp = _with_jax_draws()
    try:
        for k in range(12):
            for s in (jsys, tsys):
                s.process_frame(frames[k][0], frames[k][1])
    finally:
        mp.undo()
    assert tsys.n_valid_corrections >= 1
    _assert_same_cloud(tsys, jsys)


def test_process_frames_vio_matches(vio_scene):
    """process_frames_vio (the reference's fused VIO chunk step), 2 chunks of 5."""
    _, frames, frame_t, accs, gyros, imuts = vio_scene
    jsys, tsys = _vio_systems(use_imu=True)
    mp = _with_jax_draws()
    try:
        for c0 in (0, 5):
            sl = slice(c0, c0 + 5)
            for s in (jsys, tsys):
                s.process_frames_vio(np.stack([f[0] for f in frames[sl]]),
                                     np.stack([f[1] for f in frames[sl]]),
                                     ts=frame_t[sl], imu_acc=accs[sl], imu_gyro=gyros[sl],
                                     imu_t=imuts[sl])
    finally:
        mp.undo()
    _assert_same_run(jsys, tsys)


def test_vio_loop_headline(vio_scene):
    """The reference's headline composition, tests/test_pipeline.py:370-436:
    stereo + IMU + loop closing through process_frames_vio in chunks of 8
    (the port's own draws): the revisit closes a loop and the trajectory
    holds the reference test's ATE bound.  (The loop-corrected trajectory is
    only checked finite: at this 256×192 scene the sweep's depth is too
    coarse for an accurate loop edge, and the reference's own
    loop-corrected ATE here is 0.31 m.)"""
    poses, frames, frame_t, accs, gyros, imuts = vio_scene
    cam_args = (VIO_SCFG.fx, VIO_SCFG.fy, VIO_SCFG.cx, VIO_SCFG.cy, VIO_SCFG.baseline)
    sys_ = trunner.SlamSystem(
        _cfg(VIO_SCFG, tconfig, 0.04, VIO_LOOP),
        tcam.make(*cam_args, width=VIO_SCFG.width, height=VIO_SCFG.height, device="cpu"),
        device="cpu", use_imu=True, use_loop=True)
    for c0 in range(0, N_VIO, 8):
        sl = slice(c0, c0 + 8)
        sys_.process_frames_vio(np.stack([f[0] for f in frames[sl]]),
                                np.stack([f[1] for f in frames[sl]]), ts=frame_t[sl],
                                imu_acc=accs[sl], imu_gyro=gyros[sl], imu_t=imuts[sl])
        assert sys_.loop_closer.count == len(sys_.keyframes)
    sys_.flush_loop()
    closures = sys_.loop_closer.closures
    assert len(closures) >= 1, "revisit not detected in VIO+loop mode"
    assert closures[0].kf_j - closures[0].kf_i >= 8
    C_gt = np.asarray([-R.T @ t for (R, t) in poses])
    C = sys_.trajectory_cam_centers()
    ate = np.sqrt(np.mean(np.sum((C - C_gt) ** 2, axis=-1)))
    assert ate < 0.02 * 2 * 0.9 + 0.01, f"ATE {ate:.4f} m"
    C = sys_.trajectory_cam_centers(loop_corrected=True)
    assert C.shape == C_gt.shape and np.isfinite(C).all()
