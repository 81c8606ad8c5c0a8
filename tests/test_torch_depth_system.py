"""SlamSystem in RGB-D mode (cfg.frontend.depth_mode: the second image is an
aligned Z16 depth image, baseline 0, depth_factor 1000) — the port's
process_frames against the JAX stepwise SlamSystem.process_frame loop, at
the small configuration of tests/test_torch_runner.py, on the reference's
draws; and the loop node's depth-mode keyframe ingest
(LoopCloser(depth_mode=True)) against the JAX `_ingest`.

Tolerances: statuses and keyframes exactly; poses 2e-4 m / 2e-5; BA costs
1e-3 relative (those of tests/test_torch_runner.py); the ingest's
keypoints equal and their camera-frame points within 1e-3 (the depth is a
bilinear sample of the same image; float32 rounding of the sample and the
back-projection)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flvis_tpu.config as jconfig
import flvis_tpu_torch.config as tconfig
from flvis_tpu.geometry import camera as jcam
from flvis_tpu.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory
from flvis_tpu.loop import loop_closing as jlc
from flvis_tpu.pipeline.runner import SlamSystem as JaxSlam
from flvis_tpu_torch.geometry import camera as tcam, se3 as tse3
from flvis_tpu_torch.loop import loop_closing as tlc
from flvis_tpu_torch.pipeline import runner as trunner
from test_torch_runner import _cfg, _with_jax_draws

torch.set_num_threads(1)
N_FRAMES = 10


def _depth_cfg(scfg, mod):
    cfg = _cfg(scfg, mod)
    return cfg.replace(frontend=dataclasses.replace(cfg.frontend, depth_mode=True))


def _cameras(scfg):
    args = (scfg.fx, scfg.fy, scfg.cx, scfg.cy, 0.0)
    kw = dict(depth_factor=1000.0, width=scfg.width, height=scfg.height)
    return jcam.make(*args, **kw), tcam.make(*args, **kw, device="cpu")


def _rgbd_frames(scene, poses):
    out = []
    for (R, t) in poses:
        img, _, depth = scene.render(R, t)
        out.append((img, (depth * 1000.0).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def runs():
    scfg = SceneConfig()
    scene = PlanarScene(scfg, plane_depth=8.0, seed=4)
    poses = orbit_trajectory(N_FRAMES, step=0.03)
    frames = _rgbd_frames(scene, poses)
    jc, tc = _cameras(scfg)
    jsys = JaxSlam(_depth_cfg(scfg, jconfig), jc)
    jouts = [jsys.process_frame(img, d) for (img, d) in frames]
    mp = _with_jax_draws()
    try:
        tsys = trunner.SlamSystem(_depth_cfg(scfg, tconfig), tc, device="cpu")
        touts = [tsys.process_frames(np.stack([f[0] for f in frames[i:i + 4]]),
                                     np.stack([f[1] for f in frames[i:i + 4]]))
                 for i in range(0, N_FRAMES, 4)]
    finally:
        mp.undo()
    return poses, jsys, jouts, tsys, touts


def test_depth_statuses_and_keyframes_match(runs):
    _, jsys, jouts, tsys, touts = runs
    np.testing.assert_array_equal(np.concatenate([o.is_keyframe for o in touts]),
                                  [bool(o.is_keyframe) for o in jouts])
    np.testing.assert_array_equal(np.concatenate([o.status for o in touts]),
                                  [int(o.status) for o in jouts])
    assert len(tsys.keyframes) == len(jsys.keyframes) >= 3
    assert tsys.n_valid_corrections >= 1


def test_depth_poses_and_costs_match(runs):
    poses, jsys, _, tsys, _ = runs
    for i, tol in ((1, 2e-4), (2, 2e-5)):          # t, then q
        jt = np.asarray([e[-i] for e in jsys.trajectory])
        tt = np.asarray([e[-i] for e in tsys.trajectory])
        np.testing.assert_allclose(tt, jt, atol=tol, rtol=0)
    np.testing.assert_allclose(np.asarray(tsys.ba_costs),
                               np.asarray([float(c) for c in jsys.ba_costs]),
                               rtol=1e-3, atol=1e-6)
    C_gt = np.asarray([-R.T @ t for (R, t) in poses])
    ate = np.sqrt(np.mean(np.sum((tsys.trajectory_cam_centers() - C_gt) ** 2, axis=-1)))
    assert ate < 0.02 * 0.03 * N_FRAMES + 0.01, ate


def test_depth_system_passes_depth_mode_to_loop_node():
    scfg = SceneConfig()
    _, tc = _cameras(scfg)
    tsys = trunner.SlamSystem(_depth_cfg(scfg, tconfig), tc, device="cpu", use_loop=True)
    assert tsys.loop_closer.depth_mode
    stereo = trunner.SlamSystem(_cfg(scfg, tconfig), tc, device="cpu", use_loop=True)
    assert not stereo.loop_closer.depth_mode


def test_depth_ingest_matches(monkeypatch):
    """One keyframe through the JAX `_ingest` (depth mode) and the port's
    LoopCloser(depth_mode=True).add_keyframe: the same keypoints and
    descriptors, p_c within 1e-3, the same depth-valid flags; the sweep
    kernel's plain version is never called."""
    scfg = SceneConfig()
    scene = PlanarScene(scfg, plane_depth=6.0, seed=9)
    (img, d_img), = _rgbd_frames(scene, orbit_trajectory(1, step=0.03))
    jc, tc = _cameras(scfg)
    F = 200
    uv, desc, kpv, p_c, pcv = (np.asarray(a) for a in jlc._ingest(
        jnp.asarray(img), jnp.asarray(d_img), jc, F, True))
    lc = tlc.LoopCloser(tconfig.LoopConfig(max_keyframes=8, num_orb_features=F), tc,
                        device="cpu", depth_mode=True)
    monkeypatch.setattr(tlc.stereo, "disparity_sweep", None)   # depth mode never sweeps
    k = lc.add_keyframe(img, d_img, tse3.identity(device="cpu"), frame_id=0)
    np.testing.assert_array_equal(lc.kf_kp_valid[k].numpy(), kpv)
    np.testing.assert_allclose(lc.kf_uv[k].numpy(), uv, atol=1e-4)
    assert np.mean(lc.kf_desc[k].numpy().view(np.uint32) == desc.view(np.uint32)) > 0.99
    np.testing.assert_array_equal(lc.kf_pc_valid[k].numpy(), pcv)
    assert pcv.sum() > 50
    np.testing.assert_allclose(lc.kf_pc[k].numpy()[pcv], p_c[pcv], atol=1e-3)
    np.testing.assert_allclose(lc.kf_pc[k].numpy()[pcv][:, 2], 6.0, atol=1e-2)
