"""The slice's frontend: flvis_tpu_torch.frontend.tracker against
flvis_tpu.frontend.tracker.

One-frame parity from identical state: at each frame of a JAX run, the
JAX state goes to the port through `interop`, together with JAX's own
random draws for that frame (the fold of the frame id into PRNGKey(7) and
its ransac/depth/pnp split, tracker.py:331,516), and both packages track
the same images.  Tolerances (float32 in both; every discrete decision —
LK status, RANSAC inliers, MAD gate, LM accepts — comes out the same, so
the poses differ only by rounding accumulated through LK and two LM
passes): translation 1e-4 m, quaternion 1e-5; status and keyframe flag
exactly; the inlier count and the per-slot flags of the carried table to
within one borderline slot (a gate can flip on a last-ulp difference on
another CPU's vector units; none flips on the machines this was written
on).

Free run: the port alone over the `vo_run` scene of tests/test_tracker.py,
drawing from its torch.Generator, must keep TRACKING with the ATE bound of
tests/test_tracker.py:97."""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flvis_tpu_torch.config as tconfig
from flvis_tpu.config import FrontendConfig
from flvis_tpu.frontend import tracker as jtr
from flvis_tpu.geometry import camera as jcam
from flvis_tpu.geometry import se3 as jse3
from flvis_tpu.geometry import so3 as jso3
from flvis_tpu.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory
from flvis_tpu_torch import interop
from flvis_tpu_torch.backend import window_ba as twba
from flvis_tpu_torch.frontend import tracker as ttr
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.geometry import se3 as tse3
from flvis_tpu_torch.geometry import so3 as tso3

torch.set_num_threads(1)
DEV = torch.device("cpu")
TO_T = interop.to_torch(DEV)
T_TOL, Q_TOL = 1e-4, 1e-5
N_FRAMES = 8


def small_cfg(**kw):
    """The config of tests/test_tracker.py:48-54."""
    base = dict(width=512, height=384, num_slots=128, pyramid_levels=3, per_cell=8,
                min_distance=12.0, margin=22, lk_radius=10, lk_iters=12)
    base.update(kw)
    return FrontendConfig(**base)


def _port(cfg):
    """The port's FrontendConfig with the same fields as the reference's."""
    return tconfig.FrontendConfig(**{f.name: getattr(cfg, f.name)
                                     for f in dataclasses.fields(cfg)})


def jax_draws(cfg, frame_id, status):
    """The JAX tracker's draws for a frame, as a port Draws record."""
    key = jax.random.fold_in(jax.random.PRNGKey(7), frame_id)
    h, n = cfg.ransac_hypotheses, cfg.num_slots
    lo, hi = cfg.dummy_depth_range
    if int(status) == jtr.STATUS_TRACKING:
        k_r, k_d, k_p = jax.random.split(key, 3)
        ransac, pnp = jax.random.uniform(k_r, (h, n)), jax.random.uniform(k_p, (h, n))
        depth = jax.random.uniform(k_d, (n,), jnp.float32, lo, hi)
    else:   # the init branch hands the unsplit key to the depth step
        ransac = pnp = jnp.zeros((h, n))
        depth = jax.random.uniform(key, (n,), jnp.float32, lo, hi)
    return ttr.Draws(*(torch.as_tensor(np.array(a)) for a in (ransac, pnp, depth)))


def cameras(scfg, baseline=None, **kw):
    b = scfg.baseline if baseline is None else baseline
    args = (scfg.fx, scfg.fy, scfg.cx, scfg.cy, b)
    return (jcam.make(*args, width=scfg.width, height=scfg.height, **kw),
            tcam.make(*args, width=scfg.width, height=scfg.height, device=DEV, **kw))


def port_state(jstate, cfg):
    return interop.from_numpy(interop.to_numpy(jstate), ttr.init_state(_port(cfg), device=DEV),
                              TO_T)


def assert_frame_parity(jout, tout):
    np.testing.assert_allclose(tout.T_c_w.t.numpy(), np.asarray(jout.T_c_w.t), atol=T_TOL,
                               rtol=0)
    np.testing.assert_allclose(tout.T_c_w.q.numpy(), np.asarray(jout.T_c_w.q), atol=Q_TOL,
                               rtol=0)
    assert int(tout.status) == int(jout.status)
    assert bool(tout.is_keyframe) == bool(jout.is_keyframe)
    assert bool(tout.reset_backend) == bool(jout.reset_backend)
    assert abs(int(tout.num_inliers) - int(jout.num_inliers)) <= 1


@pytest.fixture(scope="module")
def jax_run():
    """JAX tracker over the vo_run scene; keeps each frame's input state."""
    scfg = SceneConfig()
    scene = PlanarScene(scfg, plane_depth=8.0, seed=1)
    cfg = small_cfg()
    jc, tc = cameras(scfg)
    state = jtr.init_state(cfg)
    frames = []
    for (R, t) in orbit_trajectory(N_FRAMES, step=0.03):
        l, r, _ = scene.render(R, t)
        before = state
        state, out = jtr.track_frame(cfg, jc, state, jnp.asarray(l), jnp.asarray(r))
        frames.append((before, l, r, out, state))
    return cfg, tc, frames


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_one_frame_parity_from_jax_state(jax_run, frame):
    cfg, tc, frames = jax_run
    before, l, r, jout, jafter = frames[frame]
    draws = jax_draws(cfg, int(before.frame_id), int(before.status))
    tafter, tout = ttr.track_frame(_port(cfg), tc, port_state(before, cfg), torch.as_tensor(l),
                                   torch.as_tensor(r), draws=draws)
    assert_frame_parity(jout, tout)
    # The carried state agrees too: same live slots, ids and depth flags.
    jt, tt = interop.to_numpy(jafter.table), interop.to_numpy(tafter.table)
    for k in ("active", "has_3d", "inlier", "lm_id", "ur_ok", "age", "pend_ok"):
        assert int((tt[k] != jt[k]).sum()) <= 1, k
    live = jt["active"] & tt["active"]
    # uv and map points: 1e-3 px / 1e-3 m after LK and the IIR depth blend.
    np.testing.assert_allclose(tt["uv"][live], jt["uv"][live], atol=1e-3, rtol=0)
    np.testing.assert_allclose(tt["p_w"][live], jt["p_w"][live], atol=1e-3, rtol=0)
    assert int(tafter.frame_id) == int(jafter.frame_id)
    np.testing.assert_array_equal(tafter.ring_fid.numpy(), np.asarray(jafter.ring_fid))


def test_pnp_rescue_parity(jax_run):
    """A catastrophically wrong prior (25° yaw + 3 m) starves the motion BA
    in both packages; both run the PnP RANSAC rescue on the same draws and
    recover the same pose (the scenario of tests/test_tracker.py:179)."""
    cfg, tc, frames = jax_run
    _, _, _, _, state = frames[3]
    scfg = SceneConfig()
    scene = PlanarScene(scfg, plane_depth=8.0, seed=1)
    jc, _ = cameras(scfg)
    R4, t4 = orbit_trajectory(5, step=0.03)[4]
    T_true = jse3.SE3(jso3.from_matrix(jnp.asarray(R4, jnp.float32)),
                      jnp.asarray(t4, jnp.float32))
    il, ir, _ = scene.render(R4, t4)
    T_bad = jse3.compose(jse3.SE3(jso3.exp(jnp.asarray([0.0, np.deg2rad(25.0), 0.0])),
                                  jnp.asarray([3.0, 0.0, 0.0], jnp.float32)), T_true)
    _, jout = jtr.track_frame(cfg, jc, state, jnp.asarray(il), jnp.asarray(ir),
                              prior_T=T_bad, use_prior=True)
    tbad = tse3.SE3(torch.as_tensor(np.array(T_bad.q)), torch.as_tensor(np.array(T_bad.t)))
    _, tout = ttr.track_frame(_port(cfg), tc, port_state(state, cfg), torch.as_tensor(il),
                              torch.as_tensor(ir), prior_T=tbad, use_prior=True,
                              draws=jax_draws(cfg, int(state.frame_id), int(state.status)))
    assert int(jout.status) == jtr.STATUS_TRACKING and int(jout.num_inliers) >= 15
    assert_frame_parity(jout, tout)


def test_depth_mode_parity():
    """RGB-D mode (img1 is a Z16 depth image, baseline 0): three frames of
    one-frame parity (the scene of tests/test_tracker.py:225)."""
    scfg = SceneConfig()
    scene = PlanarScene(scfg, plane_depth=8.0, seed=5)
    cfg = small_cfg(depth_mode=True)
    jc, tc = cameras(scfg, baseline=0.0, depth_factor=1000.0)
    state = jtr.init_state(cfg)
    for (R, t) in orbit_trajectory(3, step=0.03):
        l, _, depth = scene.render(R, t)
        d_img = (depth * 1000.0).astype(np.float32)
        draws = jax_draws(cfg, int(state.frame_id), int(state.status))
        _, tout = ttr.track_frame(_port(cfg), tc, port_state(state, cfg), torch.as_tensor(l),
                                  torch.as_tensor(d_img), draws=draws)
        state, jout = jtr.track_frame(cfg, jc, state, jnp.asarray(l), jnp.asarray(d_img))
        assert_frame_parity(jout, tout)


def test_free_run_vo_scene():
    """The port alone, its own torch.Generator draws, over the vo_run scene."""
    scfg = SceneConfig()
    scene = PlanarScene(scfg, plane_depth=8.0, seed=1)
    cfg = small_cfg()
    _, tc = cameras(scfg)
    poses = orbit_trajectory(N_FRAMES, step=0.03)
    state = ttr.init_state(_port(cfg), device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    errs, kfs = [], 0
    for (R, t) in poses:
        l, r, _ = scene.render(R, t)
        state, out = ttr.track_frame(_port(cfg), tc, state, torch.as_tensor(l), torch.as_tensor(r),
                                     generator=gen)
        assert int(out.status) == ttr.STATUS_TRACKING
        assert int(out.num_inliers) > 30
        kfs += int(out.is_keyframe)
        R_e = tso3.to_matrix(out.T_c_w.q).numpy()
        errs.append(np.linalg.norm(-R.T @ t - (-R_e.T @ out.T_c_w.t.numpy())))
    ate = np.sqrt(np.mean(np.square(errs)))
    assert ate < 0.02 * 0.03 * N_FRAMES + 0.01, ate
    assert kfs >= N_FRAMES // 5 and int(state.kf_count) == kfs


def test_frames_scan_and_feedback_helpers():
    """track_frames_scan stacks per-frame outputs; a null Correction is a
    no-op; rebase_pose rebases the pose chain as the reference does."""
    scfg = SceneConfig()
    scene = PlanarScene(scfg, plane_depth=8.0, seed=1)
    cfg = small_cfg()
    _, tc = cameras(scfg)
    imgs = [scene.render(R, t)[:2] for (R, t) in orbit_trajectory(3, step=0.03)]
    i0 = torch.as_tensor(np.stack([a for a, _ in imgs]))
    i1 = torch.as_tensor(np.stack([b for _, b in imgs]))
    gen = torch.Generator(device=DEV).manual_seed(0)
    pcfg = _port(cfg)
    st, outs, pkts = ttr.track_frames_scan(pcfg, tc, ttr.init_state(pcfg, device=DEV), i0, i1,
                                           gen, with_packets=True)
    assert outs.status.shape == (3,) and bool((outs.status == 1).all())
    assert pkts.lm_id.shape == (3, cfg.num_slots)

    # A null (valid=False) Correction changes nothing: every effect of
    # apply_correction is gated on corr.valid on the device.
    null = twba.null_correction(tconfig.BackendConfig(max_landmarks=64), device=DEV)
    same = ttr.apply_correction(st, null)
    for a, b in zip(jax.tree.leaves(interop.to_numpy(same)), jax.tree.leaves(interop.to_numpy(st))):
        np.testing.assert_array_equal(a, b)

    js = interop.from_numpy(interop.to_numpy(st), jtr.init_state(cfg), jnp.asarray)
    T_new = (np.asarray([0.999, 0.01, -0.02, 0.03], np.float32), np.asarray([0.1, -0.2, 0.05],
                                                                            np.float32))
    jr = jtr.rebase_pose(js, jnp.asarray(1, jnp.int32),
                         jse3.SE3(*map(jnp.asarray, T_new)), jnp.asarray(True))
    tr = ttr.rebase_pose(st, torch.tensor(1, dtype=torch.int32),
                         tse3.SE3(*map(torch.as_tensor, T_new)), torch.tensor(True))
    for k in ("ring_q", "ring_t"):
        np.testing.assert_allclose(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(tr.T_c_w.t.numpy(), np.asarray(jr.T_c_w.t), atol=1e-5, rtol=0)
