"""Port parity: flvis_tpu_torch.backend.window_ba and the schur_step kernel
module against flvis_tpu.backend.window_ba, on the scene of
tests/test_window_ba.py (5 keyframes, 60 landmarks in 128 slots)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.backend import window_ba as jwba
import flvis_tpu.config as jconfig
import flvis_tpu_torch.config as tconfig
from flvis_tpu.geometry import camera as jcam
from flvis_tpu.geometry import se3 as jse3
from flvis_tpu.geometry import so3 as jso3
from flvis_tpu.ops.pallas.schur import schur_step_kernel as pallas_schur
from flvis_tpu_torch import interop
from flvis_tpu_torch.backend import window_ba as twba
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.geometry import se3 as tse3
from flvis_tpu_torch.ops.kernels import schur

torch.set_num_threads(1)
KW = dict(window_size=5, max_landmarks=128, min_views=3, iters1=12, iters2=8)
JCFG, TCFG = jconfig.BackendConfig(**KW), tconfig.BackendConfig(**KW)
CAM_ARGS = (400.0, 400.0, 256.0, 192.0, 0.2)
JCAM = jcam.make(*CAM_ARGS, width=512, height=384)
TCAM = tcam.make(*CAM_ARGS, width=512, height=384, device="cpu")
TO_T = interop.to_torch("cpu")
# Kernel-vs-XLA bounds of tests/test_window_ba.py:201-207, applied to the
# port's plain step: pose translation, quaternion, live landmarks.
STEP_TOL = {"t": 2e-4, "q": 2e-5, "lm": 2e-3}


def _gt_pose(i):
    q = jso3.exp(jnp.asarray([0.0, 0.002 * i, 0.0]))
    return jse3.SE3(q, -jso3.rotate(q, jnp.asarray([0.25 * i, 0.0, 0.0])))


def _packet(i, pts, rng, noise=0.0, pose_noise=0.0, pw_noise=0.0):
    """A JAX KeyframePacket exactly as tests/test_window_ba.py builds it."""
    T = _gt_pose(i)
    uvr = jcam.project_stereo(JCAM, jse3.transform_points(T, jnp.asarray(pts)))
    uv, ur = uvr[:, :2], uvr[:, 2]
    if noise:
        uv = uv + rng.normal(scale=noise, size=uv.shape).astype(np.float32)
        ur = ur + rng.normal(scale=noise, size=ur.shape).astype(np.float32)
    if pose_noise:
        d = jse3.exp(jnp.asarray(rng.normal(scale=pose_noise, size=6).astype(np.float32)))
        T = jse3.compose(d, T)
    pw = jnp.asarray(pts)
    if pw_noise:
        pw = pw + rng.normal(scale=pw_noise, size=pw.shape).astype(np.float32)
    n = len(pts)
    return jwba.KeyframePacket(
        frame_id=jnp.asarray(i, jnp.int32), q=T.q, t=T.t,
        lm_id=jnp.arange(100, 100 + n, dtype=jnp.int32), lm_uv=uv, lm_ur=ur,
        lm_ur_mask=jnp.ones(n, bool), lm_pw=pw, lm_mask=jnp.ones(n, bool))


def _windows(noise=0.5, pose_noise=0.03, pw_noise=0.15, seed=0, n_kf=5):
    """The same window built by both packages' add_keyframe."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-4, -3, 6], [4, 3, 14], size=(60, 3)).astype(np.float32)
    js = jwba.empty(JCFG)
    ts = twba.empty(TCFG, device="cpu")
    pkt_like = twba.KeyframePacket(*([None] * 9))
    for i in range(n_kf):
        p = _packet(i, pts, rng, noise, 0.0 if i == 0 else pose_noise, pw_noise)
        js = jwba.add_keyframe(JCFG, js, p)
        tp = interop.from_numpy(interop.to_numpy(p), pkt_like, TO_T)
        ts = twba.add_keyframe(TCFG, ts, tp)
    return js, ts


def _assert_windows_equal(js, ts):
    jd, td = interop.to_numpy(js), interop.to_numpy(ts)
    for k in jd:
        np.testing.assert_array_equal(np.asarray(td[k]), np.asarray(jd[k]), err_msg=k)


@pytest.mark.parametrize("n_kf", [1, 3, 5, 8])
def test_add_keyframe_bookkeeping(n_kf):
    """Ring insert, id matching, slot allocation and orphan freeing give the
    identical window (pure copies and masks: bit-equal)."""
    js, ts = _windows(n_kf=n_kf)
    _assert_windows_equal(js, ts)


def test_add_keyframe_capacity_and_reset():
    jsmall = jconfig.BackendConfig(window_size=3, max_landmarks=16)
    small = tconfig.BackendConfig(window_size=3, max_landmarks=16)
    rng = np.random.default_rng(1)
    pts = rng.uniform([-4, -3, 6], [4, 3, 14], size=(30, 3)).astype(np.float32)
    p = _packet(0, pts, rng)
    js = jwba.add_keyframe(jsmall, jwba.empty(jsmall), p)
    ts = twba.add_keyframe(small, twba.empty(small, device="cpu"),
                           interop.from_numpy(interop.to_numpy(p),
                                              twba.KeyframePacket(*([None] * 9)), TO_T))
    assert int(ts.lm_valid.sum()) == 16
    _assert_windows_equal(js, ts)
    _assert_windows_equal(jwba.reset(jsmall, js), twba.reset(small, ts))


def _step_inputs(js):
    poses = js.poses()
    w_mask = js.obs_valid & js.kf_valid[:, None] & js.lm_valid[None, :]
    fid = jnp.where(js.kf_valid, js.kf_frame_id, jnp.iinfo(jnp.int32).max)
    fixed = jnp.arange(js.window) == jnp.argmin(fid)
    return poses, w_mask, fixed, js.obs_ur_valid & w_mask


def _step_errors(poses_a, lm_a, poses_b, lm_b, live):
    return {"t": float(np.abs(np.asarray(poses_a.t) - np.asarray(poses_b.t)).max()),
            "q": float(np.abs(np.asarray(poses_a.q) - np.asarray(poses_b.q)).max()),
            "lm": float(np.abs(np.asarray(lm_a)[live] - np.asarray(lm_b)[live]).max())}


@pytest.mark.parametrize("lam", [1e-3, 1e-1])
def test_schur_step_plain_matches_xla_and_pallas(lam):
    """The port's plain Schur step (what the CUDA kernel is held to) against
    the reference's XLA step and its Pallas kernel in interpret mode."""
    js, ts = _windows()
    poses, w_mask, fixed, urv = _step_inputs(js)
    delta = 2.0
    jp, jl = jwba._schur_step(JCAM, poses, js.lm_pw, (js.obs_uv, js.obs_ur, urv),
                              w_mask, fixed, lam, delta)
    W, L = w_mask.shape
    obs3 = jnp.stack([js.obs_uv[..., 0], js.obs_uv[..., 1], js.obs_ur], 1).reshape(3 * W, L)
    cam_row = jnp.stack([JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy, JCAM.fx * JCAM.baseline])
    dp, dl = pallas_schur(jso3.to_matrix(poses.q).reshape(W, 9), poses.t, js.lm_pw.T, obs3,
                          urv.astype(jnp.float32), w_mask.astype(jnp.float32),
                          fixed.astype(jnp.float32), cam_row, jnp.asarray(lam, jnp.float32),
                          delta=delta, interpret=True)
    kp, kl = jse3.retract_left(poses, dp), js.lm_pw + dl.T

    tw_mask = torch.as_tensor(np.array(w_mask))
    tfixed = torch.as_tensor(np.array(fixed))
    turv = torch.as_tensor(np.array(urv))
    consts = twba._schur_consts(TCAM, (ts.obs_uv, ts.obs_ur, turv), tw_mask, tfixed)
    tp, tl = twba._schur_step(ts.poses(), ts.lm_pw, consts, torch.tensor(lam), delta)
    live = np.asarray(js.lm_valid)
    for ref_p, ref_l in ((jp, jl), (kp, kl)):
        errs = _step_errors(ref_p, ref_l, tp, tl.numpy(), live)
        for k, v in errs.items():
            assert v <= STEP_TOL[k], (k, v)


def test_schur_dispatch_cpu_plain():
    """On CPU tensors the dispatcher runs the plain version and launches
    nothing; the kernel wrapper refuses CPU tensors."""
    _, ts = _windows()
    W, L = ts.obs_valid.shape
    args = (torch.eye(3).reshape(1, 9).repeat(W, 1), ts.kf_t, ts.lm_pw.T.contiguous(),
            torch.zeros(3 * W, L), torch.zeros(W, L), ts.obs_valid.float(),
            torch.zeros(W), torch.tensor([400.0, 400.0, 256.0, 192.0, 80.0]),
            torch.tensor(1e-3))
    before = schur.schur_step_kernel.launches
    a = schur.schur_step(*args, 2.0)
    b = schur.schur_step_plain(*args, 2.0)
    assert schur.schur_step_kernel.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="CUDA"):
        schur.schur_step_kernel(*args, 2.0)


@pytest.mark.parametrize("case", ["noisy_init", "outliers", "not_ready"])
def test_optimize_matches_jax(case):
    """Full two-phase optimize: corrected poses agree to 1e-4 m / 1e-5,
    landmarks to 1e-3 m, the cost to 1e-3 relative, and the exported
    Correction's masks and ids exactly.  (Each LM step agrees to float
    rounding; over ≤ 20 steps the accept/reject sequence is the same.)"""
    if case == "noisy_init":
        js, ts = _windows(noise=0.0, pose_noise=0.02, pw_noise=0.1, seed=2)
    elif case == "outliers":
        js, ts = _windows(noise=0.3, pose_noise=0.01, pw_noise=0.05, seed=3)
        uv = np.array(js.obs_uv)
        uv[3, :5] += 60.0
        js = js.__class__(**{**js.__dict__, "obs_uv": jnp.asarray(uv)})
        ts = twba.WindowState(**{**ts.__dict__, "obs_uv": torch.as_tensor(uv)})
    else:
        js, ts = _windows(n_kf=2, seed=4)
    jr = jwba.optimize(JCFG, JCAM, js)
    tr = twba.optimize(TCFG, TCAM, ts)
    jd, td = interop.to_numpy(jr), interop.to_numpy(tr)
    for k in ("kf_frame_id", "kf_valid", "lm_id", "lm_valid", "obs_valid"):
        np.testing.assert_array_equal(td["state"][k], jd["state"][k], err_msg=k)
    for k in ("frame_id", "lm_id", "lm_mask", "outlier_id", "outlier_mask", "valid"):
        np.testing.assert_array_equal(td["correction"][k], jd["correction"][k], err_msg=k)
    np.testing.assert_allclose(td["state"]["kf_t"], jd["state"]["kf_t"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(td["state"]["kf_q"], jd["state"]["kf_q"], atol=1e-5, rtol=0)
    live = jd["state"]["lm_valid"]
    np.testing.assert_allclose(td["state"]["lm_pw"][live], jd["state"]["lm_pw"][live],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(td["cost"], jd["cost"], rtol=1e-3, atol=1e-6)
    assert int(td["num_obs"]) == int(jd["num_obs"])
    if case == "noisy_init":
        for slot in range(5):
            T_est = tse3.SE3(tr.state.kf_q[slot], tr.state.kf_t[slot])
            g = _gt_pose(int(tr.state.kf_frame_id[slot]))
            dt, dr = tse3.distance(T_est, tse3.SE3(torch.as_tensor(np.array(g.q)),
                                                   torch.as_tensor(np.array(g.t))))
            assert float(dt) < 5e-3 and float(dr) < 2e-3


def test_optimize_long_lm_loops_match_jax():
    """iters1 = 120, iters2 = 10 (more LM steps than a captured step could
    hold when each step was a cond of its own): the port's optimize, one
    while_loop a phase, against the reference's optimize on the window of
    test_optimize_matches_jax's noisy_init case, within STEP_TOL."""
    kw = {**KW, "iters1": 120, "iters2": 10}
    jcfg, tcfg = jconfig.BackendConfig(**kw), tconfig.BackendConfig(**kw)
    js, ts = _windows(noise=0.0, pose_noise=0.02, pw_noise=0.1, seed=2)
    jr, tr = jwba.optimize(jcfg, JCAM, js), twba.optimize(tcfg, TCAM, ts)
    live = np.asarray(jr.state.lm_valid)
    np.testing.assert_array_equal(tr.state.lm_valid.numpy(), live)
    assert float(np.abs(tr.state.kf_t.numpy() - np.asarray(jr.state.kf_t)).max()) <= STEP_TOL["t"]
    assert float(np.abs(tr.state.kf_q.numpy() - np.asarray(jr.state.kf_q)).max()) <= STEP_TOL["q"]
    assert float(np.abs(tr.state.lm_pw.numpy()[live]
                        - np.asarray(jr.state.lm_pw)[live]).max()) <= STEP_TOL["lm"]
