"""The fused VIO frame step (flvis_tpu_torch.pipeline.runner
._fused_vio_frame_step) against the reference's one-program VIO chunk
(flvis_tpu.pipeline.runner._chunk_fused_vio) at the entry configuration,
over an out-and-back pan with trajectory-consistent IMU and two blank
frames (FAIL skips the vision → IMU feedback; the re-init resets the
backend).  The reference's draws are handed in; tolerances and helpers are
those of tests/test_torch_fused_step.py, plus the VIO state's of
tests/test_torch_runner.py.  One JAX compile for the file."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flvis_tpu.config as jconfig
import flvis_tpu_torch.config as tconfig
from flvis_tpu.backend import window_ba as jwba
from flvis_tpu.frontend import tracker as jtr
from flvis_tpu.geometry import se3 as jse3
from flvis_tpu.io.synthetic import PlanarScene, imu_from_trajectory
from flvis_tpu.pipeline import runner as jrunner
from flvis_tpu.vio import vimotion as jvim
from flvis_tpu_torch.backend import window_ba as twba
from flvis_tpu_torch.frontend import tracker as ttr
from flvis_tpu_torch.geometry import se3 as tse3
from flvis_tpu_torch.pipeline import runner as trunner
from flvis_tpu_torch.vio import vimotion as tvim
from test_torch_fused_step import (BLANK, N_FRAMES, assert_chunks_match, cameras, configs,
                                   jax_draws, scene_config)

torch.set_num_threads(1)
# The VIO state's tolerances of tests/test_torch_runner.py (_assert_same_run).
VIO_TOL = {"bias_acc": 2e-3, "bias_gyro": 2e-4, "pos": 2e-4, "vel": 2e-3, "q": 2e-4}


def vio_inputs():
    """Images (blank at BLANK) and per-frame IMU packets (pack_imu_frames)
    of an out-and-back pan along x at 20 frames/s."""
    scene = PlanarScene(scene_config(), plane_depth=8.0, seed=11)
    half = N_FRAMES // 2
    xs = list(np.linspace(0, 0.3, half)) + list(np.linspace(0.3, 0.02, N_FRAMES - half))
    poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
    frames = [scene.render(R, t)[:2] for (R, t) in poses]
    imgs0 = np.stack([f[0] for f in frames]).astype(np.float32)
    imgs1 = np.stack([f[1] for f in frames]).astype(np.float32)
    imgs0[list(BLANK)] = 0.0
    imgs1[list(BLANK)] = 0.0
    t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
    accs, gyros, imuts, prev = [], [], [], -np.inf
    for ft in frame_t:
        m = (t_imu > prev) & (t_imu <= ft)
        accs.append(acc[m][-16:]); gyros.append(gyro[m][-16:]); imuts.append(t_imu[m][-16:])
        prev = ft
    imu = trunner.pack_imu_frames(accs, gyros, imuts, 16)
    return imgs0, imgs1, np.asarray(frame_t, np.float32), imu


@pytest.fixture(scope="module")
def vio_runs():
    jf, jb, tf, tb = configs()
    jc, tc = cameras(jf)
    jv, tv = jconfig.VioConfig(), tconfig.VioConfig()
    imgs0, imgs1, ts, imu = vio_inputs()
    _, jba, jvio, _, jys = jrunner._chunk_fused_vio(
        jf, jb, jv, jc, jse3.identity(), jtr.init_state(jf), jwba.empty(jb),
        jvim.init_state(jv), jwba.null_correction(jb), jnp.asarray(imgs0),
        jnp.asarray(imgs1), jnp.asarray(ts), *(jnp.asarray(a) for a in imu))
    draws = jax_draws(jf, np.asarray(jys[0].status))
    null = twba.null_correction(tb, device="cpu")
    step = functools.partial(trunner._fused_vio_frame_step, tf, tb, tv, tc, tse3.identity(),
                             null)
    carry = (ttr.init_state(tf, device="cpu"), twba.empty(tb, device="cpu"),
             tvim.init_state(tv, device="cpu"), null)
    xs = tuple(torch.as_tensor(a) for a in (imgs0, imgs1, ts) + imu)
    (_, tba, tvio, _), packed, _ = trunner.run_chunk_eager(step, carry, xs,
                                                           lambda i: draws[i])
    return jys, jba, jvio, packed, tba, tvio


def test_fused_vio_step_matches_chunk_fused_vio(vio_runs):
    """Statuses (FAIL at the second blank frame, then re-init), keyframes,
    poses, BA costs, the final window and the IMU filter's state."""
    jys, jba, jvio, packed, tba, tvio = vio_runs
    st = packed[:, 2].numpy().astype(int)
    assert st[BLANK[1]] == jtr.STATUS_FAIL and st[BLANK[1] + 1] == jtr.STATUS_TRACKING
    assert_chunks_match(jys, jba, packed, tba)
    assert bool(tvio.initialized)
    for f, tol in VIO_TOL.items():
        np.testing.assert_allclose(getattr(tvio, f).numpy(), np.asarray(getattr(jvio, f)),
                                   atol=tol, rtol=0, err_msg=f)
    np.testing.assert_allclose(float(tvio.last_vis_t), float(jvio.last_vis_t), rtol=0, atol=0)
