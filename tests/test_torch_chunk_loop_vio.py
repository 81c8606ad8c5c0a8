"""The chunked replay's deferred loop node on the VIO path:
flvis_tpu_torch's SlamSystem(use_imu=True, use_loop=True).process_frames_vio
in chunks of 8 plus flush_loop against the JAX package's, on the 24-frame
out-and-back of tests/test_multiseq_loop.py:34-60 with its IMU (the scene,
configuration and draws of tests/test_torch_chunk_loop.py; a file of its
own, so that each file's JAX compile stays within its time budget).

Tolerances as there: keyframe counts and closure pairs exactly; trajectory
(odometry and loop-corrected) and T_map_odom.t within 1e-3."""

import jax
import numpy as np
import pytest
import torch

import flvis_tpu.config as jconfig
import flvis_tpu_torch.config as tconfig
from flvis_tpu.geometry import camera as jcam
from flvis_tpu.io.synthetic import PlanarScene, imu_from_trajectory
from flvis_tpu.pipeline.runner import SlamSystem as JaxSlam
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.pipeline import runner as trunner
from test_torch_chunk_loop import (CAM_ARGS, CHUNK, N, SCFG, _cfg, _jax_draws,
                                   _jax_kernel_sweep, _pairs)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    """The JAX package's and the port's chunked VIO runs with the loop node."""
    sc = PlanarScene(SCFG, plane_depth=8.0, seed=11)
    xs = list(np.linspace(0, 0.9, N // 2)) + list(np.linspace(0.9, 0.02, N - N // 2))
    poses = [(np.eye(3), -np.asarray([x, 0.0, 0.0])) for x in xs]
    frames = [sc.render(R, t) for (R, t) in poses]
    i0, i1 = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    t_imu, gyro, acc, frame_t = imu_from_trajectory(poses, fps=20.0)
    accs, gyros, imuts, prev = [], [], [], -np.inf
    for ft in frame_t:
        m = (t_imu > prev) & (t_imu <= ft)
        accs.append(acc[m]); gyros.append(gyro[m]); imuts.append(t_imu[m])
        prev = ft

    def replay(sys_):
        for c0 in range(0, N, CHUNK):
            sl = slice(c0, c0 + CHUNK)
            sys_.process_frames_vio(i0[sl], i1[sl], ts=frame_t[sl], imu_acc=accs[sl],
                                    imu_gyro=gyros[sl], imu_t=imuts[sl])
        sys_.flush_loop()
        return sys_

    mp = pytest.MonkeyPatch()
    try:
        _jax_kernel_sweep(mp)
        jsys = replay(JaxSlam(_cfg(jconfig), jcam.make(*CAM_ARGS, width=SCFG.width,
                                                       height=SCFG.height),
                              use_imu=True, use_loop=True))
        _jax_draws(mp)
        tsys = replay(trunner.SlamSystem(
            _cfg(tconfig), tcam.make(*CAM_ARGS, width=SCFG.width, height=SCFG.height,
                                     device="cpu"), device="cpu", use_imu=True, use_loop=True))
    finally:
        mp.undo()
        jax.clear_caches()
    return jsys, tsys


def test_vio_chunked_closures_match_reference(runs):
    jsys, tsys = runs
    jl, tl = jsys.loop_closer, tsys.loop_closer
    assert len(tsys.keyframes) == len(jsys.keyframes) == tl.count == jl.count
    assert _pairs(tl) == _pairs(jl) and len(_pairs(tl)) >= 1


def test_vio_chunked_trajectory_matches_reference(runs):
    jsys, tsys = runs
    np.testing.assert_allclose(np.asarray([e[3] for e in tsys.trajectory]),
                               np.asarray([e[3] for e in jsys.trajectory]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(tsys.loop_closer.T_map_odom.t.numpy(),
                               np.asarray(jsys.loop_closer.T_map_odom.t), atol=1e-3, rtol=0)
    np.testing.assert_allclose(tsys.trajectory_cam_centers(loop_corrected=True),
                               jsys.trajectory_cam_centers(loop_corrected=True),
                               atol=1e-3, rtol=0)
