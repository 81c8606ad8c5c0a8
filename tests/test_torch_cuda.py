"""CUDA kernels of the port on the card: each kernel against its plain
PyTorch version at the shapes the main path gives it, the wrappers'
refusals, and the slice launching both kernels.

Needs an NVIDIA GPU; every test skips without one (marker `cuda`).  This
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

GRAD_TOL = 1e-3                                   # nvcc FMA contraction, [0, 255] inputs
SCHUR_TOL = {"t": 2e-4, "q": 2e-5, "lm": 2e-3}    # tests/test_window_ba.py:201-207


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(3, 480, 752), (3, 240, 376), (3, 120, 188),
                                   (2, 61, 87)])
def test_grad_blur_kernel_matches_plain(dev, shape):
    from flvis_tpu_torch.ops.kernels import gradpyr

    x = torch.as_tensor(np.random.default_rng(0).uniform(0, 255, shape),
                        dtype=torch.float32, device=dev)
    before = gradpyr.grad_blur_kernel.launches
    got = gradpyr.grad_blur(x)
    ref = gradpyr.grad_blur_plain(x)
    torch.cuda.synchronize()
    assert gradpyr.grad_blur_kernel.launches == before + 1
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= GRAD_TOL


def test_schur_kernel_matches_plain_and_repeats(dev):
    import chip_smoke
    from flvis_tpu_torch.geometry import se3
    from flvis_tpu_torch.ops.kernels import schur

    cfg, scfg = chip_smoke.system_config()
    cam = chip_smoke.make_camera(scfg, dev)
    st = chip_smoke.bench_window(cfg.backend, cam, dev)
    for lam in (1e-3, 1e-1):
        args = chip_smoke.schur_inputs(cam, st, lam)
        dp, dl = schur.schur_step(*args, 2.0)
        dp2, dl2 = schur.schur_step_kernel(*args, 2.0)
        pdp, pdl = schur.schur_step_plain(*args, 2.0)
        torch.cuda.synchronize()
        assert torch.equal(dp, dp2) and torch.equal(dl, dl2)   # fixed-order sums
        Pk, Pp = se3.retract_left(st.poses(), dp), se3.retract_left(st.poses(), pdp)
        live = st.lm_valid
        assert float((Pk.t - Pp.t).abs().max()) <= SCHUR_TOL["t"]
        assert float((Pk.q - Pp.q).abs().max()) <= SCHUR_TOL["q"]
        assert float((dl.T[live] - pdl.T[live]).abs().max()) <= SCHUR_TOL["lm"]


def test_kernel_wrappers_refuse_bad_input(dev):
    from flvis_tpu_torch.ops.kernels import gradpyr, schur

    with pytest.raises(ValueError, match="float32"):
        gradpyr.grad_blur(torch.zeros((1, 8, 8), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        gradpyr.grad_blur(torch.zeros((1, 8, 16), device=dev)[..., ::2])
    with pytest.raises(ValueError, match="B, H, W"):
        gradpyr.grad_blur(torch.zeros((8, 8), device=dev))
    W, L = 17, 8
    args = [torch.zeros(s, device=dev) for s in
            ((W, 9), (W, 3), (3, L), (3 * W, L), (W, L), (W, L), (W,), (5,), ())]
    with pytest.raises(ValueError, match="window"):
        schur.schur_step(*args, 2.0)


def test_slice_launches_both_kernels(dev):
    """A few frames of SlamSystem on the card at a small config: every frame
    tracks, grad_blur launches once per pyramid level per frame, and the
    keyframe BA runs through schur_step."""
    from flvis_tpu.config import BackendConfig, FrontendConfig, SystemConfig
    from flvis_tpu.io.synthetic import PlanarScene, SceneConfig, orbit_trajectory
    from flvis_tpu_torch.geometry import camera
    from flvis_tpu_torch.ops.kernels import gradpyr, schur
    from flvis_tpu_torch.pipeline.runner import SlamSystem

    scfg = SceneConfig()
    cfg = SystemConfig(
        frontend=FrontendConfig(width=scfg.width, height=scfg.height, num_slots=128,
                                pyramid_levels=3, per_cell=8, min_distance=12.0, margin=22),
        backend=BackendConfig(window_size=5, max_landmarks=256, iters1=8, iters2=4))
    cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline, width=scfg.width,
                      height=scfg.height, device=dev)
    scene = PlanarScene(scfg, plane_depth=8.0, seed=4)
    frames = [scene.render(R, t)[:2] for (R, t) in orbit_trajectory(8, step=0.03)]
    g0, s0 = gradpyr.grad_blur_kernel.launches, schur.schur_step_kernel.launches
    slam = SlamSystem(cfg, cam, device=dev)
    out = slam.process_frames(np.stack([f[0] for f in frames]),
                              np.stack([f[1] for f in frames]))
    assert (out.status == 1).all()
    assert gradpyr.grad_blur_kernel.launches - g0 == 3 * len(frames)
    assert schur.schur_step_kernel.launches > s0
    assert slam.n_valid_corrections >= 1
